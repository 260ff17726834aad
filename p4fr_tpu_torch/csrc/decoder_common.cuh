// What every decoder-layer kernel of the port shares: the layer's contract,
// its operand forms, and the helpers that decoder_cluster.cuh's cluster
// body is built on (type conversions, the attention's value registers, the
// products' column and row constants, the LayerNorm, the layers' weight
// tables). That body runs the layer step of kernel 3
// (csrc/decoder_layer.cu), kernel 6 (csrc/fused_decode.cu: the whole
// greedy step, time-major caches), kernel 7 (csrc/decoder_stack.cu: every
// layer in one launch, batch-major stacked caches) and kernel 8
// (csrc/decoder_layer_v1.cu: the whole-prefix softmax). Contract:
// p4fr_tpu/decoding/fast_step.py::jnp_layer_step. Per batch row, with
// hidden H, `heads` heads of D = 32 or 64 (a template parameter;
// EfficientSATRN's decoder has 32, SwinTRN's 64), FF F:
//   q,k,v = x @ w_qkv + b_qkv; the current k|v belongs in slot `pos`
//   self-attention of q over cache slots 0..pos (slots > pos banned),
//     scores / sqrt(H); out-proj; LN1(att + x)
//   cross-attention over src K|V (no mask), scores / sqrt(H); out-proj;
//     LN2(att2 + out1)
//   FF: ReLU after BOTH linears; LN3(ff + out2); LayerNorm eps 1e-5
//   slot `pos` := cache_outputs ? out @ w_qkv[:, H:] + b_qkv[H:] : k|v
// Kernel 3 also takes the TPU kernel's int8 operands (kv_quant, KvQ below;
// kernels 6-8 take none):
//   kSrc: the cross K|V as int8 codes [B, S, 2H] with f32 scales
//     src_scale [B, 2, S] (k-scale, v-scale per row and source token);
//   kSrcCache: that, and the self cache as int8 codes [B, L, 2H] with f32
//     scales [B, L, 2] (k-scale, v-scale per row and slot; flat, not the
//     TPU's tiled [G, L, TB, 2H]).
// A score is dot(q, k8) / sqrt(H) * k-scale, the running max and mass take
// it as it is, and the values accumulate p * v-scale * v8 (the v-scale
// folds in after the mass), so no dequantized K|V is formed. The current
// token's k|v is folded in from shared memory, unquantized; slot `pos` is
// then quantized per (row, half): scale = max(max|x|, 1e-8) / 127, codes
// clip(rint(x / scale), -127, 127).
// The cache is updated IN PLACE at slot `pos` only. In the online form
// (kernels 3, 6, 7) that happens after the attention, which reads slots
// < pos from the cache and the current k|v from shared memory; in the
// two-pass form (kernel 8) the current k|v goes into slot `pos` first and
// the attention reads slots 0..pos back from the cache. A cluster reads
// and writes only its own rows, so no cluster reads what another writes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int TB = 4;  // batch rows a group (the rows a cluster shares)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// One cache position's value dims that a lane owns in the attention
// (D / 32 of them, adjacent), as held between their load and their use:
// one f32 for heads of 32; for heads of 64 one 8-byte f32 pair, or one
// packed bf16 pair (32 bits, so a chunk's 32 positions take 32 registers
// as at D = 32).
template <typename T, int VPL> struct ValueReg;
template <typename T> struct ValueReg<T, 1> {
  float v;
  __device__ __forceinline__ float get(int) const { return v; }
};
template <> struct ValueReg<float, 2> {
  float2 v;
  __device__ __forceinline__ float get(int i) const { return i ? v.y : v.x; }
};
template <> struct ValueReg<__nv_bfloat16, 2> {
  __nv_bfloat162 v;
  __device__ __forceinline__ float get(int i) const {
    return i ? __high2float(v) : __low2float(v);
  }
};
// int8 codes stay codes until their use (one or two a lane)
template <> struct ValueReg<int8_t, 1> {
  int8_t v;
  __device__ __forceinline__ float get(int) const { return v; }
};
template <> struct ValueReg<int8_t, 2> {
  char2 v;
  __device__ __forceinline__ float get(int i) const { return i ? v.y : v.x; }
};

// The operand forms of kernel 3 (header): which of the cross K|V and the
// self cache are int8 codes with f32 scales.
enum class KvQ { kNone, kSrc, kSrcCache };
template <typename T, KvQ KQ>
using CacheT = std::conditional_t<KQ == KvQ::kSrcCache, int8_t, T>;
template <typename T, KvQ KQ>
using SrcT = std::conditional_t<KQ == KvQ::kNone, T, int8_t>;

// The f32 scales of an int8 K|V: the k-scale of (row b, position l) at
// p[b * row + l * pos] and its v-scale `v` floats further on (src_scale
// [B, 2, S]: row 2S, pos 1, v S; the cache's [B, L, 2]: row 2L, pos 2, v 1).
struct KvScales {
  const float* p;
  int row, pos, v;
};

constexpr int CPT = 8;              // output columns per thread (one vector load)
constexpr int KB = 8;               // weight rows loaded per batch
constexpr int NCHUNK = 32 * CPT;    // columns per pass: a warp spans them

// dst[r] = LN(a[r] + res[r]) * g + b, one warp per row (needs TB <= warps a CTA)
template <typename T>
__device__ void add_ln(const float* a, const float* res, int H,
                       const T* __restrict__ g, const T* __restrict__ bta,
                       float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < TB) {
    const float* ar = a + warp * H;
    const float* rr = res + warp * H;
    float s = 0.f;
    for (int i = lane; i < H; i += 32) s += ar[i] + rr[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / H;
    float v = 0.f;
    for (int i = lane; i < H; i += 32) {
      float d = ar[i] + rr[i] - mean;
      v += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / H + 1e-5f);
    __syncwarp();
    for (int i = lane; i < H; i += 32)
      dst[warp * H + i] = (ar[i] + rr[i] - mean) * inv * to_f(g[i]) + to_f(bta[i]);
  }
}

// One layer's weights, [in, out] matrices; each vector of a LayerNorm's
// scale or bias has H values.
struct Weights {
  const void *w_qkv, *b_qkv, *w_out, *b_out, *ln1_s, *ln1_b, *w_q2, *b_q2,
      *w_out2, *b_out2, *ln2_s, *ln2_b, *w_ff0, *b_ff0, *w_ff1, *b_ff1,
      *ln3_s, *ln3_b;
};

// Every layer's weights stacked [NL, ...], in the order of
// p4fr_tpu_torch/ops/decoder_stack_v3.py::stack_fast_layers: biases
// [NL, 1, D], LayerNorms [NL, 2, H] (scale; bias).
struct StackedWeights {
  const void *w_qkv, *b_qkv, *w_out, *b_out, *ln1, *w_q2, *b_q2, *w_out2,
      *b_out2, *ln2, *w_ff0, *b_ff0, *w_ff1, *b_ff1, *ln3;
};

// layer l's weights inside the stacked tensors
template <typename T>
__host__ __device__ Weights layer_weights(const StackedWeights& p, int l, int H, int F) {
  auto at = [](const void* base, long long off) -> const void* {
    return static_cast<const T*>(base) + off;
  };
  const long long hh = static_cast<long long>(H) * H, l2 = 2LL * l * H;
  return Weights{
      at(p.w_qkv, l * 3 * hh), at(p.b_qkv, 3LL * l * H),
      at(p.w_out, l * hh), at(p.b_out, static_cast<long long>(l) * H),
      at(p.ln1, l2), at(p.ln1, l2 + H),
      at(p.w_q2, l * hh), at(p.b_q2, static_cast<long long>(l) * H),
      at(p.w_out2, l * hh), at(p.b_out2, static_cast<long long>(l) * H),
      at(p.ln2, l2), at(p.ln2, l2 + H),
      at(p.w_ff0, static_cast<long long>(l) * H * F),
      at(p.b_ff0, static_cast<long long>(l) * F),
      at(p.w_ff1, static_cast<long long>(l) * F * H),
      at(p.b_ff1, static_cast<long long>(l) * H),
      at(p.ln3, l2), at(p.ln3, l2 + H)};
}

}  // namespace
