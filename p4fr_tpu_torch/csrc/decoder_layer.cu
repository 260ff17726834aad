// One transformer-decoder layer's autoregressive step over a packed KV cache.
//
// Replaces p4fr_tpu/ops/pallas/decoder_layer_v2.py::decoder_layer_step_v2
// (kernel body _kernel); contract and design: decoder_common.cuh, whose
// layer_body and write_slot this kernel runs once over a batch-major
// [B, L, 2H] cache, instanced for heads of 32 and of 64. The TPU kernel's
// int8 operand forms (src_scale; the int8 cache) are instanced too: one
// entry point each, p4fr_decoder_layer_int8 (int8 cross K|V) and
// p4fr_decoder_layer_int8_cache (and the int8 self cache), the same body
// with other operand loads (decoder_common.cuh's KvQ).
//
// Bound on the card: each CTA streams the layer's weights (about 1 M
// values) from L2 once for its TB rows and its rows' cache prefix and src
// K/V from device memory; with one CTA per SM, memory LATENCY is what
// limits it, so every loop issues its loads in batches before using them.
// The int8 forms move fewer bytes and keep the same loads in flight.
#include <type_traits>

#include "decoder_common.cuh"

namespace {

template <typename T, int D, KvQ KQ>
__global__ void __launch_bounds__(NT) decoder_layer_kernel(
    const T* __restrict__ x, CacheT<T, KQ>* __restrict__ cache,
    float* __restrict__ cache_scale, const SrcT<T, KQ>* __restrict__ src,
    const float* __restrict__ src_scale, T* __restrict__ out, Weights wt, int B,
    int H, int heads, int F, int S, int L, int pos, int cache_outputs) {
  extern __shared__ float sm[];
  const LayerSmem s = carve_layer_smem(sm, H, F);
  const int b0 = blockIdx.x * TB;
  const int nrows = min(TB, B - b0);

  for (int i = threadIdx.x; i < TB * H; i += NT) {
    int r = i / H;
    s.A[i] = r < nrows ? to_f(x[static_cast<long long>(b0) * H + i]) : 0.f;
  }
  __syncthreads();
  layer_body<T, true, D, false, KQ>(s, wt, cache, L, 2 * H, src, S, b0, nrows, H,
                                    heads, F, S, pos, src_scale, cache_scale);
  for (int i = threadIdx.x; i < nrows * H; i += NT)
    out[static_cast<long long>(b0) * H + i] = from_f<T>(s.Dd[i]);
  if constexpr (KQ == KvQ::kSrcCache)
    write_slot_int8<T>(s, wt, cache, cache_scale, L, b0, nrows, H, pos, cache_outputs);
  else
    write_slot<T, true>(s, wt, cache, L, 2 * H, b0, nrows, H, pos, cache_outputs);
}

template <typename T, int D, KvQ KQ>
int launch(const void* x, void* cache, void* cache_scale, const void* src,
           const void* src_scale, void* out, const Weights& w, int B, int H,
           int heads, int F, int S, int L, int pos, int cache_outputs,
           cudaStream_t stream) {
  size_t smem = layer_smem_floats(H, F) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decoder_layer_kernel<T, D, KQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + TB - 1) / TB);
  decoder_layer_kernel<T, D, KQ><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<CacheT<T, KQ>*>(cache),
      static_cast<float*>(cache_scale), static_cast<const SrcT<T, KQ>*>(src),
      static_cast<const float*>(src_scale), static_cast<T*>(out), w, B, H, heads,
      F, S, L, pos, cache_outputs);
  return static_cast<int>(cudaGetLastError());
}

// the instance by operand form, type and head width: 32 (EfficientSATRN),
// 64 (SwinTRN)
template <KvQ KQ>
int dispatch(const void* x, void* cache, void* cache_scale, const void* src,
             const void* src_scale, void* out, const Weights& w, int B, int H,
             int heads, int F, int S, int L, int pos, int cache_outputs, int bf16,
             void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || (d != 32 && d != 64) || F % CPT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto head) {
    constexpr int D = decltype(head)::value;
    if (bf16)
      return launch<__nv_bfloat16, D, KQ>(x, cache, cache_scale, src, src_scale, out,
                                          w, B, H, heads, F, S, L, pos,
                                          cache_outputs, s);
    return launch<float, D, KQ>(x, cache, cache_scale, src, src_scale, out, w, B, H,
                                heads, F, S, L, pos, cache_outputs, s);
  };
  return d == 32 ? run(std::integral_constant<int, 32>{})
                 : run(std::integral_constant<int, 64>{});
}

}  // namespace

#define P4FR_LAYER_WEIGHTS                                                     \
  const void *w_qkv, const void *b_qkv, const void *w_out, const void *b_out, \
      const void *ln1_s, const void *ln1_b, const void *w_q2,                  \
      const void *b_q2, const void *w_out2, const void *b_out2,                \
      const void *ln2_s, const void *ln2_b, const void *w_ff0,                 \
      const void *b_ff0, const void *w_ff1, const void *b_ff1,                 \
      const void *ln3_s, const void *ln3_b
#define P4FR_WEIGHTS_STRUCT                                                     \
  Weights{w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w_q2, b_q2, w_out2,       \
          b_out2, ln2_s, ln2_b, w_ff0, b_ff0, w_ff1, b_ff1, ln3_s, ln3_b}

// x, cache and src in the weights' type (f32, or bf16 with bf16 != 0)
extern "C" int p4fr_decoder_layer(
    const void* x, void* cache, const void* src, void* out, P4FR_LAYER_WEIGHTS,
    int B, int H, int heads, int F, int S, int L, int pos, int cache_outputs,
    int bf16, void* stream) {
  return dispatch<KvQ::kNone>(x, cache, nullptr, src, nullptr, out,
                              P4FR_WEIGHTS_STRUCT, B, H, heads, F, S, L, pos,
                              cache_outputs, bf16, stream);
}

// src int8 [B, S, 2H] with f32 src_scale [B, 2, S]; the cache in the
// weights' type
extern "C" int p4fr_decoder_layer_int8(
    const void* x, void* cache, const void* src, const void* src_scale,
    void* out, P4FR_LAYER_WEIGHTS, int B, int H, int heads, int F, int S,
    int L, int pos, int cache_outputs, int bf16, void* stream) {
  return dispatch<KvQ::kSrc>(x, cache, nullptr, src, src_scale, out,
                             P4FR_WEIGHTS_STRUCT, B, H, heads, F, S, L, pos,
                             cache_outputs, bf16, stream);
}

// src as above, and the cache int8 [B, L, 2H] with f32 cache_scale [B, L, 2]
extern "C" int p4fr_decoder_layer_int8_cache(
    const void* x, void* cache, void* cache_scale, const void* src,
    const void* src_scale, void* out, P4FR_LAYER_WEIGHTS, int B, int H,
    int heads, int F, int S, int L, int pos, int cache_outputs, int bf16,
    void* stream) {
  return dispatch<KvQ::kSrcCache>(x, cache, cache_scale, src, src_scale, out,
                                  P4FR_WEIGHTS_STRUCT, B, H, heads, F, S, L, pos,
                                  cache_outputs, bf16, stream);
}
