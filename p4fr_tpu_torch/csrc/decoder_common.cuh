// One transformer-decoder layer's autoregressive step for TB batch rows,
// shared by csrc/decoder_layer.cu (one layer per launch, batch-major cache)
// and csrc/fused_decode.cu (every layer of the greedy step in one launch,
// time-major cache). Contract: p4fr_tpu/decoding/fast_step.py::
// jnp_layer_step. Per batch row, with hidden H, `heads` heads of D = 32 or
// 64 (a template parameter; EfficientSATRN's decoder has 32, SwinTRN's 64),
// FF F:
//   q,k,v = x @ w_qkv + b_qkv; the current k|v belongs in slot `pos`
//   self-attention of q over cache slots 0..pos (slots > pos banned),
//     scores / sqrt(H); out-proj; LN1(att + x)
//   cross-attention over src K|V (no mask), scores / sqrt(H); out-proj;
//     LN2(att2 + out1)
//   FF: ReLU after BOTH linears; LN3(ff + out2); LayerNorm eps 1e-5
//   slot `pos` := cache_outputs ? out @ w_qkv[:, H:] + b_qkv[H:] : k|v
// The cache is updated IN PLACE at slot `pos` only, after the attention:
// the attention reads slots < pos from the cache and the current k|v from
// shared memory, so no block reads what another writes.
//
// Design: one CTA of 512 threads (16 warps) per TB = 4 batch rows; every
// activation of the step stays in shared memory (f32); a product splits K
// over the warps and gives each lane 8 adjacent output columns for all TB
// rows (16-byte weight loads); attention gives one warp per (row, head) and
// walks the positions in chunks of 32 with an online softmax in f32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TB = 4;         // batch rows per CTA
constexpr int NT = 512;       // threads per CTA
constexpr int NWARP = NT / 32;

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

// 32 contiguous values (16-byte aligned) -> f32 registers
__device__ __forceinline__ void load32(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4 t = q[i];
    v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
  }
}
__device__ __forceinline__ void load32(const __nv_bfloat16* p, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4 t = q[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// 8 contiguous weights (16-byte aligned for bf16, 32 for f32) -> f32
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  float4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// One cache position's value dims that a lane owns in attend (D / 32 of
// them, adjacent), as held between their load and their use: one f32 for
// heads of 32; for heads of 64 one 8-byte f32 pair, or one packed bf16 pair
// (32 bits, so a chunk's 32 positions take 32 registers as at D = 32).
template <typename T, int VPL> struct ValueReg;
template <typename T> struct ValueReg<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = to_f(*p); }
  __device__ __forceinline__ float get(int) const { return v; }
};
template <> struct ValueReg<float, 2> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ float get(int i) const { return i ? v.y : v.x; }
};
template <> struct ValueReg<__nv_bfloat16, 2> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ __forceinline__ float get(int i) const {
    return i ? __high2float(v) : __low2float(v);
  }
};

constexpr int CPT = 8;              // output columns per thread (one vector load)
constexpr int KB = 8;               // weight rows loaded per batch
constexpr int NCHUNK = 32 * CPT;    // columns per pass: a warp spans them
constexpr int RED_FLOATS = NWARP * TB * NCHUNK;

// out[r][n] = act(sum_k in[r][k] * W[k][n] + bias[n]) for r < TB, n < N.
// in: smem [TB][K]; W row stride ldw; out: smem, row stride ldo; red: smem
// scratch of RED_FLOATS. Each warp takes a slice of K, each lane 8
// adjacent columns (one 16-byte load per weight row for bf16), so a warp
// reads whole 512-byte weight rows and every warp keeps loads in flight;
// the warps' partial sums meet in shared memory. N, ldw: multiples of 8.
template <typename T, typename TBias = T>
__device__ void rowmm(const float* in, int K, const T* __restrict__ W, int ldw,
                      const TBias* __restrict__ bias, int N, float* out, int ldo,
                      bool relu, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kper = (K + NWARP - 1) / NWARP;
  const int k0 = warp * kper, k1 = min(K, k0 + kper);
  for (int n0 = 0; n0 < N; n0 += NCHUNK) {
    const int nc = n0 + lane * CPT;
    float acc[TB][CPT];
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
    if (nc < N) {
      const T* wp = W + nc;
      int k = k0;
      // batches of KB weight rows: all KB loads are issued before the first
      // is used, so each warp keeps KB x 512 bytes in flight
      for (; k + KB <= k1; k += KB) {
        float w[KB][CPT];
#pragma unroll
        for (int u = 0; u < KB; ++u) load8(wp + static_cast<long long>(k + u) * ldw, w[u]);
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int r = 0; r < TB; ++r) {
            const float a = in[r * K + k + u];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(a, w[u][j], acc[r][j]);
          }
      }
      for (; k < k1; ++k) {
        float w[CPT];
        load8(wp + static_cast<long long>(k) * ldw, w);
#pragma unroll
        for (int r = 0; r < TB; ++r) {
          const float a = in[r * K + k];
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(a, w[j], acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        red[(warp * TB + r) * NCHUNK + lane * CPT + j] = acc[r][j];
    __syncthreads();
    for (int i = threadIdx.x; i < TB * NCHUNK; i += NT) {
      const int r = i / NCHUNK, c = i % NCHUNK, n = n0 + c;
      if (n < N) {
        float v = to_f(bias[n]);
#pragma unroll
        for (int g = 0; g < NWARP; ++g) v += red[(g * TB + r) * NCHUNK + c];
        out[r * ldo + n] = relu ? fmaxf(v, 0.f) : v;
      }
    }
    __syncthreads();
  }
}

// dst[r] = LN(a[r] + res[r]) * g + b, one warp per row (needs TB <= NWARP)
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

// One warp per (row, head), flash-decode style: the positions held in
// memory go in chunks of 32; in a chunk each lane scores one position (q
// from shared memory, its key row as 16-byte loads: one load32 for heads
// of 32, two for heads of 64), the chunk's max and sum update the running
// f32 softmax statistics, then each lane owns VPL = D / 32 adjacent head
// dims (lane*VPL ..) and accumulates the chunk's values, all 32 value
// loads issued before the first is used (latency, not bandwidth, bounds
// this loop). q at qbuf[r*qld + h*D]; kv holds 2H values per (row b,
// position l), keys at + h*D, values at + H + h*D, at
//   PACKED_SLOTS: (b*row + l)*2H, kv being [B, row, 2H] (a batch-major
//     cache with row = L, or the cross K|V with row = S);
//   otherwise: b*row + l*slot_stride, `row` being the row stride (a
//     time-major [L, B, 2H] cache: row 2H, slot_stride B*2H).
// Kernel 3 (packed) and kernel 6 (strided, for its cross K|V too) each run
// faster with their own form of this arithmetic (PERF.md, Findings). With
// `cur`, position n_pos-1 (= pos) is the current token: its key is at
// cur[r*cur_ld + h*D] and value at cur[r*cur_ld + H + h*D] (shared memory)
// and it is folded in last. Writes the [TB][H] attention output (before the
// out-projection).
template <typename T, bool PACKED_SLOTS, int D>
__device__ void attend(const float* qbuf, int qld, const T* __restrict__ kv,
                       int row, int slot_stride, int b0, int nrows,
                       int n_pos, int H, int heads, float temp,
                       const float* cur, int cur_ld, float* out) {
  static_assert(D == 32 || D == 64, "heads of 32 or 64");
  constexpr int VPL = D / 32;  // value dims per lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_mem = cur != nullptr ? n_pos - 1 : n_pos;
  for (int pair = warp; pair < TB * heads; pair += NWARP) {
    const int r = pair / heads, h = pair % heads;
    if (r >= nrows) continue;
    const float* q = qbuf + r * qld + h * D;
    const T* base = PACKED_SLOTS ? kv + static_cast<long long>(b0 + r) * row * 2 * H
                                 : kv + static_cast<long long>(b0 + r) * row;
    // value dims VPL*lane .. of position 0
    const T* vcol = base + H + h * D + VPL * lane;
    float m = -INFINITY, ssum = 0.f, acc[VPL];  // acc: head dims VPL*lane ..
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
    for (int l0 = 0; l0 < n_mem; l0 += 32) {
      const int l = l0 + lane;
      // positions past the end load the last row (an address that exists)
      // and get probability 0, so no load is predicated or branched around
      float kk[D];
      ValueReg<T, VPL> vbuf[32];
      const long long lc = min(l, n_mem - 1);
#pragma unroll
      for (int c = 0; c < VPL; ++c)
        load32(base + (PACKED_SLOTS ? lc * 2 * H : lc * slot_stride) + h * D + 32 * c,
               kk + 32 * c);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const long long lj = min(l0 + j, n_mem - 1);
        vbuf[j].load(vcol + (PACKED_SLOTS ? lj * 2 * H : lj * slot_stride));
      }
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], kk[d], dot);
      const float sc = l < n_mem ? dot / temp : -INFINITY;
      float cmax = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
      const float mn = fmaxf(m, cmax);
      const float corr = expf(m - mn);  // 0 on the first chunk
      const float p = l < n_mem ? expf(sc - mn) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      ssum = ssum * corr + psum;
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[i] = fmaf(pj, vbuf[j].get(i), acc[i]);
      }
      m = mn;
    }
    if (cur != nullptr) {  // the current token, from shared memory
      const float* cr = cur + r * cur_ld;
      float dot = q[VPL * lane] * cr[h * D + VPL * lane];
#pragma unroll
      for (int i = 1; i < VPL; ++i)
        dot = fmaf(q[VPL * lane + i], cr[h * D + VPL * lane + i], dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float sc = dot / temp;
      const float mn = fmaxf(m, sc);
      const float corr = expf(m - mn);
      const float p = expf(sc - mn);
      ssum = ssum * corr + p;
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        acc[i] = fmaf(p, cr[H + h * D + VPL * lane + i], acc[i] * corr);
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) out[r * H + h * D + VPL * lane + i] = acc[i] / ssum;
  }
}

// One layer's weights, [in, out] matrices; each vector of a LayerNorm's
// scale or bias has H values.
struct Weights {
  const void *w_qkv, *b_qkv, *w_out, *b_out, *ln1_s, *ln1_b, *w_q2, *b_q2,
      *w_out2, *b_out2, *ln2_s, *ln2_b, *w_ff0, *b_ff0, *w_ff1, *b_ff1,
      *ln3_s, *ln3_b;
};

// A CTA's shared memory for layer_body, carved from one dynamic block:
// A [TB][H] the layer's input (x, then out1, out2), Q [TB][3H] q|k|v (later
// the output's k|v), C and Dd [TB][H], Fb [TB][F], R rowmm's partial sums.
struct LayerSmem {
  float *A, *Q, *C, *Dd, *Fb, *R;
};

inline size_t layer_smem_floats(int H, int F) {
  return static_cast<size_t>(TB) * (6 * H + F) + RED_FLOATS;
}

__device__ __forceinline__ LayerSmem carve_layer_smem(float* sm, int H, int F) {
  LayerSmem s;
  s.A = sm;
  s.Q = s.A + TB * H;
  s.C = s.Q + TB * 3 * H;
  s.Dd = s.C + TB * H;
  s.Fb = s.Dd + TB * H;
  s.R = s.Fb + TB * F;
  return s;
}

// One layer's step for the CTA's rows b0..b0+nrows-1, up to its output:
// on entry s.A holds the input rows (f32, synchronised); on return s.Dd
// holds the layer's output in f32 (not yet rounded to T) and s.Q the
// current k|v. The caches are addressed as attend's `kv` (c_row, c_slot and
// s_row are its `row` and `slot_stride`). write_slot then stores slot `pos`.
template <typename T, bool PACKED_SLOTS, int D>
__device__ void layer_body(const LayerSmem& s, const Weights& wt,
                           const T* __restrict__ cache, int c_row, int c_slot,
                           const T* __restrict__ src, int s_row, int b0,
                           int nrows, int H, int heads, int F, int S, int pos) {
  const float temp = sqrtf(static_cast<float>(H));
  float *A = s.A, *Q = s.Q, *C = s.C, *Dd = s.Dd, *Fb = s.Fb, *R = s.R;

  // fused q|k|v of the current token; k|v rounded to the cache type
  rowmm<T>(A, H, static_cast<const T*>(wt.w_qkv), 3 * H,
           static_cast<const T*>(wt.b_qkv), 3 * H, Q, 3 * H, false, R);
  __syncthreads();
  for (int i = threadIdx.x; i < TB * 2 * H; i += NT) {
    int r = i / (2 * H), j = i % (2 * H);
    Q[r * 3 * H + H + j] = round_t<T>(Q[r * 3 * H + H + j]);
  }
  __syncthreads();

  // masked self-attention over slots 0..pos
  attend<T, PACKED_SLOTS, D>(Q, 3 * H, cache, c_row, c_slot, b0, nrows, pos + 1,
                          H, heads, temp, Q + H, 3 * H, C);
  __syncthreads();
  rowmm<T>(C, H, static_cast<const T*>(wt.w_out), H,
           static_cast<const T*>(wt.b_out), H, Dd, H, false, R);
  __syncthreads();
  add_ln<T>(Dd, A, H, static_cast<const T*>(wt.ln1_s),
            static_cast<const T*>(wt.ln1_b), C);
  __syncthreads();
  for (int i = threadIdx.x; i < TB * H; i += NT) A[i] = C[i];  // out1
  __syncthreads();

  // cross-attention over src K|V, no mask
  rowmm<T>(A, H, static_cast<const T*>(wt.w_q2), H,
           static_cast<const T*>(wt.b_q2), H, C, H, false, R);
  __syncthreads();
  attend<T, PACKED_SLOTS, D>(C, H, src, s_row, 2 * H, b0, nrows, S, H, heads,
                          temp, nullptr, 0, Dd);
  __syncthreads();
  rowmm<T>(Dd, H, static_cast<const T*>(wt.w_out2), H,
           static_cast<const T*>(wt.b_out2), H, C, H, false, R);
  __syncthreads();
  add_ln<T>(C, A, H, static_cast<const T*>(wt.ln2_s),
            static_cast<const T*>(wt.ln2_b), Dd);
  __syncthreads();
  for (int i = threadIdx.x; i < TB * H; i += NT) A[i] = Dd[i];  // out2
  __syncthreads();

  // feed-forward, ReLU after both linears
  rowmm<T>(A, H, static_cast<const T*>(wt.w_ff0), F,
           static_cast<const T*>(wt.b_ff0), F, Fb, F, true, R);
  __syncthreads();
  rowmm<T>(Fb, F, static_cast<const T*>(wt.w_ff1), H,
           static_cast<const T*>(wt.b_ff1), H, C, H, true, R);
  __syncthreads();
  add_ln<T>(C, A, H, static_cast<const T*>(wt.ln3_s),
            static_cast<const T*>(wt.ln3_b), Dd);
  __syncthreads();
}

// Slot `pos` of the rows' cache := the current k|v, or with cache_outputs
// (reference parity) the layer OUTPUT's k|v, out @ w_qkv[:, H:] + b_qkv[H:].
template <typename T, bool PACKED_SLOTS>
__device__ void write_slot(const LayerSmem& s, const Weights& wt,
                           T* __restrict__ cache, int c_row, int c_slot,
                           int b0, int nrows, int H, int pos,
                           int cache_outputs) {
  if (cache_outputs) {
    rowmm<T>(s.Dd, H, static_cast<const T*>(wt.w_qkv) + H, 3 * H,
             static_cast<const T*>(wt.b_qkv) + H, 2 * H, s.Q + H, 3 * H, false,
             s.R);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrows * 2 * H; i += NT) {
    int r = i / (2 * H), j = i % (2 * H);
    const long long at = PACKED_SLOTS
        ? (static_cast<long long>(b0 + r) * c_row + pos) * 2 * H + j
        : static_cast<long long>(b0 + r) * c_row + static_cast<long long>(pos) * c_slot + j;
    cache[at] = from_f<T>(s.Q[r * 3 * H + H + j]);
  }
}

}  // namespace
