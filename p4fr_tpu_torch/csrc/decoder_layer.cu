// One transformer-decoder layer's autoregressive step over a packed KV cache.
//
// Replaces p4fr_tpu/ops/pallas/decoder_layer_v2.py::decoder_layer_step_v2
// (kernel body _kernel); contract: p4fr_tpu/decoding/fast_step.py::
// jnp_layer_step. Per batch row, with hidden H, `heads` heads of 32, FF F:
//   q,k,v = x @ w_qkv + b_qkv; the current k|v belongs in slot `pos`
//   self-attention of q over cache slots 0..pos (slots > pos banned),
//     scores / sqrt(H); out-proj; LN1(att + x)
//   cross-attention over src_kv (no mask), scores / sqrt(H); out-proj;
//     LN2(att2 + out1)
//   FF: ReLU after BOTH linears; LN3(ff + out2); LayerNorm eps 1e-5
//   slot `pos` := cache_outputs ? out @ w_qkv[:, H:] + b_qkv[H:] : k|v
// The cache is updated IN PLACE at slot `pos` only, after the attention:
// the attention reads slots < pos from the cache and the current k|v from
// shared memory, so no block reads what another writes.
//
// Bound on the card: each CTA streams the layer's weights (about 1 M
// values) from L2 once for its TB rows and its rows' cache prefix and src
// K/V from device memory; with one CTA per SM, memory LATENCY is what
// limits it, so every loop issues its loads in batches before using them.
// Design: one CTA of 512 threads (16 warps) per TB = 4 batch rows; every
// activation of the step stays in shared memory (f32); a product splits K
// over the warps and gives each lane 8 adjacent output columns for all TB
// rows (16-byte weight loads); attention gives one warp per (row, head) and
// walks the positions in chunks of 32 with an online softmax in f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TB = 4;         // batch rows per CTA
constexpr int NT = 512;       // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int D = 32;         // head dim (one lane per dim when merging)

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
template <typename T>
__device__ void rowmm(const float* in, int K, const T* __restrict__ W, int ldw,
                      const T* __restrict__ bias, int N, float* out, int ldo,
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
// from shared memory, its key row as 16-byte loads), the chunk's max and
// sum update the running f32 softmax statistics, then each lane owns one
// of the 32 head dims and accumulates the chunk's values, all 32 value
// loads issued before the first is used (latency, not bandwidth, bounds
// this loop). q at qbuf[r*qld + h*D]; position l of row b at
// kv[(b*len_stride + l)*2H] (keys at + h*D, values at + H + h*D). With
// `cur`, position n_pos-1 (= pos) is the current token: its key is at
// cur[r*cur_ld + h*D] and value at cur[r*cur_ld + H + h*D] (shared memory)
// and it is folded in last. Writes the [TB][H] attention output (before
// the out-projection).
template <typename T>
__device__ void attend(const float* qbuf, int qld, const T* __restrict__ kv,
                       long long len_stride, int b0, int nrows, int n_pos,
                       int H, int heads, float temp, const float* cur,
                       int cur_ld, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_mem = cur != nullptr ? n_pos - 1 : n_pos;
  for (int pair = warp; pair < TB * heads; pair += NWARP) {
    const int r = pair / heads, h = pair % heads;
    if (r >= nrows) continue;
    const float* q = qbuf + r * qld + h * D;
    const T* base = kv + static_cast<long long>(b0 + r) * len_stride * 2 * H;
    const T* vcol = base + H + h * D + lane;  // value dim `lane` of position 0
    float m = -INFINITY, ssum = 0.f, acc = 0.f;  // acc: head dim `lane`
    for (int l0 = 0; l0 < n_mem; l0 += 32) {
      const int l = l0 + lane;
      // positions past the end load the last row (an address that exists)
      // and get probability 0, so no load is predicated or branched around
      float kk[D], vbuf[32];
      load32(base + static_cast<long long>(min(l, n_mem - 1)) * 2 * H + h * D, kk);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        vbuf[j] = to_f(vcol[static_cast<long long>(min(l0 + j, n_mem - 1)) * 2 * H]);
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
      acc *= corr;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc = fmaf(__shfl_sync(0xffffffffu, p, j), vbuf[j], acc);
      m = mn;
    }
    if (cur != nullptr) {  // the current token, from shared memory
      const float* cr = cur + r * cur_ld;
      float dot = q[lane] * cr[h * D + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float sc = dot / temp;
      const float mn = fmaxf(m, sc);
      const float corr = expf(m - mn);
      const float p = expf(sc - mn);
      ssum = ssum * corr + p;
      acc = fmaf(p, cr[H + h * D + lane], acc * corr);
    }
    out[r * H + h * D + lane] = acc / ssum;
  }
}

struct Weights {
  const void *w_qkv, *b_qkv, *w_out, *b_out, *ln1_s, *ln1_b, *w_q2, *b_q2,
      *w_out2, *b_out2, *ln2_s, *ln2_b, *w_ff0, *b_ff0, *w_ff1, *b_ff1,
      *ln3_s, *ln3_b;
};

template <typename T>
__global__ void __launch_bounds__(NT) decoder_layer_kernel(
    const T* __restrict__ x, T* __restrict__ cache, const T* __restrict__ src,
    T* __restrict__ out, Weights wt, int B, int H, int heads, int F, int S,
    int L, int pos, int cache_outputs) {
  extern __shared__ float sm[];
  float* A = sm;                 // [TB][H]  x, then out1, out2, out
  float* Q = A + TB * H;         // [TB][3H] q|k|v, later the output's k|v
  float* C = Q + TB * 3 * H;     // [TB][H]
  float* Dd = C + TB * H;        // [TB][H]
  float* Fb = Dd + TB * H;       // [TB][F]
  float* R = Fb + TB * F;        // rowmm's partial sums
  const int b0 = blockIdx.x * TB;
  const int nrows = min(TB, B - b0);
  const float temp = sqrtf(static_cast<float>(H));

  for (int i = threadIdx.x; i < TB * H; i += NT) {
    int r = i / H;
    A[i] = r < nrows ? to_f(x[static_cast<long long>(b0) * H + i]) : 0.f;
  }
  __syncthreads();

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
  attend<T>(Q, 3 * H, cache, L, b0, nrows, pos + 1, H, heads, temp, Q + H,
            3 * H, C);
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
  attend<T>(C, H, src, S, b0, nrows, S, H, heads, temp, nullptr, 0, Dd);
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

  for (int i = threadIdx.x; i < nrows * H; i += NT)
    out[static_cast<long long>(b0) * H + i] = from_f<T>(Dd[i]);
  if (cache_outputs) {
    // reference parity: the layer OUTPUT's k|v becomes the slot's k|v
    rowmm<T>(Dd, H, static_cast<const T*>(wt.w_qkv) + H, 3 * H,
             static_cast<const T*>(wt.b_qkv) + H, 2 * H, Q + H, 3 * H, false, R);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrows * 2 * H; i += NT) {
    int r = i / (2 * H), j = i % (2 * H);
    cache[(static_cast<long long>(b0 + r) * L + pos) * 2 * H + j] =
        from_f<T>(Q[r * 3 * H + H + j]);
  }
}

template <typename T>
int launch(const void* x, void* cache, const void* src, void* out,
           const Weights& w, int B, int H, int heads, int F, int S, int L,
           int pos, int cache_outputs, cudaStream_t stream) {
  size_t smem = (static_cast<size_t>(TB) * (6 * H + F) + RED_FLOATS) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decoder_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + TB - 1) / TB);
  decoder_layer_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(cache),
      static_cast<const T*>(src), static_cast<T*>(out), w, B, H, heads, F, S,
      L, pos, cache_outputs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p4fr_decoder_layer(
    const void* x, void* cache, const void* src, void* out,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1_s, const void* ln1_b, const void* w_q2, const void* b_q2,
    const void* w_out2, const void* b_out2, const void* ln2_s,
    const void* ln2_b, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3_s,
    const void* ln3_b, int B, int H, int heads, int F, int S, int L, int pos,
    int cache_outputs, int bf16, void* stream) {
  if (H != heads * D || F % CPT) return static_cast<int>(cudaErrorInvalidValue);
  Weights w{w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w_q2, b_q2, w_out2,
            b_out2, ln2_s, ln2_b, w_ff0, b_ff0, w_ff1, b_ff1, ln3_s, ln3_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, cache, src, out, w, B, H, heads, F, S, L,
                                 pos, cache_outputs, s);
  return launch<float>(x, cache, src, out, w, B, H, heads, F, S, L, pos,
                       cache_outputs, s);
}
