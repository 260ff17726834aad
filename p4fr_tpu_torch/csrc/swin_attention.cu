// Windowed multi-head attention of the Swin encoder: one (window, head) per
// CTA.
//
// Replaces p4fr_tpu/ops/pallas/swin_attention.py::fused_window_attention
// (:109, kernel body _kernel). For window w of N and head h, with
// q_h, k_h, v_h the lanes h*d .. (h+1)*d of the three thirds of the raw
// projection output qkv [N, n, 3C] (C = heads * d, d = 32):
//   out[w, :, h*d:(h+1)*d] = softmax(scale * q_h k_h^T + bias[h]
//                                     [+ mask[w % nW]]) v_h
// bias [heads, n, n] f32, mask [nW, n, n] f32 or none. The scale multiplies
// the f32 scores before the bias is added. Scores and softmax in f32, every
// product accumulated in f32; with bf16 operands the probabilities are
// rounded to bf16 before the value product and each head's output once at
// the end (the TPU kernel's two .astype(cdtype), :96 and :101).
//
// Bound on the card: device-memory bytes for the work itself (qkv read
// once, the output written once: ~0.3 GB per stage-0 launch at B=32; bias
// and mask are read by every window but stay in L2). This first form does
// its products in f32 on the CUDA cores, so in practice the issue rate of
// FMAs, shared-memory reads and shuffles bounds it, several times above
// the bytes. The TPU kernel transposed k outside, for the MXU; here k is
// read in place from qkv. Design: the CTA stages its head's q, k and v in
// shared memory in f32 (k rows padded to 33 floats, so the lanes of a warp,
// each reading another key row, hit 32 different banks); one warp per
// query row: each lane scores key positions lane, lane+32, ... (n <= 160,
// five chunks), the row's max and sum come from warp shuffles, and the
// probabilities stay in registers: the 144 x 144 score tile never exists
// in memory. Then each lane owns one of the 32 head dims and accumulates
// the value product, the probabilities broadcast by shuffles. Tensor-core
// products for bf16 (mma.sync, every dimension a multiple of 16) are later
// work; f32 needs full f32 products, which TF32 tensor cores do not give.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int HD = 32;               // head dim (every Swin-B stage)
constexpr int NTH = 256;             // threads per CTA
constexpr int NWARPS = NTH / 32;
constexpr int MAXC = 5;              // 32-position chunks a row: n <= 160
constexpr int KLD = HD + 1;          // padded k row, floats

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

inline size_t smem_floats(int n) {
  const int rows = (n + 31) / 32 * 32;
  return static_cast<size_t>(n) * (HD + KLD) + static_cast<size_t>(rows) * HD;
}

template <typename T>
__global__ void __launch_bounds__(NTH) window_attention_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ out, int n, int C,
    int heads, int nW, float scale) {
  extern __shared__ float sm[];
  const int nc = (n + 31) / 32;
  float* qs = sm;               // [n][HD]
  float* ks = qs + n * HD;      // [n][KLD]
  float* vs = ks + n * KLD;     // [nc*32][HD], rows >= n zero
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // consecutive CTAs are the heads of one window: its qkv rows meet in L2
  const int w = blockIdx.x / heads, h = blockIdx.x % heads;
  const long long row0 = static_cast<long long>(w) * n;
  const T* src = qkv + row0 * 3 * C + h * HD + lane;

  // one warp per token: its q, k and v head slices, 32 contiguous values each
  for (int t = warp; t < nc * 32; t += NWARPS) {
    if (t < n) {
      const T* p = src + static_cast<long long>(t) * 3 * C;
      qs[t * HD + lane] = to_f(p[0]);
      ks[t * KLD + lane] = to_f(p[C]);
      vs[t * HD + lane] = to_f(p[2 * C]);
    } else {
      vs[t * HD + lane] = 0.f;
    }
  }
  __syncthreads();

  const float* bh = bias + static_cast<long long>(h) * n * n;
  const float* mw = mask != nullptr ? mask + static_cast<long long>(w % nW) * n * n
                                    : nullptr;
  for (int i = warp; i < n; i += NWARPS) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = qs[i * HD + d];  // a broadcast read
    const float* brow = bh + static_cast<long long>(i) * n;
    const float* mrow = mw != nullptr ? mw + static_cast<long long>(i) * n : nullptr;

    // scores: lane holds positions c*32 + lane
    float s[MAXC];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int j = c * 32 + lane;
      s[c] = -INFINITY;
      if (c < nc && j < n) {
        const float* kr = ks + j * KLD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kr[d], dot);
        float sc = __fmul_rn(dot, scale) + brow[j];  // scale, then the bias
        if (mrow != nullptr) sc += mrow[j];
        s[c] = sc;
        mx = fmaxf(mx, sc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const float e = c < nc && c * 32 + lane < n ? expf(s[c] - mx) : 0.f;
      s[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) s[c] = round_t<T>(s[c] / sum);

    // value product: lane owns head dim `lane`
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
        const float* vr = vs + c * 32 * HD + lane;
#pragma unroll
        for (int jj = 0; jj < 32; ++jj)
          acc = fmaf(__shfl_sync(0xffffffffu, s[c], jj), vr[jj * HD], acc);
      }
    }
    out[(row0 + i) * C + h * HD + lane] = from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* qkv, const void* bias, const void* mask, void* out,
           int N, int n, int C, int heads, int nW, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(n) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  window_attention_kernel<T><<<N * heads, NTH, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), n, C, heads, nW,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [N, n, 3C], bias [heads, n, n] f32, mask [nW, n, n] f32 or null ->
// out [N, n, C]; C = heads * 32, n <= 160.
extern "C" int p4fr_window_attention(const void* qkv, const void* bias,
                                     const void* mask, void* out, int N, int n,
                                     int C, int heads, int nW, float scale,
                                     int bf16, void* stream) {
  if (N <= 0 || heads <= 0 || C != heads * HD || n <= 0 || n > MAXC * 32 ||
      (mask != nullptr && nW <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(qkv, bias, mask, out, N, n, C, heads, nW,
                                 scale, s);
  return launch<float>(qkv, bias, mask, out, N, n, C, heads, nW, scale, s);
}
