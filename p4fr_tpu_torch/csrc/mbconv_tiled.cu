// Stride-1 MBConv(+SE) block at inference, BatchNorms folded to per-channel
// (scale, bias) on each product's output side:
//   h1 = SiLU(x @ pw_w * pw_s + pw_b)                 1x1 expand
//   h2 = SiLU(dw3x3(h1) * dw_s + dw_b)               depthwise, zero pad 1
//   g  = sigmoid(SiLU(mean(h2) @ se_rw + se_rb) @ se_ew + se_eb)   SE gate
//   out = (h2 * g) @ pwl_w * pwl_s + pwl_b (+ x)      1x1 project (+ residual)
//
// The three-launch form of kernel 2 (p4fr_tpu/ops/pallas/mbconv.py::
// fused_mbconv_chain), for the shapes whose expanded map a cluster of 16
// CTAs cannot hold in shared memory (EfficientASTER's 16x64x960 stage 4,
// say) or whose channels are not multiples of 8; mbconv.cu's two launches
// take every other shape (ops/mbconv.py::mbconv_plan decides from the shape
// alone). Here the map goes through device memory once, as f32:
//   (a) expand_dw: per (image, 8x16 spatial tile, group of mid channels),
//       the 1x1 expand is recomputed on the 10x18 halo in shared memory,
//       followed by the depthwise conv; writes h2 (f32) and per-tile
//       channel sums (deterministic, no atomics).
//   (b) se: per image, sums the tile partials into the mean and runs the two
//       small FCs into a [B, Cmid] f32 gate.
//   (c) project: a tiled product over pixels x out channels; the gate is
//       applied and the operand rounded to the activation type as it is
//       loaded; BN fold, f32 residual and ONE cast in the epilogue.
// Bound on the card: the two 1x1 products and the instructions that feed
// them. In bf16 the products run on the tensor cores (WMMA 16x16x16 tiles,
// f32 accumulation; the expand computes 1.5x its useful rows for the halo)
// and their operands arrive as 16-byte vectors, fetched into registers one
// K chunk ahead (so Cin, Cmid and Cout must be multiples of 8). In f32 they
// run on CUDA cores with scalar loads, so that the f32 check against the
// plain twin is exact to summation order.
// Numerics follow the TPU kernel's contract: f32 accumulation, exact SiLU,
// the pooled mean and SE hidden rounded to the activation type before
// their products, h2 * g rounded before the projection, one final cast.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TH = 8, TW = 16;        // output tile (pixels)
constexpr int HH = TH + 2;            // halo rows: 10
constexpr int HWD = TW + 2;           // halo cols: 18
constexpr int HPX = HH * HWD;         // 180 halo pixels
constexpr int HPX_PAD = 192;          // padded to 12 WMMA row tiles
constexpr int NT = 256;               // threads per block (8 warps)
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// round an f32 value through the activation type T
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

struct Tile {
  int b, tile, ty0, tx0, c0;
};

// this block's image, spatial tile and first mid channel, for CTN mid
// channels per block: grid (tiles, ceil(Cmid / CTN), B)
template <int CTN>
__device__ __forceinline__ Tile tile_of(int W) {
  const int tiles_w = (W + TW - 1) / TW;
  return {static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x),
          static_cast<int>(blockIdx.x) / tiles_w * TH,
          static_cast<int>(blockIdx.x) % tiles_w * TW,
          static_cast<int>(blockIdx.y) * CTN};
}

// Second half of (a), shared by both products: `es` [HPX_PAD][CTN + 4]
// holds the raw expand products of the halo tile; BN + SiLU (zero outside
// the image: the depthwise conv zero-pads its input), depthwise + BN +
// SiLU, h2 and the tile's channel sums out. Thread i owns mid channel
// i % CTN and every (NT / CTN)-th pixel from i / CTN; `red` [NT / CTN][CTN].
template <int CTN>
__device__ void expand_tail(float* es, float* red, const Tile t,
                            const float* __restrict__ pw_s,
                            const float* __restrict__ pw_b,
                            const float* __restrict__ dw_w,
                            const float* __restrict__ dw_s,
                            const float* __restrict__ dw_b,
                            float* __restrict__ h2, float* __restrict__ partial,
                            int H, int W, int Cmid) {
  constexpr int LD = CTN + 4, NG = NT / CTN;
  const int c = threadIdx.x % CTN, g = threadIdx.x / CTN;
  const int cg = t.c0 + c;
  const bool cvalid = cg < Cmid;
  const float s1 = cvalid ? pw_s[cg] : 0.f, b1 = cvalid ? pw_b[cg] : 0.f;
  for (int p = g; p < HPX; p += NG) {
    const int gy = t.ty0 - 1 + p / HWD, gx = t.tx0 - 1 + p % HWD;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    es[p * LD + c] = inside && cvalid ? silu(fmaf(es[p * LD + c], s1, b1)) : 0.f;
  }
  __syncthreads();

  float wdw[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wdw[k] = cvalid ? dw_w[k * Cmid + cg] : 0.f;
  const float s2 = cvalid ? dw_s[cg] : 0.f, b2 = cvalid ? dw_b[cg] : 0.f;
  float sum = 0.f;
#pragma unroll 4
  for (int j = 0; j < TH * TW / NG; ++j) {
    const int q = g + NG * j;
    const int oy = q / TW, ox = q % TW;
    const int gy = t.ty0 + oy, gx = t.tx0 + ox;
    if (gy < H && gx < W) {
      float a = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          a = fmaf(es[((oy + dy) * HWD + ox + dx) * LD + c], wdw[dy * 3 + dx], a);
      const float v = silu(fmaf(a, s2, b2));
      if (cvalid)
        h2[((static_cast<long long>(t.b) * H + gy) * W + gx) * Cmid + cg] = v;
      sum += v;
    }
  }
  red[g * CTN + c] = sum;
  __syncthreads();
  if (g == 0 && cvalid) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) s += red[k * CTN + c];
    partial[(static_cast<long long>(t.b) * gridDim.x + t.tile) * Cmid + cg] = s;
  }
}

// (a), f32: CUDA-core products, 32 mid channels per block (one per lane).
// grid (tiles, ceil(Cmid / CT32), B), 256 threads
constexpr int CT32 = 32;
constexpr int LDE32 = CT32 + 4;
constexpr int KC = 16;                                   // input-channel chunk
constexpr int PX_PER_WARP = (HPX + NWARP - 1) / NWARP;   // 23

__global__ void __launch_bounds__(NT) expand_dw_f32(
    const float* __restrict__ x, const float* __restrict__ pw_w,
    const float* __restrict__ pw_s, const float* __restrict__ pw_b,
    const float* __restrict__ dw_w, const float* __restrict__ dw_s,
    const float* __restrict__ dw_b, float* __restrict__ h2,
    float* __restrict__ partial, int H, int W, int Cin, int Cmid) {
  __shared__ float xs[HPX][KC];
  __shared__ float ws[KC][CT32];
  __shared__ float es[HPX_PAD][LDE32];
  __shared__ float red[NWARP][CT32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile t = tile_of<CT32>(W);
  const float* xb = x + static_cast<long long>(t.b) * H * W * Cin;

  float acc[PX_PER_WARP];
#pragma unroll
  for (int i = 0; i < PX_PER_WARP; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < Cin; k0 += KC) {
    for (int idx = tid; idx < HPX * KC; idx += NT) {
      const int p = idx / KC, k = idx % KC;
      const int gy = t.ty0 - 1 + p / HWD, gx = t.tx0 - 1 + p % HWD;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && k0 + k < Cin)
        v = xb[(static_cast<long long>(gy) * W + gx) * Cin + k0 + k];
      xs[p][k] = v;
    }
    for (int idx = tid; idx < KC * CT32; idx += NT) {
      const int k = idx / CT32, c = idx % CT32;
      ws[k][c] = (k0 + k < Cin && t.c0 + c < Cmid)
                     ? pw_w[static_cast<long long>(k0 + k) * Cmid + t.c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float w = ws[k][lane];
#pragma unroll
      for (int i = 0; i < PX_PER_WARP; ++i) {
        const int p = warp + NWARP * i;
        if (p < HPX) acc[i] = fmaf(xs[p][k], w, acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PX_PER_WARP; ++i) {
    const int p = warp + NWARP * i;
    if (p < HPX) es[p][lane] = acc[i];
  }
  __syncthreads();
  expand_tail<CT32>(&es[0][0], &red[0][0], t, pw_s, pw_b, dw_w, dw_s, dw_b,
                    h2, partial, H, W, Cmid);
}

// (a), bf16: tensor-core products, 64 mid channels per block: the padded
// 192-row halo tile is 12 x 4 WMMA tiles, six per warp (one column tile
// each). Per K chunk of 32 input channels every thread moves three 16-byte
// vectors of x and one of the weights; its halo rows are fixed, so their
// addresses are worked out once, and the next chunk's vectors are in
// flight while the current chunk's products run. grid (tiles,
// ceil(Cmid / CT64), B), 256 threads, EXP_SMEM bytes of dynamic shared
// memory (the operands, then the f32 halo map, share one buffer).
constexpr int CT64 = 64;
constexpr int WK = 32;                     // input-channel chunk
constexpr int LDX = WK + 8;                // bf16 row strides (multiples of 8)
constexpr int LDW = CT64 + 8;
constexpr int LDE64 = CT64 + 4;
constexpr int XV = HPX_PAD * WK / 8 / NT;  // x vectors per thread per chunk: 3
constexpr int XS_BYTES = HPX_PAD * LDX * 2;
constexpr int WS_BYTES = WK * LDW * 2;
constexpr int ES_BYTES = HPX_PAD * LDE64 * 4;
constexpr int EXP_BUF = ES_BYTES > XS_BYTES + WS_BYTES ? ES_BYTES : XS_BYTES + WS_BYTES;
constexpr int EXP_SMEM = EXP_BUF + NT * 4;  // + the tail's channel sums
static_assert(HPX_PAD * WK / 8 == XV * NT && WK * CT64 / 8 == NT, "one vector each");

__global__ void __launch_bounds__(NT) expand_dw_bf16(
    const bf16* __restrict__ x, const bf16* __restrict__ pw_w,
    const float* __restrict__ pw_s, const float* __restrict__ pw_b,
    const float* __restrict__ dw_w, const float* __restrict__ dw_s,
    const float* __restrict__ dw_b, float* __restrict__ h2,
    float* __restrict__ partial, int H, int W, int Cin, int Cmid) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto xs = reinterpret_cast<bf16 (*)[LDX]>(smem);
  auto ws = reinterpret_cast<bf16 (*)[LDW]>(smem + XS_BYTES);
  float* es = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + EXP_BUF);
  const int tid = threadIdx.x, warp = tid >> 5;
  const Tile t = tile_of<CT64>(W);

  // x vector j of this thread: halo pixel (tid + NT j) / 4, input channels
  // xk .. xk + 7 of the chunk; nullptr outside the image (zero padding)
  const int xk = (tid & 3) * 8;
  const bf16* xsrc[XV];
#pragma unroll
  for (int j = 0; j < XV; ++j) {
    const int p = (tid + NT * j) >> 2;
    const int gy = t.ty0 - 1 + p / HWD, gx = t.tx0 - 1 + p % HWD;
    xsrc[j] = (p < HPX && gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? x + ((static_cast<long long>(t.b) * H + gy) * W + gx) * Cin + xk
                  : nullptr;
  }
  // weight vector: chunk row wk, mid channels wc .. wc + 7
  const int wk = tid >> 3, wc = (tid & 7) * 8;
  const bool wvalid = t.c0 + wc < Cmid;
  const bf16* wsrc = pw_w + static_cast<long long>(wk) * Cmid + t.c0 + wc;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  uint4 xr[XV], wr;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XV; ++j)
      xr[j] = (xsrc[j] != nullptr && k0 + xk < Cin)
                  ? *reinterpret_cast<const uint4*>(xsrc[j] + k0) : zero4;
    wr = (wvalid && k0 + wk < Cin)
             ? *reinterpret_cast<const uint4*>(wsrc + static_cast<long long>(k0) * Cmid)
             : zero4;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wmma::fill_fragment(acc[i], 0.f);
  const int nt = warp & 3, mt0 = warp >> 2;  // row tiles mt0, mt0 + 2, ...
  fetch(0);
  for (int k0 = 0; k0 < Cin; k0 += WK) {
#pragma unroll
    for (int j = 0; j < XV; ++j)
      *reinterpret_cast<uint4*>(&xs[(tid + NT * j) >> 2][xk]) = xr[j];
    *reinterpret_cast<uint4*>(&ws[wk][wc]) = wr;
    __syncthreads();
    if (k0 + WK < Cin) fetch(k0 + WK);
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::load_matrix_sync(bm, &ws[kk][nt * 16], LDW);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &xs[(mt0 + 2 * i) * 16][kk], LDX);
        wmma::mma_sync(acc[i], a, bm, acc[i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    wmma::store_matrix_sync(es + (mt0 + 2 * i) * 16 * LDE64 + nt * 16, acc[i],
                            LDE64, wmma::mem_row_major);
  __syncthreads();
  expand_tail<CT64>(es, red, t, pw_s, pw_b, dw_w, dw_s, dw_b, h2, partial, H, W,
                    Cmid);
}

// (b) grid B, 256 threads, dynamic smem (Cmid + rd) floats
template <typename T>
__global__ void __launch_bounds__(256) se_kernel(
    const float* __restrict__ partial, const T* __restrict__ rw,
    const float* __restrict__ rb, const T* __restrict__ ew,
    const float* __restrict__ eb, float* __restrict__ gate, int tiles,
    int S, int Cmid, int rd) {
  extern __shared__ float sm[];
  float* pooled = sm;
  float* hid = sm + Cmid;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < Cmid; c += 256) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t)
      s += partial[(static_cast<long long>(b) * tiles + t) * Cmid + c];
    pooled[c] = round_t<T>(s / static_cast<float>(S));
  }
  __syncthreads();
  for (int j = warp; j < rd; j += NWARP) {
    float s = 0.f;
    for (int c = lane; c < Cmid; c += 32)
      s = fmaf(pooled[c], to_f(rw[static_cast<long long>(c) * rd + j]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) hid[j] = round_t<T>(silu(s + rb[j]));
  }
  __syncthreads();
  for (int c = tid; c < Cmid; c += 256) {
    float s = 0.f;
    for (int j = 0; j < rd; ++j)
      s = fmaf(hid[j], to_f(ew[static_cast<long long>(j) * Cmid + c]), s);
    gate[static_cast<long long>(b) * Cmid + c] = sigmoid(s + eb[c]);
  }
}

// operand of (c): h2 * gate, rounded through the activation type
template <typename T>
__device__ __forceinline__ float gated(const float* __restrict__ h2,
                                       const float* __restrict__ gate, int gm,
                                       int gk, int S, int K) {
  float v = h2[static_cast<long long>(gm) * K + gk];
  if (gate) v *= gate[static_cast<long long>(gm / S) * K + gk];
  return round_t<T>(v);
}

// epilogue of (c): BN fold, f32 residual, one cast
template <typename T>
__device__ __forceinline__ void project_out(float acc, int gm, int gn, int N,
                                            const float* __restrict__ s3,
                                            const float* __restrict__ b3,
                                            const T* __restrict__ res,
                                            T* __restrict__ out) {
  float v = fmaf(acc, s3[gn], b3[gn]);
  const long long o = static_cast<long long>(gm) * N + gn;
  if (res) v += to_f(res[o]);
  out[o] = from_f<T>(v);
}

// (c), f32: CUDA cores. grid (ceil(N / 64), ceil(M / 64)), 256 threads,
// 4x4 outputs each
constexpr int BM = 64, BN = 64, BK = 16;

__global__ void __launch_bounds__(256) project_f32(
    const float* __restrict__ h2, const float* __restrict__ gate,
    const float* __restrict__ w, const float* __restrict__ s3,
    const float* __restrict__ b3, const float* __restrict__ res,
    float* __restrict__ out, int M, int S, int K, int N) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + 256 * r;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? gated<float>(h2, gate, gm, gk, S, K) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + 256 * r;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? w[static_cast<long long>(gk) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gm < M && gn < N) project_out<float>(acc[i][j], gm, gn, N, s3, b3, res, out);
    }
  }
}

// (c), bf16: tensor cores. grid (ceil(N / 64), ceil(M / 128)), 256 threads;
// warp (wm, wn) of a 4 x 2 grid owns a 32 x 32 block of 2 x 2 WMMA tiles.
// Per K chunk of 32 every thread moves four 4-float vectors of h2 (and of
// the gate) and one 16-byte vector of weights, fetched a chunk ahead of the
// products. Its rows are fixed, so their addresses (and each row's image,
// for the gate) are worked out once. K and N must be multiples of 8.
constexpr int PBM = 128, PBN = 64, PBK = 32;
constexpr int LDA = PBK + 8, LDB = PBN + 8, LDC = PBN + 4;
constexpr int AV = PBM * PBK / 4 / NT;  // h2 vectors per thread per chunk: 4
constexpr int PA_BYTES = PBM * LDA * 2;
constexpr int PB_BYTES = PBK * LDB * 2;
constexpr int PC_BYTES = PBM * LDC * 4;
constexpr int PRJ_SMEM = PC_BYTES > PA_BYTES + PB_BYTES ? PC_BYTES : PA_BYTES + PB_BYTES;
static_assert(PBM * PBK / 4 == AV * NT && PBK * PBN / 8 == NT, "one vector each");

__global__ void __launch_bounds__(NT) project_bf16(
    const float* __restrict__ h2, const float* __restrict__ gate,
    const bf16* __restrict__ w, const float* __restrict__ s3,
    const float* __restrict__ b3, const bf16* __restrict__ res,
    bf16* __restrict__ out, int M, int S, int K, int N) {
  // operands and then the f32 result tile share one buffer
  __shared__ __align__(128) unsigned char buf[PRJ_SMEM];
  auto As = reinterpret_cast<bf16 (*)[LDA]>(buf);
  auto Bs = reinterpret_cast<bf16 (*)[LDB]>(buf + PA_BYTES);
  auto Cs = reinterpret_cast<float (*)[LDC]>(buf);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * PBM, n0 = blockIdx.x * PBN;

  // h2 vector j of this thread: tile row (tid / 8) + 32 j, columns ak .. ak + 3
  const int ak = (tid & 7) * 4;
  const float* asrc[AV];
  const float* gsrc[AV];
#pragma unroll
  for (int j = 0; j < AV; ++j) {
    const int gm = m0 + (tid >> 3) + 32 * j;
    asrc[j] = gm < M ? h2 + static_cast<long long>(gm) * K + ak : nullptr;
    gsrc[j] = gm < M && gate != nullptr
                  ? gate + static_cast<long long>(gm / S) * K + ak : nullptr;
  }
  // weight vector: chunk row bk, output channels bn .. bn + 7
  const int bk = tid >> 3, bn = (tid & 7) * 8;
  const bool bvalid = n0 + bn < N;
  const bf16* bsrc = w + static_cast<long long>(bk) * N + n0 + bn;

  const float4 zero_f = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 one_f = make_float4(1.f, 1.f, 1.f, 1.f);
  float4 ar[AV], gr[AV];
  uint4 br;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const bool valid = asrc[j] != nullptr && k0 + ak < K;
      ar[j] = valid ? *reinterpret_cast<const float4*>(asrc[j] + k0) : zero_f;
      gr[j] = valid && gsrc[j] != nullptr
                  ? *reinterpret_cast<const float4*>(gsrc[j] + k0) : one_f;
    }
    br = bvalid && k0 + bk < K
             ? *reinterpret_cast<const uint4*>(bsrc + static_cast<long long>(k0) * N)
             : make_uint4(0u, 0u, 0u, 0u);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += PBK) {
#pragma unroll
    for (int j = 0; j < AV; ++j) {  // h2 * gate, rounded once to bf16
      __nv_bfloat162 v[2] = {
          __floats2bfloat162_rn(ar[j].x * gr[j].x, ar[j].y * gr[j].y),
          __floats2bfloat162_rn(ar[j].z * gr[j].z, ar[j].w * gr[j].w)};
      *reinterpret_cast<uint2*>(&As[(tid >> 3) + 32 * j][ak]) =
          *reinterpret_cast<const uint2*>(v);
    }
    *reinterpret_cast<uint4*>(&Bs[bk][bn]) = br;
    __syncthreads();
    if (k0 + PBK < K) fetch(k0 + PBK);
#pragma unroll
    for (int kk = 0; kk < PBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bm[j], &Bs[kk][wn * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < PBM * PBN; idx += NT) {
    const int m = idx / PBN, n = idx % PBN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N) project_out<bf16>(Cs[m][n], gm, gn, N, s3, b3, res, out);
  }
}

}  // namespace

// spatial tiles of (a) per image: the row count of its partial sums
extern "C" int p4fr_mbconv_tiles(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

extern "C" int p4fr_mbconv_expand_dw(
    const void* x, const void* pw_w, const void* pw_s, const void* pw_b,
    const void* dw_w, const void* dw_s, const void* dw_b, void* h2,
    void* partial, int B, int H, int W, int Cin, int Cmid, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[5] = {static_cast<const float*>(pw_s), static_cast<const float*>(pw_b),
                       static_cast<const float*>(dw_w), static_cast<const float*>(dw_s),
                       static_cast<const float*>(dw_b)};
  if (is_bf16) {
    if (Cin % 8 || Cmid % 8) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        expand_dw_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, EXP_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(p4fr_mbconv_tiles(H, W), (Cmid + CT64 - 1) / CT64, B);
    expand_dw_bf16<<<grid, NT, EXP_SMEM, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(pw_w), f[0], f[1],
        f[2], f[3], f[4], static_cast<float*>(h2), static_cast<float*>(partial),
        H, W, Cin, Cmid);
  } else {
    dim3 grid(p4fr_mbconv_tiles(H, W), (Cmid + CT32 - 1) / CT32, B);
    expand_dw_f32<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(pw_w), f[0], f[1],
        f[2], f[3], f[4], static_cast<float*>(h2), static_cast<float*>(partial),
        H, W, Cin, Cmid);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p4fr_mbconv_se(
    const void* partial, const void* rw, const void* rb, const void* ew,
    const void* eb, void* gate, int B, int tiles, int S, int Cmid, int rd,
    int is_bf16, void* stream) {
  size_t smem = static_cast<size_t>(Cmid + rd) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P4FR_LAUNCH(T)                                                      \
  se_kernel<T><<<B, 256, smem, s>>>(                                        \
      static_cast<const float*>(partial), static_cast<const T*>(rw),        \
      static_cast<const float*>(rb), static_cast<const T*>(ew),             \
      static_cast<const float*>(eb), static_cast<float*>(gate), tiles, S,   \
      Cmid, rd)
  if (is_bf16) P4FR_LAUNCH(bf16); else P4FR_LAUNCH(float);
#undef P4FR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p4fr_mbconv_project(
    const void* h2, const void* gate, const void* w, const void* s3,
    const void* b3, const void* res, void* out, int B, int S, int K, int N,
    int is_bf16, void* stream) {
  const int M = B * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + PBN - 1) / PBN, (M + PBM - 1) / PBM);
    project_bf16<<<grid, NT, 0, s>>>(
        static_cast<const float*>(h2), static_cast<const float*>(gate),
        static_cast<const bf16*>(w), static_cast<const float*>(s3),
        static_cast<const float*>(b3), static_cast<const bf16*>(res),
        static_cast<bf16*>(out), M, S, K, N);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    project_f32<<<grid, NT, 0, s>>>(
        static_cast<const float*>(h2), static_cast<const float*>(gate),
        static_cast<const float*>(w), static_cast<const float*>(s3),
        static_cast<const float*>(b3), static_cast<const float*>(res),
        static_cast<float*>(out), M, S, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
