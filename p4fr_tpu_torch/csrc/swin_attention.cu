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
// the f32 scores before the bias is added, and the mask comes after the
// bias. Scores and softmax in f32, every product accumulated in f32; with
// bf16 operands the probabilities are normalised, then rounded to bf16
// before the value product, and each head's output is rounded once at the
// end (the TPU kernel's two .astype(cdtype), :96 and :101).
//
// Bound on the card: device-memory bytes, qkv read once and the output
// written once (0.71 ms per B=32 encode); the products take a quarter of
// that on bf16 tensor cores. What sets the pace is the bias and the mask:
// each (window, head) reads its head's bias and its window's mask row,
// n x n f32 each, from L2 (~7.8 GB per B=32 encode against 2.3 GB of
// qkv and output): the bf16 body takes 3.36 ms per encode with them and
// 2.05 ms with those reads left out (tolerance_study.py's no_tables probe;
// PERF.md, Findings).
//
// bf16 (the serving path): both products on the tensor cores, mma.sync
// m16n8k16 with bf16 operands and f32 accumulators. The CTA stages its
// head's q, k and v rows as bf16 in shared memory with 16-byte cp.async
// (v in a second group, so the scores start before it lands), rows padded
// to 80 bytes so that the 8 rows of an ldmatrix phase fall in 8 different
// bank groups, tokens n .. 16*ceil(n/16) zero-filled. A CTA of up to 4
// warps walks the ceil(n/16) row tiles of 16 query rows in equal rounds
// (n = 144: 3 warps of 3 tiles); the kernel is instanced per tile count,
// so every loop over keys is unrolled. For a tile, each thread first
// copies its own bias and mask fragments (the accumulator layout: c0/c1
// are row r, keys 2t and 2t+1; c2/c3 row r+8) from L2 into its slots of
// shared memory by 8-byte cp.async, zero-filled past n, so that they are
// in flight while the scores are computed: loaded into registers, they
// were hoisted and spilled. Then q by ldmatrix, k by ldmatrix straight
// from its row-major rows (the "col" operand), the 16 x n scores in the
// accumulators (n/4 f32 registers a thread), never in memory. The softmax
// runs on them in registers: scale, then bias, then mask, keys at or past
// n -inf, the row max and sum over the quad by two shuffles, e^x as one
// ex2.approx and the normalisation as one multiply by the reciprocal of
// the sum (expf and the IEEE division take 2.9 times as long: the
// expf_division probe). The
// probabilities are normalised, then rounded to bf16 and repacked in
// registers from the accumulator layout into the A operand of the value
// product; v comes by ldmatrix.trans. The 16 x 32 output goes through the
// tile's spent q rows in shared memory to 16-byte stores. 253 registers a
// thread at n = 144 and 90 KB of shared memory: 2 CTAs an SM.
//
// f32 runs on the CUDA cores, as the first port did: the f32 gates (the
// kernel check at 1e-4, SwinTRN's memory and logits at 1e-3) need full
// f32 products, which TF32 tensor cores do not give. Its CTA stages q, k
// and v in f32 (k rows padded to 33 floats, so the lanes of a warp, each
// reading another key row, hit 32 different banks); one warp per query
// row: each lane scores key positions lane, lane+32, ... (n <= 160, five
// chunks), the row's max and sum come from warp shuffles, then each lane
// owns one of the 32 head dims and accumulates the value product, the
// probabilities broadcast by shuffles. The TPU kernel transposed k
// outside, for the MXU; here k is read in place from qkv in both forms.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 32;               // head dim (every Swin-B stage)
constexpr int MAXC = 5;              // 32-position chunks a row: n <= 160

// ------------------------------------------------------------ f32 body

constexpr int NTH = 256;             // threads per CTA
constexpr int NWARPS = NTH / 32;
constexpr int KLD = HD + 1;          // padded k row, floats

inline size_t smem_floats(int n) {
  const int rows = (n + 31) / 32 * 32;
  return static_cast<size_t>(n) * (HD + KLD) + static_cast<size_t>(rows) * HD;
}

__global__ void __launch_bounds__(NTH) window_attention_f32(
    const float* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ out, int n, int C,
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
  const float* src = qkv + row0 * 3 * C + h * HD + lane;

  // one warp per token: its q, k and v head slices, 32 contiguous values each
  for (int t = warp; t < nc * 32; t += NWARPS) {
    if (t < n) {
      const float* p = src + static_cast<long long>(t) * 3 * C;
      qs[t * HD + lane] = p[0];
      ks[t * KLD + lane] = p[C];
      vs[t * HD + lane] = p[2 * C];
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
    for (int c = 0; c < MAXC; ++c) s[c] = s[c] / sum;

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
    out[(row0 + i) * C + h * HD + lane] = acc;
  }
}

// ------------------------------------------------ bf16 tensor-core body

using bfloat = __nv_bfloat16;
constexpr int LDS = HD + 8;            // bf16 row pitch of q, k, v: 80 bytes
constexpr int MAXNK = MAXC * 32 / 16;  // 16-token tiles: n <= 160
constexpr int TC_MAX_WARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8m .. 8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bfloat* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bfloat* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values rounded to bf16, lo in the low half (the lower key or dim)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// e^(x - mx) as 2^(x log2(e) - mx2), mx2 = mx log2(e): one FFMA and one
// MUFU.EX2
__device__ __forceinline__ float exp_shift(float x, float mx2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(fmaf(x, LOG2E, -mx2)));
  return y;
}

// a pair of floats (keys c, c+1 of a row of bias or mask) into shared
// memory: the first `bytes` (0, 4 or 8) copied, the rest zero-filled, so
// that rows past n and keys past kend are never read; PAIR: 8-byte aligned
// (n even), else two 4-byte copies
template <bool PAIR>
__device__ __forceinline__ void stage_pair(float2* dst, const float* src, int bytes) {
  const unsigned d = smem_u32(dst);
  if constexpr (PAIR) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(min(bytes, 4)) : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d + 4), "l"(src + 1), "r"(max(bytes - 4, 0)) : "memory");
  }
}

// a thread's bias and mask fragments of one row tile (rows lo, hi = lo + 8;
// the mask's rows null without one) into its slots of `frag`: key tile j,
// bias lo, hi, mask lo, hi at float2 (4j + f) * 32
template <int NT, bool PAIR>
__device__ __forceinline__ void stage_tile(float2* frag, const float* const (&rows)[4],
                                           const float* any, int lo, int n, int kend,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t4;
    const int key_bytes = min(max(kend - c, 0), 2) * 4;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f >= 2 && rows[2] == nullptr) break;
      const bool row_ok = lo + (f & 1) * 8 < n;
      stage_pair<PAIR>(frag + (4 * j + f) * 32, row_ok ? rows[f] + c : any,
                       row_ok ? key_bytes : 0);
    }
  }
}

// f32 score -> logit: scale, then the bias, then the mask
__device__ __forceinline__ float logit(float dot, float scale, float b, float m) {
  return (__fmul_rn(dot, scale) + b) + m;
}

// the threads of a CTA for NK row tiles: the fewest warps that walk them
// in as few rounds as TC_MAX_WARPS warps would
__host__ __device__ constexpr int tc_threads(int nk) {
  return 32 * ((nk + (nk + TC_MAX_WARPS - 1) / TC_MAX_WARPS - 1) /
               ((nk + TC_MAX_WARPS - 1) / TC_MAX_WARPS));
}

template <int NK>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32, 2) window_attention_tc(
    const bfloat* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, bfloat* __restrict__ out, int n, int C,
    int heads, int nW, float scale) {
  constexpr int NP = NK * 16;  // tokens, padded to whole 16-row tiles
  constexpr int NT = 2 * NK;   // 8-key accumulator tiles of a row tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bfloat* qs = reinterpret_cast<bfloat*>(tc_smem);  // [NP][LDS], each
  bfloat* ks = qs + NP * LDS;
  bfloat* vs = ks + NP * LDS;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  // each thread's bias and mask fragments of its warp's row tile: key tile
  // j, bias row lo, hi, mask row lo, hi (f) at float2 ((4j + f) * 32 + lane)
  float2* frag = reinterpret_cast<float2*>(vs + NP * LDS) + warp * NT * 4 * 32 + lane;
  const int g = lane >> 2, t4 = lane & 3;  // the accumulator layout's row, pair
  // consecutive CTAs are the heads of one window: its qkv rows meet in L2
  const int w = blockIdx.x / heads, h = blockIdx.x % heads;
  const long long row0 = static_cast<long long>(w) * n;
  const bfloat* src = qkv + row0 * 3 * C + h * HD;

  // stage q and k (group 0), then v (group 1): 4 chunks of 16 bytes a row
  for (int i = tid; i < NP * 8; i += nth) {
    const int t = i >> 3, part = (i >> 2) & 1, c = (i & 3) * 8;
    bfloat* dst = (part ? ks : qs) + t * LDS + c;
    if (t < n)
      cp_async16(dst, src + static_cast<long long>(t) * 3 * C + part * C + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  for (int i = tid; i < NP * 4; i += nth) {
    const int t = i >> 2, c = (i & 3) * 8;
    bfloat* dst = vs + t * LDS + c;
    if (t < n)
      cp_async16(dst, src + static_cast<long long>(t) * 3 * C + 2 * C + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();

  const float* bias_h = bias + static_cast<long long>(h) * n * n;
  const float* mask_w =
      mask != nullptr ? mask + static_cast<long long>(w % nW) * n * n : nullptr;
  const int kend = n;  // keys at or past kend: -inf, never read
  const bool pair = (n & 1) == 0;
  cp_async_wait<1>();
  __syncthreads();
  // every warp has a first tile (nwarps <= NK), so every thread meets the
  // barrier that waits for v, once
  bool v_ready = false;
  for (int tile = warp; tile < NK; tile += nwarps) {
    const int r0 = tile * 16, lo = r0 + g, hi = lo + 8;
    const float* b_lo = bias_h + static_cast<long long>(lo) * n;
    const float* b_hi = b_lo + 8 * n;
    const float* m_lo =
        mask_w != nullptr ? mask_w + static_cast<long long>(lo) * n : nullptr;
    const float* m_hi = m_lo != nullptr ? m_lo + 8 * n : nullptr;
    // the tile's bias and mask in flight from L2 while the scores are computed
    // (loaded into registers they are hoisted and spilled); no barrier: each
    // thread reads back only what it copied
    const float* const rows[4] = {b_lo, b_hi, m_lo, m_hi};
    if (pair)
      stage_tile<NT, true>(frag, rows, bias, lo, n, kend, t4);
    else
      stage_tile<NT, false>(frag, rows, bias, lo, n, kend, t4);
    cp_async_commit();
    // scores: 2 k-steps over the 32 dims x NT key tiles
    unsigned qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm_x4(qa[kk], qs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + kk * 16 +
                          (lane >> 4) * 8);
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned kb[4];  // keys 8j .. 8j+7, dims 0-7, 8-15, 16-23, 24-31
      ldsm_x4(kb, ks + (j * 8 + (lane & 7)) * LDS + (lane >> 3) * 8);
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      mma_bf16(sc[j], qa[0], kb[0], kb[1]);
      mma_bf16(sc[j], qa[1], kb[2], kb[3]);
    }

    // logits and softmax in registers; rows lo and hi = lo + 8
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t4;
      const float2 zero = make_float2(0.f, 0.f);
      const float2 b0 = frag[(4 * j + 0) * 32], b1 = frag[(4 * j + 1) * 32];
      const float2 m0 = m_lo != nullptr ? frag[(4 * j + 2) * 32] : zero;
      const float2 m1 = m_lo != nullptr ? frag[(4 * j + 3) * 32] : zero;
      sc[j][0] = logit(sc[j][0], scale, b0.x, m0.x);
      sc[j][1] = logit(sc[j][1], scale, b0.y, m0.y);
      sc[j][2] = logit(sc[j][2], scale, b1.x, m1.x);
      sc[j][3] = logit(sc[j][3], scale, b1.y, m1.y);
      if (j * 8 + 8 > kend) {  // a key tile past n: those keys -inf
        if (c >= kend) sc[j][0] = sc[j][2] = -INFINITY;
        if (c + 1 >= kend) sc[j][1] = sc[j][3] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[j][0], sc[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the quad shares a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
    }
    const float mx2_lo = mx_lo * LOG2E, mx2_hi = mx_hi * LOG2E;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = exp_shift(sc[j][0], mx2_lo), sc[j][1] = exp_shift(sc[j][1], mx2_lo);
      sc[j][2] = exp_shift(sc[j][2], mx2_hi), sc[j][3] = exp_shift(sc[j][3], mx2_hi);
      sum_lo += sc[j][0] + sc[j][1];
      sum_hi += sc[j][2] + sc[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, o);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, o);
    }
    const float inv_lo = __frcp_rn(sum_lo), inv_hi = __frcp_rn(sum_hi);
#pragma unroll
    for (int j = 0; j < NT; ++j) {  // normalised here, rounded to bf16 below
      sc[j][0] *= inv_lo, sc[j][1] *= inv_lo;
      sc[j][2] *= inv_hi, sc[j][3] *= inv_hi;
    }

    if (!v_ready) {  // v landed with the first tile's fragments (wait_group 0)
      __syncthreads();
      v_ready = true;
    }
    // value product: NK k-steps over the keys x 4 dim tiles; the
    // probabilities' accumulator tiles 2kk, 2kk+1 are the A operand of k-step kk
    float o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned vb[4];  // keys 0-7, 8-15 of dim tile 2jj, then of 2jj+1
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                              (2 * jj + (lane >> 4)) * 8);
        mma_bf16(o[2 * jj], pa, vb[0], vb[1]);
        mma_bf16(o[2 * jj + 1], pa, vb[2], vb[3]);
      }
    }

    // the head's 16 x 32 output, rounded once, through the tile's spent q
    // rows to 16-byte stores of the rows before n
    bfloat* ob = qs + r0 * LDS;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<unsigned*>(ob + g * LDS + j * 8 + 2 * t4) =
          pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<unsigned*>(ob + (g + 8) * LDS + j * 8 + 2 * t4) =
          pack_bf16(o[j][2], o[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int k = lane; k < 64; k += 32) {
      const int r = k >> 2, c = (k & 3) * 8;
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(out + (row0 + r0 + r) * C + h * HD + c) =
            *reinterpret_cast<const uint4*>(ob + r * LDS + c);
    }
  }
}

template <int NK>
int launch_tc(const void* qkv, const void* bias, const void* mask, void* out,
              int N, int n, int C, int heads, int nW, float scale,
              cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(3) * NK * 16 * LDS * sizeof(bfloat) +
      static_cast<size_t>(tc_threads(NK)) * 2 * NK * 4 * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(window_attention_tc<NK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  window_attention_tc<NK><<<N * heads, tc_threads(NK), smem, stream>>>(
      static_cast<const bfloat*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bfloat*>(out), n, C, heads, nW,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core instance for n tokens (NK = ceil(n / 16))
template <int NK = 1>
int dispatch_tc(int nk, const void* qkv, const void* bias, const void* mask,
                void* out, int N, int n, int C, int heads, int nW, float scale,
                cudaStream_t stream) {
  if constexpr (NK > MAXNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nk == NK)
      return launch_tc<NK>(qkv, bias, mask, out, N, n, C, heads, nW, scale, stream);
    return dispatch_tc<NK + 1>(nk, qkv, bias, mask, out, N, n, C, heads, nW, scale,
                               stream);
  }
}

template <int NK = 1>
const void* tc_kernel_for(int nk) {
  if constexpr (NK > MAXNK) {
    return nullptr;
  } else {
    return nk == NK ? reinterpret_cast<const void*>(&window_attention_tc<NK>)
                    : tc_kernel_for<NK + 1>(nk);
  }
}

int launch_f32(const void* qkv, const void* bias, const void* mask, void* out,
               int N, int n, int C, int heads, int nW, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_floats(n) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      window_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  window_attention_f32<<<N * heads, NTH, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), n, C, heads, nW,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [N, n, 3C], bias [heads, n, n] f32, mask [nW, n, n] f32 or null ->
// out [N, n, C]; C = heads * 32, n <= 160. bf16 runs the tensor-core body,
// f32 the CUDA-core body.
extern "C" int p4fr_window_attention(const void* qkv, const void* bias,
                                     const void* mask, void* out, int N, int n,
                                     int C, int heads, int nW, float scale,
                                     int bf16, void* stream) {
  if (N <= 0 || heads <= 0 || C != heads * HD || n <= 0 || n > MAXC * 32 ||
      (mask != nullptr && nW <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_tc((n + 15) / 16, qkv, bias, mask, out, N, n, C, heads, nW,
                       scale, s);
  return launch_f32(qkv, bias, mask, out, N, n, C, heads, nW, scale, s);
}

// The compiled kernel for n tokens: its registers a thread and its local
// memory a thread in bytes (above 0: spills); bf16 the tensor-core body.
extern "C" int p4fr_window_attention_attrs(int n, int bf16, int* regs,
                                           int* local_bytes) {
  if (n <= 0 || n > MAXC * 32) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = bf16 ? tc_kernel_for((n + 15) / 16)
                        : reinterpret_cast<const void*>(&window_attention_f32);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}
