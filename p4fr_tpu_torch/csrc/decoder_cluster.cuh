// Kernel 3's layer step as a thread-block cluster, also run once per layer
// by kernel 6 (csrc/fused_decode.cu): C CTAs (C in 1, 2, 4, 8, 16; the
// wrapper picks it, ops/decoder_layer.py::cluster_size) share one group
// of TB = 4 batch rows. The contract is decoder_common.cuh's
// (p4fr_tpu/decoding/fast_step.py::jnp_layer_step, the int8 forms KvQ):
// scores / sqrt(H), ReLU after both FF linears, LayerNorm eps 1e-5, slot
// `pos` written in place after the attention (the output's k|v under
// cache_outputs), the int8 k-scale folded into the scores and the v-scale
// in after the mass.
//
// Why a cluster: at 4 rows every product is a GEMV over the layer's
// weights (~2 M values at SwinTRN's H=512), bound by the bytes one SM can
// pull from L2. One CTA a row group leaves most SMs idle when B/4 is small
// (8 CTAs at SwinTRN's B=32, 64 at the flagship's B=256, on 132 SMs); C
// CTAs a group stream 1/C of the weights each.
//
// Split:
// - products: the OUTPUT columns, in whole groups of 8 (rank r of C owns
//   groups [r*G/C, (r+1)*G/C) of every product), each over the full K.
//   Inside a CTA a pass takes 8*G' columns, G' a power of two <= 32: lane
//   = kq*G' + g owns the 8 columns of group g (one 16-byte weight load a
//   row) and the K rows of split warp*(32/G') + kq; the kq lanes meet by
//   shuffles, then the warps in shared memory (rowmm's scheme, which this
//   is at G' = 32). Splitting K across the ranks instead would read whole
//   512-byte weight rows but exchange C partial sums of every column over
//   DSMEM, C times the bytes of the column split's gather.
// - attention: the (row, head) pairs, rank r owning pairs [r*P/C,
//   (r+1)*P/C) of P = TB*heads; with fewer pairs than warps, the warps of
//   a pair split its positions in chunks of 32 (flash-decoding) and their
//   (max, sum, acc) merge in shared memory in split order, so the result
//   does not depend on timing.
// - LayerNorms: every rank, on the gathered rows (no exchange follows).
// - slot `pos` and the output: each rank writes its own columns; the int8
//   slot's per-(row, half) scale is the max over the whole half, which
//   every rank computes from the gathered k|v; rank 0 writes it.
// Every rank keeps all TB rows of every activation (f32) in its shared
// memory. After each split phase a rank stores its slice into every
// peer's copy (push: distributed shared memory, 16-byte stores) and the
// cluster barrier follows, so a phase reads only gathered values. A buffer
// that a phase pushes into is one that no rank touches in that phase or
// in the local work just before it (the buffer plan in layer_body_cluster),
// so one barrier a phase suffices. No DSMEM access follows the last
// barrier, which is therefore kernel 3's exit barrier: no CTA leaves while
// a peer may still touch its shared memory (kernel 6 ends in a barrier of
// its own).
#pragma once

#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "decoder_common.cuh"

namespace {

namespace cg = cooperative_groups;

// Threads a CTA, the template parameter NT of every function below: 512
// in a cluster (C > 1: fewer CTAs than SMs, so more warps a CTA keep more
// loads in flight); 256 alone (C = 1: many row groups, so two CTAs share
// an SM and the grid takes fewer waves).

// Read-only loads (ld.global.nc, __ldg): every global operand the body
// reads (x, weights, biases, the cache's slots < pos and their scales,
// src K|V) is unchanged for the launch; slot `pos`, which it writes, it
// never reads. The compiler does not infer this through the DSMEM stores
// and cluster barriers, and the coherent path is slower.
// 8 contiguous weights (16-byte aligned for bf16, 32 for f32) -> f32
__device__ __forceinline__ void ldg8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
// 32 contiguous values (16-byte aligned) -> f32, as 8 weights each
__device__ __forceinline__ void ldg32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ldg8(p + 8 * i, v + 8 * i);
}
__device__ __forceinline__ void ldg32(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) ldg8(p + 8 * i, v + 8 * i);
}
__device__ __forceinline__ void ldg32(const int8_t* p, float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p) + i);
    const char4* c = reinterpret_cast<const char4*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[16 * i + 4 * j] = c[j].x;
      v[16 * i + 4 * j + 1] = c[j].y;
      v[16 * i + 4 * j + 2] = c[j].z;
      v[16 * i + 4 * j + 3] = c[j].w;
    }
  }
}
// one cache position's value dims into decoder_common.cuh's ValueReg
template <typename T, int VPL>
__device__ __forceinline__ void ldg_value(ValueReg<T, VPL>& r, const T* p) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && VPL == 1)
    r.v = __bfloat162float(__ldg(p));
  else
    r.v = __ldg(reinterpret_cast<const decltype(r.v)*>(p));
}

// i-th of `parts` near-equal cuts of n
__device__ __forceinline__ int cut(int n, int parts, int i) {
  return static_cast<int>(static_cast<long long>(n) * i / parts);
}

__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// Store rows r < rows, columns [cb, ce) of buf (row stride ld; cb, ce and
// ld multiples of 4, buf 16-byte aligned) from this CTA's shared memory
// into the same place in every peer's; the caller's values must be
// synchronised, and the cluster barrier must follow before a peer reads.
template <int NT>
__device__ void push(float* buf, int ld, int rows, int cb, int ce, int C, int rank) {
  if (C == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  const int n4 = (ce - cb) / 4, per = rows * n4;
  for (int i = threadIdx.x; i < per * (C - 1); i += NT) {
    const int peer = (rank + 1 + i / per) % C, e = i % per;
    const int r = e / n4, c = cb + 4 * (e % n4);
    float4* src = reinterpret_cast<float4*>(buf + r * ld + c);
    *cl.map_shared_rank(src, peer) = *src;
  }
}

// KB weight rows k .. k+KB-1 of the lane's 8 columns into acc, all KB
// loads issued before the first use. GUARD (the last batch of a short K
// range): rows past k1 load row k1-1 (an address that exists) and meet a
// zero input, so no load is predicated or branched around.
template <bool GUARD, typename T>
__device__ __forceinline__ void rowmm_batch(const float* in, int K, const T* wp, int ldw,
                                            int k, int k1, float (&acc)[TB][CPT]) {
  float wv[KB][CPT];
#pragma unroll
  for (int u = 0; u < KB; ++u)
    ldg8(wp + static_cast<long long>(GUARD ? min(k + u, k1 - 1) : k + u) * ldw, wv[u]);
#pragma unroll
  for (int u = 0; u < KB; ++u)
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float a = !GUARD || k + u < k1 ? in[r * K + k + u] : 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(a, wv[u][j], acc[r][j]);
    }
}

// out[r][n] = act(sum_k in[r][k] * W[k][n] + bias[n]) for r < TB and this
// rank's columns n in [nb, ne) (multiples of 8), into this CTA's `out`
// (row stride ldo); columns n >= round_from are rounded through T (the
// cache's type). in: smem [TB][K]; bias in T, or f32 (TBias; kernel 6's
// generator); red: smem scratch of NT / 32 * TB * NCHUNK floats. Returns
// synchronised.
template <int NT, typename T, typename TBias = T>
__device__ void rowmm_part(const float* in, int K, const T* __restrict__ W, int ldw,
                           const TBias* __restrict__ bias, int nb, int ne, float* out,
                           int ldo, bool relu, int round_from, float* red) {
  constexpr int NW = NT / 32, OUTS = TB * NCHUNK / NT;  // OUTS: outputs a thread sums
  static_assert(TB * NCHUNK % NT == 0, "whole outputs a thread");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n0 = nb; n0 < ne;) {
    const int groups = min(32, (ne - n0) / CPT);
    const int G = 1 << (31 - __clz(groups));  // column groups this pass
    const int w = G * CPT, g = lane & (G - 1), kq = lane / G;
    const int ks = warp * (32 / G) + kq, n_split = NW * (32 / G);
    const int kper = (K + n_split - 1) / n_split;
    const int k0 = min(K, ks * kper), k1 = min(K, k0 + kper);
    float bv[OUTS];  // this thread's outputs' biases, loaded ahead
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int i = threadIdx.x + o * NT;
      bv[o] = i < TB * w ? to_f(__ldg(bias + n0 + i % w)) : 0.f;
    }
    float acc[TB][CPT];
#pragma unroll
    for (int r = 0; r < TB; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
    const T* wp = W + n0 + g * CPT;
    int k = k0;
    for (; k + KB <= k1; k += KB) rowmm_batch<false>(in, K, wp, ldw, k, k1, acc);
    if (k < k1) rowmm_batch<true>(in, K, wp, ldw, k, k1, acc);
    for (int o = G; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < TB; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
    if (kq == 0)
#pragma unroll
      for (int r = 0; r < TB; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) red[(warp * TB + r) * w + g * CPT + j] = acc[r][j];
    __syncthreads();
#pragma unroll
    for (int o = 0; o < OUTS; ++o) {
      const int i = threadIdx.x + o * NT;
      if (i < TB * w) {
        const int r = i / w, c = i % w, n = n0 + c;
        float v = bv[o];
#pragma unroll
        for (int gw = 0; gw < NW; ++gw) v += red[(gw * TB + r) * w + c];
        if (relu) v = fmaxf(v, 0.f);
        out[r * ldo + n] = n >= round_from ? round_t<T>(v) : v;
      }
    }
    __syncthreads();
    n0 += w;
  }
}

// The end of one (row r, head h) attention: the current token (`cur`,
// shared memory) folded in last, then out[r*H + h*D ..] = acc / sum.
template <int D>
__device__ __forceinline__ void finish_pair(const float* q, int r, int h, int H,
                                            float temp, const float* cur, int cur_ld,
                                            float m, float ssum, float* acc, float* out) {
  constexpr int VPL = D / 32;
  const int lane = threadIdx.x & 31;
  if (cur != nullptr) {
    const float* cr = cur + r * cur_ld;
    float dot = q[VPL * lane] * cr[h * D + VPL * lane];
#pragma unroll
    for (int i = 1; i < VPL; ++i)
      dot = fmaf(q[VPL * lane + i], cr[h * D + VPL * lane + i], dot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const float sc = dot / temp;
    const float mn = fmaxf(m, sc);
    const float corr = expf(m - mn);  // 0 with no position before
    const float p = expf(sc - mn);
    ssum = ssum * corr + p;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      acc[i] = fmaf(p, cr[H + h * D + VPL * lane + i], acc[i] * corr);
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) out[r * H + h * D + VPL * lane + i] = acc[i] / ssum;
}

// decoder_common.cuh's attend for this rank's pairs p0 .. p0+np-1 (pair
// p: row p / heads, head p % heads); row b's position l of kv at
// b * row_stride + l * pos_stride (a batch-major [B, L, 2H] cache or the
// cross K|V: L * 2H and 2H; kernel 6's time-major [L, B, 2H] cache: 2H and
// B * 2H), keys at + h*D, values at + H + h*D; into
// this CTA's out [TB][H] at pair p's D values, out[p*D ..]. With np >=
// NT / 32 warps take whole pairs; otherwise each pair gets NT / 32 / np
// warps, warp `split` of them taking the chunks l0 = 32 * (split + k *
// wpp), and the partials merge in `stage` (smem, NT / 32 * (D + 2) floats)
// in split order. SCALED (int8 K|V codes): each position's k-scale and v-scale come
// from `scl` (KvScales); a lane loads those of the position it scores with
// its key row, multiplies its score by the k-scale after the division by
// sqrt(H), and hands its probability times the v-scale to the value loop,
// while the mass sums the probability. Returns synchronised.
template <int NT, typename T, int D, bool SCALED>
__device__ void attend_part(const float* qbuf, int qld, const T* __restrict__ kv,
                            int row_stride, int pos_stride, int b0, int nrows,
                            int n_pos, int H, int heads,
                            float temp, const float* cur, int cur_ld, float* out,
                            KvScales scl, int p0, int np, float* stage) {
  static_assert(D == 32 || D == 64, "heads of 32 or 64");
  constexpr int VPL = D / 32;  // value dims per lane
  constexpr int SD = D + 2;    // a partial in stage: max, sum, acc[D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_mem = cur != nullptr ? n_pos - 1 : n_pos;
  constexpr int nw = NT / 32;
  const int wpp = np >= nw ? 1 : nw / max(np, 1);  // warps a pair
  const int split = warp % wpp;
  for (int j = warp / wpp; j < np; j += nw / wpp) {
    const int pair = p0 + j, r = pair / heads, h = pair % heads;
    const float* q = qbuf + r * qld + h * D;
    float m = -INFINITY, ssum = 0.f, acc[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
    if (r < nrows) {
      const T* base = kv + static_cast<long long>(b0 + r) * row_stride;
      const float* srow = SCALED ? scl.p + static_cast<long long>(b0 + r) * scl.row
                                 : nullptr;
      const T* vcol = base + H + h * D + VPL * lane;
      for (int l0 = 32 * split; l0 < n_mem; l0 += 32 * wpp) {
        const int l = l0 + lane;
        // positions past the end load the last row and get probability 0
        float kk[D];
        ValueReg<T, VPL> vbuf[32];
        const long long lc = min(l, n_mem - 1);
#pragma unroll
        for (int c = 0; c < VPL; ++c)
          ldg32(base + lc * pos_stride + h * D + 32 * c, kk + 32 * c);
        float sk = 1.f, sv = 1.f;  // this lane's position's scales
        if constexpr (SCALED) {
          sk = __ldg(srow + lc * scl.pos);
          sv = __ldg(srow + lc * scl.pos + scl.v);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const long long li = min(l0 + i, n_mem - 1);
          ldg_value(vbuf[i], vcol + li * pos_stride);
        }
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], kk[d], dot);
        const float sc = l < n_mem ? (SCALED ? dot / temp * sk : dot / temp) : -INFINITY;
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
        const float pv = SCALED ? p * sv : p;  // the v-scale after the mass
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[i] *= corr;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float pi = __shfl_sync(0xffffffffu, pv, i);
#pragma unroll
          for (int c = 0; c < VPL; ++c) acc[c] = fmaf(pi, vbuf[i].get(c), acc[c]);
        }
        m = mn;
      }
    }
    if (wpp == 1) {
      if (r < nrows) finish_pair<D>(q, r, h, H, temp, cur, cur_ld, m, ssum, acc, out);
    } else {
      float* st = stage + (j * wpp + split) * SD;
      if (lane == 0) st[0] = m, st[1] = ssum;
#pragma unroll
      for (int i = 0; i < VPL; ++i) st[2 + VPL * lane + i] = acc[i];
    }
  }
  __syncthreads();
  if (wpp > 1 && warp < np) {  // one warp a pair merges its splits
    const int pair = p0 + warp, r = pair / heads, h = pair % heads;
    if (r < nrows) {
      const float* st = stage + warp * wpp * SD;
      float m = -INFINITY, ssum = 0.f, acc[VPL];
      for (int s = 0; s < wpp; ++s) m = fmaxf(m, st[s * SD]);
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
      for (int s = 0; s < wpp; ++s) {
        const float ms = st[s * SD];
        if (ms == -INFINITY) continue;  // a split with no position
        const float f = expf(ms - m);
        ssum = fmaf(f, st[s * SD + 1], ssum);
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[i] = fmaf(f, st[s * SD + 2 + VPL * lane + i], acc[i]);
      }
      finish_pair<D>(qbuf + r * qld + h * D, r, h, H, temp, cur, cur_ld, m, ssum, acc,
                     out);
    }
  }
  __syncthreads();
}

// A cluster CTA's shared memory, every buffer [TB][width] f32: X the input
// (later out2), Q q|k|v (later the output's k|v), AT the attention output
// (self, then cross), P the projections (out, out2, ff1), O1 out1, Q2 the
// cross query (later the layer's output), FB the FF's inner activation, R
// rowmm_part's partial sums and attend_part's stage (red_floats<NT>).
struct ClusterSmem {
  float *X, *Q, *AT, *P, *O1, *Q2, *FB, *R;
};

template <int NT>
__host__ __device__ constexpr int red_floats() {
  return NT / 32 * TB * NCHUNK;
}

// floats of a CTA of NT threads
template <int NT>
size_t cluster_smem_floats(int H, int F) {
  return static_cast<size_t>(TB) * (8 * H + F) + red_floats<NT>();
}

__device__ __forceinline__ ClusterSmem carve_cluster_smem(float* sm, int H, int F) {
  ClusterSmem s;
  s.X = sm;
  s.Q = s.X + TB * H;
  s.AT = s.Q + TB * 3 * H;
  s.P = s.AT + TB * H;
  s.O1 = s.P + TB * H;
  s.Q2 = s.O1 + TB * H;
  s.FB = s.Q2 + TB * H;
  s.R = s.FB + TB * F;
  return s;
}

// This rank's columns [cb, ce) of slot `pos` for the valid rows, from the
// gathered k|v at kv[r*3H ..] (smem), row b's slot at b * c_row + pos *
// c_pos (attend_part's strides): in T, or (kSrcCache) as int8 codes
// with the per-(row, half) scales max(max|x|, 1e-8) / 127, computed over
// the whole half by every rank (one warp a (row, half)) and written by rank
// 0; codes clip(rint(x / scale), -127, 127), IEEE division, so they are
// the plain version's.
template <int NT, typename T, KvQ KQ>
__device__ void write_slot_part(const float* kv, CacheT<T, KQ>* __restrict__ cache,
                                float* __restrict__ cache_scale, float* scl, int c_row,
                                int c_pos, int L, int b0, int nrows, int H, int pos,
                                int cb, int ce, int rank) {
  const int n = ce - cb;
  CacheT<T, KQ>* at = cache + static_cast<long long>(pos) * c_pos;
  if constexpr (KQ == KvQ::kSrcCache) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int pair = warp; pair < nrows * 2; pair += NT / 32) {
      const int r = pair >> 1, half = pair & 1;
      const float* xr = kv + r * 3 * H + half * H;
      float mx = 0.f;
      for (int i = lane; i < H; i += 32) mx = fmaxf(mx, fabsf(xr[i]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float sc = fmaxf(mx, 1e-8f) / 127.f;
      if (lane == 0) {
        scl[pair] = sc;
        if (rank == 0)
          cache_scale[(static_cast<long long>(b0 + r) * L + pos) * 2 + half] = sc;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * n; i += NT) {
      const int r = i / n, j = cb + i % n;
      const float sc = scl[r * 2 + j / H];
      at[static_cast<long long>(b0 + r) * c_row + j] = static_cast<int8_t>(
          fminf(fmaxf(rintf(kv[r * 3 * H + j] / sc), -127.f), 127.f));
    }
  } else {
    for (int i = threadIdx.x; i < nrows * n; i += NT) {
      const int r = i / n, j = cb + i % n;
      at[static_cast<long long>(b0 + r) * c_row + j] = from_f<T>(kv[r * 3 * H + j]);
    }
  }
}

// This rank's share [b, e) of n columns, in whole groups of CPT.
struct Cols {
  int b, e;
};
__device__ __forceinline__ Cols rank_cols(int n, int C, int rank) {
  return {CPT * cut(n / CPT, C, rank), CPT * cut(n / CPT, C, rank + 1)};
}

// One layer step of the rows b0 .. b0+nrows-1 on rank `rank` of a cluster
// of C. On entry s.X holds the rows' input (f32, every row of the group,
// synchronised); on return s.Q2 holds the layer's output (f32, every row,
// synchronised) and this rank's columns of slot `pos` of the cache are
// written (b * c_row + pos * c_pos, attend_part's strides); the caller
// writes the output. Phases, each ending in the cluster barrier after its
// push (buffer written: what it reads):
//   qkv Q: X | self-attention AT: Q, cache | out-proj P: AT |
//   LN1 O1 (local), q2 Q2: O1 | cross-attention AT: Q2, src | out2 P: AT |
//   LN2 X (local), ff0 FB: X | ff1 P: FB | LN3 Q2 (local);
//   the output's k|v into Q+H (cache_outputs; pushed only for the int8
//   slot's scale), slot `pos`.
// The opening barrier (arrive before the qkv product, wait before its
// push) keeps a peer's first push out of a CTA that has not started, and,
// when layers are chained in one launch (kernel 6: `chained`, every layer
// after the first), out of Q while this CTA still reads the last layer's
// k|v there for its slot. The chained plan, layer l to layer l+1: after
// layer l's last barrier (LN3 gathered; with kSrcCache the output's k|v)
// no peer pushes in layer l again; each rank then reads Q2 and Q+H locally
// (the cache_outputs product and slot `pos`), refills X from Q2 and
// arrives, with release semantics, only after those reads; peers push
// layer l+1's q|k|v into Q only after the wait, so after every rank's
// arrival. X, which the refill writes, no peer ever pushes into.
template <int NT, typename T, int D, KvQ KQ>
__device__ void layer_body_cluster(const ClusterSmem& s, const Weights& wt,
                                   CacheT<T, KQ>* __restrict__ cache, int c_row, int c_pos,
                                   float* __restrict__ cache_scale,
                                   const SrcT<T, KQ>* __restrict__ src,
                                   const float* __restrict__ src_scale, int b0, int nrows,
                                   int H, int heads, int F, int S, int L, int pos,
                                   int cache_outputs, int C, int rank, bool chained) {
  const float temp = sqrtf(static_cast<float>(H));
  const int p0 = cut(TB * heads, C, rank), np = cut(TB * heads, C, rank + 1) - p0;
  const Cols hc = rank_cols(H, C, rank);
  const int hb = hc.b, he = hc.e;
  float *X = s.X, *Q = s.Q, *AT = s.AT, *P = s.P, *O1 = s.O1, *Q2 = s.Q2, *FB = s.FB,
        *R = s.R;
  const auto w = [](const void* p) { return static_cast<const T*>(p); };

  const bool opening = C > 1;
  if (opening) {
    if (chained)
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    else
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  // fused q|k|v of the current token; k|v rounded to the cache type
  const Cols c3 = rank_cols(3 * H, C, rank);
  rowmm_part<NT, T>(X, H, w(wt.w_qkv), 3 * H, w(wt.b_qkv), c3.b, c3.e, Q, 3 * H, false, H, R);
  if (opening) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  push<NT>(Q, 3 * H, TB, c3.b, c3.e, C, rank);
  cluster_sync(C);  // q|k|v gathered

  // masked self-attention over slots 0..pos
  attend_part<NT, CacheT<T, KQ>, D, KQ == KvQ::kSrcCache>(
      Q, 3 * H, cache, c_row, c_pos, b0, nrows, pos + 1, H, heads, temp, Q + H, 3 * H, AT,
      KvScales{cache_scale, 2 * L, 2, 1}, p0, np, R);
  push<NT>(AT, 0, 1, p0 * D, (p0 + np) * D, C, rank);
  cluster_sync(C);  // self-attention gathered
  rowmm_part<NT, T>(AT, H, w(wt.w_out), H, w(wt.b_out), hb, he, P, H, false, H, R);
  push<NT>(P, H, TB, hb, he, C, rank);
  cluster_sync(C);  // out-proj gathered: LN1 reads every column
  add_ln<T>(P, X, H, w(wt.ln1_s), w(wt.ln1_b), O1);
  __syncthreads();

  // cross-attention over src K|V, no mask
  rowmm_part<NT, T>(O1, H, w(wt.w_q2), H, w(wt.b_q2), hb, he, Q2, H, false, H, R);
  push<NT>(Q2, H, TB, hb, he, C, rank);
  cluster_sync(C);  // cross query gathered
  attend_part<NT, SrcT<T, KQ>, D, KQ != KvQ::kNone>(
      Q2, H, src, S * 2 * H, 2 * H, b0, nrows, S, H, heads, temp, nullptr, 0, AT,
      KvScales{src_scale, 2 * S, 1, S}, p0, np, R);
  push<NT>(AT, 0, 1, p0 * D, (p0 + np) * D, C, rank);
  cluster_sync(C);  // cross-attention gathered
  rowmm_part<NT, T>(AT, H, w(wt.w_out2), H, w(wt.b_out2), hb, he, P, H, false, H, R);
  push<NT>(P, H, TB, hb, he, C, rank);
  cluster_sync(C);  // out2-proj gathered: LN2 reads every column
  add_ln<T>(P, O1, H, w(wt.ln2_s), w(wt.ln2_b), X);
  __syncthreads();

  // feed-forward, ReLU after both linears
  const Cols fc = rank_cols(F, C, rank);
  rowmm_part<NT, T>(X, H, w(wt.w_ff0), F, w(wt.b_ff0), fc.b, fc.e, FB, F, true, F, R);
  push<NT>(FB, F, TB, fc.b, fc.e, C, rank);
  cluster_sync(C);  // FF inner gathered
  rowmm_part<NT, T>(FB, F, w(wt.w_ff1), H, w(wt.b_ff1), hb, he, P, H, true, H, R);
  push<NT>(P, H, TB, hb, he, C, rank);
  cluster_sync(C);  // ff1 gathered: LN3 reads every column
  add_ln<T>(P, X, H, w(wt.ln3_s), w(wt.ln3_b), Q2);
  __syncthreads();

  // slot `pos` := the current k|v, or (reference parity) the output's,
  // Q2 @ w_qkv[:, H:] + b_qkv[H:]
  const Cols c2 = rank_cols(2 * H, C, rank);
  if (cache_outputs) {
    rowmm_part<NT, T>(Q2, H, w(wt.w_qkv) + H, 3 * H, w(wt.b_qkv) + H, c2.b, c2.e, Q + H,
                      3 * H, false, 2 * H, R);
    if constexpr (KQ == KvQ::kSrcCache) {  // the scales need every column
      push<NT>(Q + H, 3 * H, TB, c2.b, c2.e, C, rank);
      cluster_sync(C);  // the output's k|v gathered
    }
  }
  write_slot_part<NT, T, KQ>(Q + H, cache, cache_scale, R, c_row, c_pos, L, b0, nrows, H,
                             pos, c2.b, c2.e, rank);
}

}  // namespace
