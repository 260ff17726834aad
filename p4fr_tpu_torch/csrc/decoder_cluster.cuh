// Kernel 3's layer step as a thread-block cluster, also run once per layer
// by kernels 6 and 7 (csrc/fused_decode.cu, csrc/decoder_stack.cu) and,
// with the two-pass attention, by kernel 8 (csrc/decoder_layer_v1.cu): C
// CTAs (C in 1, 2, 4, 8, 16; the wrapper picks it,
// ops/decoder_layer.py::cluster_size) share one group of TB = 4 batch
// rows. The contract is decoder_common.cuh's
// (p4fr_tpu/decoding/fast_step.py::jnp_layer_step, the int8 forms KvQ):
// scores / sqrt(H), ReLU after both FF linears, LayerNorm eps 1e-5, slot
// `pos` written in place after the attention (kernel 8: before it, then
// read back; the output's k|v under cache_outputs), the int8 k-scale
// folded into the scores and the v-scale in after the mass.
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
//   shuffles, then the warps in shared memory. Splitting K across the
//   ranks instead would read whole 512-byte weight rows but exchange C
//   partial sums of every column over DSMEM, C times the bytes of the
//   column split's gather.
// - attention: the (row, head) pairs, rank r owning pairs [r*P/C,
//   (r+1)*P/C) of P = TB*heads; with fewer pairs than warps, the warps of
//   a pair split its positions in chunks (flash-decoding) and merge in
//   shared memory in split order, so the result does not depend on timing.
//   Two forms (Softmax): kernels 3, 6 and 7 walk the positions with an
//   online softmax (attend_part); kernel 8 keeps the TPU kernel's exact
//   two-pass softmax (attend_two_pass).
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
// barrier, which is therefore the exit barrier of kernels 3, 7 (after its
// last layer) and 8: no CTA leaves while a peer may still touch its shared
// memory (kernel 6 ends in a barrier of its own).
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
// src K|V) is unchanged for the launch. Slot `pos`, which it writes, the
// online form never reads; the two-pass form (kernel 8) reads it back
// after storing it, and the read-only path is not coherent with a store
// made earlier in the same launch, so that slot alone takes a volatile
// load (load_chunk). The compiler does not infer any of this through the
// DSMEM stores and cluster barriers, and the coherent path is slower.
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

// The online-softmax attention for this rank's pairs p0 .. p0+np-1 (pair
// p: row p / heads, head p % heads), flash-decode style: the positions
// held in memory go in chunks of 32; in a chunk each lane scores one
// position (q from shared memory, its key row as 16-byte loads), the
// chunk's max and sum update the running f32 softmax statistics, then each
// lane owns VPL = D / 32 adjacent head dims and accumulates the chunk's
// values, all 32 value loads issued before the first is used (latency, not
// bandwidth, bounds this loop). With `cur`, position n_pos-1 (= pos) is
// the current token: its key is at cur[r*cur_ld + h*D] and its value at
// cur[r*cur_ld + H + h*D] (shared memory), folded in last. Row b's
// position l of kv at b * row_stride + l * pos_stride (a batch-major
// [B, L, 2H] cache or the cross K|V: L * 2H and 2H; kernel 6's time-major
// [L, B, 2H] cache: 2H and B * 2H), keys at + h*D, values at + H + h*D;
// into this CTA's out [TB][H] at pair p's D values, out[p*D ..]. With np
// >= NT / 32 warps take whole pairs; otherwise each pair gets NT / 32 / np
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

// 16 bytes of K|V values -> f32: 4 f32 or 8 bf16 (the array's size)
__device__ __forceinline__ void unpack16(const uint4& t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x);
  v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z);
  v[3] = __uint_as_float(t.w);
}
__device__ __forceinline__ void unpack16(const uint4& t, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// A lane's U 16-byte pieces of positions l, l + PPI, ... (each clamped to
// `last`, an address that exists) at p + position * pos_stride, all issued
// before the first is used. WRITTEN (the chunk holds slot `pos`, which this
// launch stored before its attention): volatile loads, since the
// read-only path (__ldg, ld.global.nc) is not coherent with a store made
// earlier in the same launch; every other chunk takes the read-only path.
template <bool WRITTEN, int U, int PPI, typename T>
__device__ __forceinline__ void load_chunk(uint4 (&t)[U], const T* p, int l, int last,
                                           int pos_stride) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* a = p + static_cast<long long>(min(l + u * PPI, last)) * pos_stride;
    if constexpr (WRITTEN)
      asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(t[u].x), "=r"(t[u].y), "=r"(t[u].z), "=r"(t[u].w)
                   : "l"(__cvta_generic_to_global(a)) : "memory");
    else
      t[u] = __ldg(reinterpret_cast<const uint4*>(a));
  }
}

// The attention's form in layer_body_cluster: kernels 3, 6 and 7 walk the
// positions once with an online softmax (attend_part); kernel 8 keeps the
// TPU kernel's exact two-pass softmax (attend_two_pass), over slot `pos`
// stored into the cache first and read back.
enum class Softmax { kOnline, kTwoPass };

// The TPU kernel's attention (p4fr_tpu/ops/pallas/decoder_layer.py:96-117)
// for this rank's pairs p0 .. p0+np-1 (pair p: row p / heads, head p %
// heads), positions 0 .. n_pos-1 all read from kv (attend_part's strides),
// with no online rescaling: every score of the pair first, then their
// max, then exp(score - max) and their sum, then the values weighted by
// exp / sum (IEEE division, as the TPU kernel and the plain version
// normalise before the value product). Position `written` (slot `pos` of
// the self-attention, -1 for the cross K|V) was stored earlier in this
// launch and is read by a coherent load (load_chunk). Layout: a position's
// head row (D values of T) is read by LPK lanes, 16 bytes each, so one
// load a lane covers PPI = 32 / LPK positions with neighbouring lanes on
// neighbouring addresses; a chunk is U such loads a lane, all in flight
// before the first is used. With np >= NT / 32 warps take whole pairs;
// otherwise a pair gets wpp = NT / 32 / np warps, warp `split` of them
// taking the chunks split, split + wpp, ...: each scores its positions into
// the pair's row of `scores` (n_pos floats a pair in flight; sized by
// two_pass_smem_floats), and the max, the sum and the value partials merge
// in `stage` (smem, NT / 32 * (D + 2) floats) in split order, so the result
// does not depend on timing. Writes out[p*D ..] of this CTA's [TB][H];
// returns synchronised.
template <int NT, typename T, int D>
__device__ void attend_two_pass(const float* qbuf, int qld, const T* __restrict__ kv,
                                int row_stride, int pos_stride, int b0, int nrows,
                                int n_pos, int written, int H, int heads, float temp,
                                float* out, int p0, int np, float* stage, float* scores) {
  static_assert(D == 32 || D == 64, "heads of 32 or 64");
  constexpr int EPL = 16 / sizeof(T);  // values in a lane's 16-byte piece
  constexpr int LPK = D / EPL;         // lanes a position's head row
  constexpr int PPI = 32 / LPK;        // positions one load a lane covers
  constexpr int U = 8;                 // loads a lane has in flight
  constexpr int CH = PPI * U;          // positions a chunk
  constexpr int NW = NT / 32, SD = D + 2;  // SD: a split's max, sum, values
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / LPK, sub = lane % LPK;  // position in a load, piece
  const int wpp = np >= NW ? 1 : NW / max(np, 1);
  const int split = warp % wpp;

  // pass 1: this warp's scores into sc; returns their max (warp-reduced)
  auto score = [&](const float* q, const T* base, float* sc) {
    float qv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[e] = q[sub * EPL + e];
    const T* kp = base + sub * EPL;
    float m = -INFINITY;
    for (int l0 = CH * split; l0 < n_pos; l0 += CH * wpp) {
      uint4 t[U];
      if (l0 <= written && written < l0 + CH)
        load_chunk<true, U, PPI>(t, kp, l0 + g, n_pos - 1, pos_stride);
      else
        load_chunk<false, U, PPI>(t, kp, l0 + g, n_pos - 1, pos_stride);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[EPL];
        unpack16(t[u], kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[e], kf[e], dot);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int l = l0 + u * PPI + g;
        if (l < n_pos) {
          const float s = dot / temp;
          m = fmaxf(m, s);
          if (sub == 0) sc[l] = s;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    return m;
  };
  // pass 2: sc := exp(score - m) over this warp's positions; returns their
  // sum (warp-reduced in a fixed order)
  auto exps = [&](float m, float* sc) {
    float s = 0.f;
    for (int l0 = CH * split; l0 < n_pos; l0 += CH * wpp)
      for (int i = lane; i < CH; i += 32) {
        const int l = l0 + i;
        if (l < n_pos) {
          const float e = expf(sc[l] - m);
          sc[l] = e;
          s += e;
        }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  };
  // pass 3: acc[e] (head dim sub*EPL + e) := sum over this warp's positions
  // of exp / ssum times the value, the same in every lane of a piece
  auto values = [&](float ssum, const T* base, const float* sc, float (&acc)[EPL]) {
    const T* vp = base + H + sub * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
    for (int l0 = CH * split; l0 < n_pos; l0 += CH * wpp) {
      uint4 t[U];
      if (l0 <= written && written < l0 + CH)
        load_chunk<true, U, PPI>(t, vp, l0 + g, n_pos - 1, pos_stride);
      else
        load_chunk<false, U, PPI>(t, vp, l0 + g, n_pos - 1, pos_stride);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int l = l0 + u * PPI + g;
        const float e = sc[min(l, n_pos - 1)];
        const float p = l < n_pos ? e / ssum : 0.f;
        float vf[EPL];
        unpack16(t[u], vf);
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  };
  auto head_base = [&](int r, int h) {
    return kv + static_cast<long long>(b0 + r) * row_stride + h * D;
  };

  if (wpp == 1) {  // whole pairs, one warp each
    float* sc = scores + warp * n_pos;
    for (int pair = p0 + warp; pair < p0 + np; pair += NW) {
      const int r = pair / heads, h = pair % heads;
      if (r >= nrows) continue;
      const T* base = head_base(r, h);
      const float m = score(qbuf + r * qld + h * D, base, sc);
      __syncwarp();
      const float ssum = exps(m, sc);
      __syncwarp();
      float acc[EPL];
      values(ssum, base, sc, acc);
      if (g == 0)
#pragma unroll
        for (int e = 0; e < EPL; ++e) out[pair * D + sub * EPL + e] = acc[e];
      __syncwarp();  // the warp's next pair overwrites sc
    }
  } else {  // pair j by its wpp warps, merged in split order
    const int j = warp / wpp, pair = p0 + j, r = pair / heads, h = pair % heads;
    const bool active = j < np && r < nrows;
    float* sc = scores + j * n_pos;
    float* st = stage + warp * SD;
    const float* sp = stage + j * wpp * SD;  // the pair's splits
    const T* base = active ? head_base(r, h) : kv;
    if (active) {
      const float m = score(qbuf + r * qld + h * D, base, sc);
      if (lane == 0) st[0] = m;
    }
    __syncthreads();
    if (active) {
      float m = -INFINITY;
      for (int s = 0; s < wpp; ++s) m = fmaxf(m, sp[s * SD]);
      const float ssum = exps(m, sc);
      if (lane == 0) st[1] = ssum;
    }
    __syncthreads();
    if (active) {
      float ssum = 0.f;
      for (int s = 0; s < wpp; ++s) ssum += sp[s * SD + 1];
      float acc[EPL];
      values(ssum, base, sc, acc);
      if (g == 0)
#pragma unroll
        for (int e = 0; e < EPL; ++e) st[2 + sub * EPL + e] = acc[e];
    }
    __syncthreads();
    if (warp < np) {  // one warp a pair sums its splits' values
      const int pw = p0 + warp, rw = pw / heads;
      if (rw < nrows) {
        const float* sw = stage + warp * wpp * SD;
        for (int d = lane; d < D; d += 32) {
          float a = 0.f;
          for (int s = 0; s < wpp; ++s) a += sw[s * SD + 2 + d];
          out[pw * D + d] = a;
        }
      }
    }
  }
  __syncthreads();
}

// A cluster CTA's shared memory, every buffer [TB][width] f32: X the input
// (later out2), Q q|k|v (later the output's k|v), AT the attention output
// (self, then cross), P the projections (out, out2, ff1), O1 out1, Q2 the
// cross query (later the layer's output), FB the FF's inner activation, R
// rowmm_part's partial sums and the attention's stage (red_floats<NT>);
// kernel 8's scores follow R (two_pass_smem_floats).
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

// floats of a CTA of kernel 8 (the two-pass form): the body's, then the
// scores (attend_two_pass): n_pos = max(L, S) floats for each pair a rank
// has in flight, min(NT / 32, the most pairs a rank owns)
template <int NT>
size_t two_pass_smem_floats(int H, int F, int heads, int C, int n_pos) {
  const int most = (TB * heads + C - 1) / C;
  return cluster_smem_floats<NT>(H, F) +
         static_cast<size_t>(most < NT / 32 ? most : NT / 32) * n_pos;
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

// Each layer's weights inside the stacked [NL, ...] tensors of kernels 6
// and 7, worked out on the host: a __grid_constant__ parameter, so the
// body reads layer l's pointers from the constant bank as kernel 3 reads
// its own, and holds none in registers across the layer (computed in the
// kernel instead, kernel 6's step ran up to 5% slower at SwinTRN's width
// on an H100)
constexpr int MAX_NL = 16;  // the most decoder layers a launch takes
struct LayerTable {
  Weights w[MAX_NL];
};

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
// writes the output. SM: the attention's form. kTwoPass (kernel 8, no
// int8 operands) stores this rank's columns of the current k|v into slot
// `pos` right after its share of the q|k|v product, before the barrier
// that gathers q|k|v (its release arrive and acquire wait order the stores
// for the peers; at C = 1 __syncthreads does), reads slots 0..pos back in
// attend_two_pass, whose scores follow R in shared memory, and stores slot
// `pos` again at the end only under cache_outputs. Phases, each ending in
// the cluster barrier after its push (buffer written: what it reads):
//   qkv Q: X | self-attention AT: Q, cache | out-proj P: AT |
//   LN1 O1 (local), q2 Q2: O1 | cross-attention AT: Q2, src | out2 P: AT |
//   LN2 X (local), ff0 FB: X | ff1 P: FB | LN3 Q2 (local);
//   the output's k|v into Q+H (cache_outputs; pushed only for the int8
//   slot's scale), slot `pos`.
// The opening barrier (arrive before the qkv product, wait before its
// push) keeps a peer's first push out of a CTA that has not started, and,
// when layers are chained in one launch (kernels 6 and 7: `chained`, every
// layer after the first), out of Q while this CTA still reads the last layer's
// k|v there for its slot. The chained plan, layer l to layer l+1: after
// layer l's last barrier (LN3 gathered; with kSrcCache the output's k|v)
// no peer pushes in layer l again; each rank then reads Q2 and Q+H locally
// (the cache_outputs product and slot `pos`), refills X from Q2 and
// arrives, with release semantics, only after those reads; peers push
// layer l+1's q|k|v into Q only after the wait, so after every rank's
// arrival. X, which the refill writes, no peer ever pushes into.
template <int NT, typename T, int D, KvQ KQ, Softmax SM = Softmax::kOnline>
__device__ void layer_body_cluster(const ClusterSmem& s, const Weights& wt,
                                   CacheT<T, KQ>* __restrict__ cache, int c_row, int c_pos,
                                   float* __restrict__ cache_scale,
                                   const SrcT<T, KQ>* __restrict__ src,
                                   const float* __restrict__ src_scale, int b0, int nrows,
                                   int H, int heads, int F, int S, int L, int pos,
                                   int cache_outputs, int C, int rank, bool chained) {
  constexpr bool TWO_PASS = SM == Softmax::kTwoPass;
  static_assert(!TWO_PASS || KQ == KvQ::kNone, "the two-pass form takes no int8 operands");
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
  if constexpr (TWO_PASS)  // slot `pos` := this rank's k|v columns, before the gather
    write_slot_part<NT, T, KQ>(Q + H, cache, cache_scale, R, c_row, c_pos, L, b0, nrows, H,
                               pos, max(c3.b - H, 0), max(c3.e - H, 0), rank);
  if (opening) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  push<NT>(Q, 3 * H, TB, c3.b, c3.e, C, rank);
  cluster_sync(C);  // q|k|v gathered

  // masked self-attention over slots 0..pos
  float* const scores = R + red_floats<NT>();  // kernel 8's (two_pass_smem_floats)
  if constexpr (TWO_PASS)
    attend_two_pass<NT, T, D>(Q, 3 * H, cache, c_row, c_pos, b0, nrows, pos + 1, pos, H,
                              heads, temp, AT, p0, np, R, scores);
  else
    attend_part<NT, CacheT<T, KQ>, D, KQ == KvQ::kSrcCache>(
        Q, 3 * H, cache, c_row, c_pos, b0, nrows, pos + 1, H, heads, temp, Q + H, 3 * H,
        AT, KvScales{cache_scale, 2 * L, 2, 1}, p0, np, R);
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
  if constexpr (TWO_PASS)
    attend_two_pass<NT, T, D>(Q2, H, src, S * 2 * H, 2 * H, b0, nrows, S, -1, H, heads,
                              temp, AT, p0, np, R, scores);
  else
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
  if (!TWO_PASS || cache_outputs)  // the two-pass form stored the current k|v first
    write_slot_part<NT, T, KQ>(Q + H, cache, cache_scale, R, c_row, c_pos, L, b0, nrows, H,
                               pos, c2.b, c2.e, rank);
}

// One layer step over a batch-major [B, L, 2H] cache and [B, S, 2H] cross
// K|V for the row group of cluster blockIdx.x / C: kernel 3 (kOnline, each
// operand form; csrc/decoder_layer.cu) and kernel 8 (kTwoPass;
// csrc/decoder_layer_v1.cu, whose shared memory adds the scores). Each
// rank writes its columns of the output.
template <int NT, typename T, int D, KvQ KQ, Softmax SM>
__global__ void __launch_bounds__(NT, 512 / NT) layer_step_kernel(
    const T* __restrict__ x, CacheT<T, KQ>* __restrict__ cache,
    float* __restrict__ cache_scale, const SrcT<T, KQ>* __restrict__ src,
    const float* __restrict__ src_scale, T* __restrict__ out, Weights wt, int B,
    int H, int heads, int F, int S, int L, int pos, int cache_outputs, int C) {
  extern __shared__ __align__(16) float sm[];
  const ClusterSmem s = carve_cluster_smem(sm, H, F);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b0 = static_cast<int>(blockIdx.x) / C * TB;
  const int nrows = min(TB, B - b0);
  for (int i = threadIdx.x; i < TB * H; i += NT)
    s.X[i] = i / H < nrows ? to_f(__ldg(x + static_cast<long long>(b0) * H + i)) : 0.f;
  __syncthreads();
  layer_body_cluster<NT, T, D, KQ, SM>(s, wt, cache, L * 2 * H, 2 * H, cache_scale, src,
                                       src_scale, b0, nrows, H, heads, F, S, L, pos,
                                       cache_outputs, C, rank, false);
  // this rank's columns of the output
  const Cols hc = rank_cols(H, C, rank);
  const int n = hc.e - hc.b;
  for (int i = threadIdx.x; i < nrows * n; i += NT) {
    const int r = i / n, c = hc.b + i % n;
    out[static_cast<long long>(b0 + r) * H + c] = from_f<T>(s.Q2[r * H + c]);
  }
}

}  // namespace
