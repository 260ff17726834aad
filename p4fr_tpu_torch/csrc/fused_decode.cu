// The whole greedy decode step in one launch.
//
// Replaces p4fr_tpu/ops/pallas/fused_decode.py::fused_greedy_step (:454,
// kernel body _kernel). Per batch row:
//   x = embed[token] + pe[pos], rounded to the compute type
//   for each of NL layers: kernel 3's layer step (decoder_common.cuh's
//     contract) over the time-major cache [NL, L, B, 2H] (slot `pos`
//     written in place) and the cross K|V [NL, B, S, 2H]; x := its output
//     rounded to the type, where kernel 3 chained NL times would round it
//   logits = x @ w_gen + b_gen over the padded vocabulary Vp (b_gen is f32
//     with NEG_INF on the pad lanes), written out in f32
//   the DecodingManager's ban on the logits: pad lanes (>= V); with the
//     manager also the always-ban table, `}` while the brackets balance,
//     the cannot-initial table after <SOS>, and the last token once its
//     run reaches its repeat limit (not after <SOS> or <EOS>; run >= limit
//     compared in f32); banned lanes become NEG_INF
//   the pick: the first index of the max
//   state (last, run, lbrackets, rbrackets) := (pick, pick == last ? run+1
//     : 1, + (pick == `{`), + (pick == `}`))
//
// Bound on the card: the bytes (the caches' prefixes and the cross K|V of
// every layer from device memory; the weights, about 3 M values at
// SwinTRN's width, from L2 for each row group). At 4 rows a group every
// product is a GEMV, so a group's step is the time one SM takes to pull
// the weights through in sequence; at SwinTRN's B=32 (8 groups) one CTA a
// group left 124 of the 132 SMs idle.
//
// Design: a thread-block cluster of C CTAs (1 to 16; the wrapper picks C,
// ops/fused_decode.py) per group of TB = 4 rows for the whole step, 512
// threads a CTA in a cluster, 256 (two CTAs an SM) at C = 1. Every layer
// runs decoder_cluster.cuh's layer_body_cluster, kernel 3's body: each
// rank computes 1/C of every product's columns and of the (row, head)
// attention pairs and pushes its slice into its peers' shared memory, one
// cluster barrier a phase; every rank holds every activation of the
// group. Between layers each rank rounds the output it already holds
// (Q2) into the next layer's input, locally. The generator splits Vp's
// columns across the ranks in groups of 8 (rank r owns an ascending run of
// lanes); each rank writes its logits, bans its lanes, takes the first
// index of its max per row and pushes (max, index) to rank 0, which after
// one cluster barrier merges them in rank order, a tie keeping the lower
// rank and so the lower lane, and writes the pick and the state. No DSMEM
// access follows that barrier, so no CTA leaves while a peer may still
// push into it. The weights, the K|V and the tables load through the
// read-only path (__ldg): the launch writes only slot `pos` of each cache,
// which it never reads.
#include <type_traits>

#include "decoder_cluster.cuh"

namespace {

constexpr float NEG_INF = -1e9f;
constexpr int MAX_C = 16;  // the largest cluster

// The tables of FusedDecodeParams (ops/fused_decode.py).
struct FusedParams {
  const void *embed, *pe, *w_gen;
  const float *b_gen, *man;
};

struct StepArgs {
  int B, H, heads, F, S, L, NL, Vp, pos, cache_outputs, use_manager, sos, eos,
      lbrace, rbrace, vocab;
};

// floats of a CTA's dynamic shared memory: the layer body's, then G
// [TB][Vp] (this rank's logits) and rank 0's [MAX_C][TB] maxima and their
// indices
template <int NT>
size_t fused_smem_floats(int H, int F, int Vp) {
  return cluster_smem_floats<NT>(H, F) + static_cast<size_t>(TB) * Vp + 2 * MAX_C * TB;
}

// X := the group's rows of `from` rounded to T (a layer's input), rows
// past nrows zero
template <int NT, typename T>
__device__ void round_rows(float* X, const float* from, int H, int nrows) {
  for (int i = threadIdx.x; i < TB * H; i += NT)
    X[i] = i / H < nrows ? round_t<T>(from[i]) : 0.f;
}

template <int NT, typename T, int D>
__global__ void __launch_bounds__(NT, 512 / NT) fused_greedy_kernel(
    const int* __restrict__ token, T* __restrict__ caches,
    const T* __restrict__ cross, const int* __restrict__ mstate,
    const __grid_constant__ LayerTable layers, FusedParams p, int* __restrict__ tok_out,
    int* __restrict__ mstate_out, float* __restrict__ logits, StepArgs a, int C) {
  extern __shared__ __align__(16) float sm[];
  const int H = a.H, F = a.F, Vp = a.Vp;
  const ClusterSmem s = carve_cluster_smem(sm, H, F);
  float* G = s.R + red_floats<NT>();
  float* best = G + TB * Vp;
  int* pick = reinterpret_cast<int*>(best + MAX_C * TB);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b0 = static_cast<int>(blockIdx.x) / C * TB;
  const int nrows = min(TB, a.B - b0);
  const T* embed = static_cast<const T*>(p.embed);
  const T* pe = static_cast<const T*>(p.pe) + static_cast<long long>(a.pos) * H;

  // embedding + positional encoding (a token outside the table embeds as
  // zeros, as the TPU kernel's one-hot product does)
  for (int i = threadIdx.x; i < TB * H; i += NT) {
    const int r = i / H, c = i % H;
    float v = 0.f;
    if (r < nrows) {
      const int tok = __ldg(token + b0 + r);
      const float e = tok >= 0 && tok < Vp
          ? to_f(__ldg(embed + static_cast<long long>(tok) * H + c)) : 0.f;
      v = round_t<T>(e + to_f(__ldg(pe + c)));
    }
    s.X[i] = v;
  }

  const int slot = 2 * H;
  for (int l = 0; l < a.NL; ++l) {
    if (l > 0) round_rows<NT, T>(s.X, s.Q2, H, nrows);  // layer l-1's output
    __syncthreads();
    // the time-major cache: row stride 2H, position stride B * 2H
    layer_body_cluster<NT, T, D, KvQ::kNone>(
        s, layers.w[l], caches + static_cast<long long>(l) * a.L * a.B * slot,
        slot, a.B * slot, nullptr,
        cross + static_cast<long long>(l) * a.B * a.S * slot, nullptr, b0, nrows, H,
        a.heads, F, a.S, a.L, a.pos, a.cache_outputs, C, rank, l > 0);
  }

  // the generator over this rank's lanes of the padded vocabulary
  round_rows<NT, T>(s.X, s.Q2, H, nrows);
  __syncthreads();
  const Cols g = rank_cols(Vp, C, rank);
  const T* w_gen = static_cast<const T*>(p.w_gen);
  rowmm_part<NT, T, float>(s.X, H, w_gen, Vp, p.b_gen, g.b, g.e, G, Vp, false, Vp, s.R);
  const int n = g.e - g.b;
  for (int i = threadIdx.x; i < nrows * n; i += NT) {
    const int r = i / n, v = g.b + i % n;
    logits[static_cast<long long>(b0 + r) * Vp + v] = G[r * Vp + v];
  }

  // the manager's ban and the first index of the max over this rank's
  // lanes, one warp a row, pushed to rank 0's [rank][row]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nrows) {
    const int r = warp;
    const int* st = mstate + 4LL * (b0 + r);
    const int last = __ldg(st), run = __ldg(st + 1), lb = __ldg(st + 2),
              rb = __ldg(st + 3);
    const bool is_sos = last == a.sos, is_eos = last == a.eos;
    const float limit = last >= 0 && last < Vp ? __ldg(p.man + 2 * Vp + last) : 0.f;
    const bool over = !is_sos && !is_eos && static_cast<float>(run) >= limit;
    const bool balanced = lb == rb;
    float bst = -INFINITY;
    int pk = Vp;
    for (int v = g.b + lane; v < g.e; v += 32) {  // ascending: ties keep the first
      bool ban = v >= a.vocab;
      if (a.use_manager)
        ban = ban || __ldg(p.man + v) > 0.5f || (balanced && v == a.rbrace) ||
              (is_sos && __ldg(p.man + Vp + v) > 0.5f) || (over && v == last);
      const float x = ban ? NEG_INF : G[r * Vp + v];
      if (x > bst) { bst = x; pk = v; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, bst, o);
      const int oi = __shfl_xor_sync(0xffffffffu, pk, o);
      if (ob > bst || (ob == bst && oi < pk)) { bst = ob; pk = oi; }
    }
    if (lane == 0) {
      float* bd = best + rank * TB + r;
      int* pd = pick + rank * TB + r;
      if (C > 1) {
        cg::cluster_group cl = cg::this_cluster();
        *cl.map_shared_rank(bd, 0) = bst;
        *cl.map_shared_rank(pd, 0) = pk;
      } else {
        *bd = bst;
        *pd = pk;
      }
    }
  }
  cluster_sync(C);  // every rank's (max, index) at rank 0; the exit barrier
  if (rank != 0 || warp >= nrows || lane != 0) return;
  const int r = warp;
  float bst = best[r];
  int pk = pick[r];
  for (int q = 1; q < C; ++q)  // rank order: a tie keeps the lower rank's lane
    if (best[q * TB + r] > bst) { bst = best[q * TB + r]; pk = pick[q * TB + r]; }
  const int* st = mstate + 4LL * (b0 + r);
  const int last = __ldg(st);
  int* so = mstate_out + 4LL * (b0 + r);
  tok_out[b0 + r] = pk;
  so[0] = pk;
  so[1] = pk == last ? __ldg(st + 1) + 1 : 1;
  so[2] = __ldg(st + 2) + (pk == a.lbrace);
  so[3] = __ldg(st + 3) + (pk == a.rbrace);
}

template <int NT, typename T, int D>
int launch(const void* token, void* caches, const void* cross, const void* mstate,
           const StackedWeights& stacked, const FusedParams& p, void* tok_out,
           void* mstate_out, void* logits, const StepArgs& a, int C, cudaStream_t stream) {
  LayerTable layers{};
  for (int l = 0; l < a.NL; ++l) layers.w[l] = layer_weights<T>(stacked, l, a.H, a.F);
  return launch_cluster<fused_greedy_kernel<NT, T, D>>(
      (a.B + TB - 1) / TB, C, NT, fused_smem_floats<NT>(a.H, a.F, a.Vp) * sizeof(float),
      stream, static_cast<const int*>(token), static_cast<T*>(caches),
      static_cast<const T*>(cross), static_cast<const int*>(mstate), layers, p,
      static_cast<int*>(tok_out), static_cast<int*>(mstate_out),
      static_cast<float*>(logits), a, C);
}

template <typename T>
struct Type {
  using type = T;
};

// fn(threads, Type<T>, head width) for the instance by type, head width
// (32: EfficientSATRN, 64: SwinTRN) and threads a CTA (256 at C = 1, else
// 512)
template <typename Fn>
int with_instance(int bf16, int d, int C, Fn&& fn) {
  if ((d != 32 && d != 64) || C < 1 || C > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  auto by_type = [&](auto nt) {
    auto by_head = [&](auto t) {
      using T = typename decltype(t)::type;
      return d == 32 ? fn(nt, t, std::integral_constant<int, 32>{})
                     : fn(nt, t, std::integral_constant<int, 64>{});
    };
    return bf16 ? by_head(Type<__nv_bfloat16>{})
                : by_head(Type<float>{});
  };
  return C == 1 ? by_type(std::integral_constant<int, 256>{})
                : by_type(std::integral_constant<int, 512>{});
}

}  // namespace

// `cluster` CTAs a group of 4 rows (the wrapper's C)
extern "C" int p4fr_fused_greedy_step(
    const void* token, void* caches, const void* cross, const void* mstate,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1, const void* w_q2, const void* b_q2, const void* w_out2,
    const void* b_out2, const void* ln2, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3, const void* embed,
    const void* pe, const void* w_gen, const void* b_gen, const void* man,
    void* tok_out, void* mstate_out, void* logits, int B, int H, int heads,
    int F, int S, int L, int NL, int Vp, int pos, int cache_outputs,
    int use_manager, int sos, int eos, int lbrace, int rbrace, int vocab,
    int cluster, int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || F % CPT || Vp % CPT || Vp < 32 || NL < 1 || NL > MAX_NL)
    return static_cast<int>(cudaErrorInvalidValue);
  const StackedWeights stacked{w_qkv, b_qkv, w_out, b_out, ln1, w_q2, b_q2, w_out2,
                               b_out2, ln2, w_ff0, b_ff0, w_ff1, b_ff1, ln3};
  FusedParams p{embed, pe, w_gen, static_cast<const float*>(b_gen),
                static_cast<const float*>(man)};
  StepArgs a{B, H, heads, F, S, L, NL, Vp, pos, cache_outputs, use_manager,
             sos, eos, lbrace, rbrace, vocab};
  return with_instance(bf16, d, cluster, [&](auto nt, auto t, auto head) {
    return launch<decltype(nt)::value, typename decltype(t)::type, decltype(head)::value>(
        token, caches, cross, mstate, stacked, p, tok_out, mstate_out, logits, a, cluster,
        static_cast<cudaStream_t>(stream));
  });
}

// bf16, head width d, widths H, F and Vp, cluster size C -> clusters of C
// resident at once, and the instance's registers and local memory bytes a
// thread
extern "C" int p4fr_fused_greedy_query(int bf16, int d, int H, int F, int Vp, int C,
                                       int* clusters, int* regs, int* local) {
  return with_instance(bf16, d, C, [&](auto nt, auto t, auto head) {
    constexpr int NT = decltype(nt)::value;
    return query_cluster<fused_greedy_kernel<NT, typename decltype(t)::type,
                                             decltype(head)::value>>(
        C, NT, fused_smem_floats<NT>(H, F, Vp) * sizeof(float), clusters, regs, local);
  });
}
