// The whole greedy decode step in one launch.
//
// Replaces p4fr_tpu/ops/pallas/fused_decode.py::fused_greedy_step (:454,
// kernel body _kernel). Per batch row, in one CTA:
//   x = embed[token] + pe[pos], rounded to the compute type
//   for each of NL layers: decoder_common.cuh's layer_body and write_slot
//     over the time-major cache [NL, L, B, 2H] (slot `pos` written in
//     place) and the cross K|V [NL, B, S, 2H]; x := its output rounded to
//     the type, where kernel 3 chained NL times would round it
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
// Every greedy row is independent of every other row, so one CTA owns its
// TB rows for the whole step and nothing crosses CTAs.
//
// Bound on the card: the bytes (the caches' prefixes and the cross K|V of
// every layer from device memory; the weights, about 3 M values, from L2
// for each CTA). The design runs kernel 3's body NL times with every
// activation in shared memory, so the step costs one launch instead of NL
// launches and ~40 small ops, and the host issues one call per step. With
// TB = 4 a B=256 step fills 64 of the 132 SMs: more CTAs per batch (fewer
// rows each, or the layers' products split across a cluster) is later work.
#include <type_traits>

#include "decoder_common.cuh"

namespace {

constexpr float NEG_INF = -1e9f;

// The stacked [NL, ...] weights of FusedDecodeParams (ops/fused_decode.py).
struct FusedParams {
  const void *w_qkv, *b_qkv, *w_out, *b_out, *ln1, *w_q2, *b_q2, *w_out2,
      *b_out2, *ln2, *w_ff0, *b_ff0, *w_ff1, *b_ff1, *ln3, *embed, *pe,
      *w_gen;
  const float *b_gen, *man;
};

struct StepArgs {
  int B, H, heads, F, S, L, NL, Vp, pos, cache_outputs, use_manager, sos, eos,
      lbrace, rbrace, vocab;
};

// layer l's weights inside the stacked tensors
template <typename T>
__device__ Weights layer_weights(const FusedParams& p, int l, int H, int F) {
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) fused_greedy_kernel(
    const int* __restrict__ token, T* __restrict__ caches,
    const T* __restrict__ cross, const int* __restrict__ mstate,
    FusedParams p, int* __restrict__ tok_out, int* __restrict__ mstate_out,
    float* __restrict__ logits, StepArgs a) {
  extern __shared__ float sm[];
  const int H = a.H, F = a.F, Vp = a.Vp;
  const LayerSmem s = carve_layer_smem(sm, H, F);
  float* G = s.R + RED_FLOATS;  // [TB][Vp] logits
  const int b0 = blockIdx.x * TB;
  const int nrows = min(TB, a.B - b0);
  const T* embed = static_cast<const T*>(p.embed);
  const T* pe = static_cast<const T*>(p.pe) + static_cast<long long>(a.pos) * H;

  // embedding + positional encoding (a token outside the table embeds as
  // zeros, as the TPU kernel's one-hot product does)
  for (int i = threadIdx.x; i < TB * H; i += NT) {
    const int r = i / H, c = i % H;
    float v = 0.f;
    if (r < nrows) {
      const int tok = token[b0 + r];
      const float e = tok >= 0 && tok < Vp
          ? to_f(embed[static_cast<long long>(tok) * H + c]) : 0.f;
      v = round_t<T>(e + to_f(pe[c]));
    }
    s.A[i] = v;
  }
  __syncthreads();

  const int slot = 2 * H;
  for (int l = 0; l < a.NL; ++l) {
    const Weights w = layer_weights<T>(p, l, H, F);
    T* cache = caches + static_cast<long long>(l) * a.L * a.B * slot;
    layer_body<T, false, D>(s, w, cache, slot, a.B * slot,
                         cross + static_cast<long long>(l) * a.B * a.S * slot,
                         a.S * slot, b0, nrows, H, a.heads, F, a.S, a.pos);
    write_slot<T, false>(s, w, cache, slot, a.B * slot, b0, nrows, H, a.pos,
                         a.cache_outputs);
    for (int i = threadIdx.x; i < TB * H; i += NT) s.A[i] = round_t<T>(s.Dd[i]);
    __syncthreads();
  }

  // generator over the padded vocabulary (rowmm ends synchronised)
  rowmm<T, float>(s.A, H, static_cast<const T*>(p.w_gen), Vp, p.b_gen, Vp, G,
                  Vp, false, s.R);
  for (int i = threadIdx.x; i < nrows * Vp; i += NT)
    logits[static_cast<long long>(b0) * Vp + i] = G[i];

  // manager ban + first index of the max, one warp per row
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  if (r >= nrows) return;
  const int* st = mstate + 4LL * (b0 + r);
  const int last = st[0], run = st[1], lb = st[2], rb = st[3];
  const bool is_sos = last == a.sos, is_eos = last == a.eos;
  const float limit = last >= 0 && last < Vp ? p.man[2 * Vp + last] : 0.f;
  const bool over = !is_sos && !is_eos && static_cast<float>(run) >= limit;
  const bool balanced = lb == rb;
  float best = -INFINITY;
  int pick = Vp;
  for (int v = lane; v < Vp; v += 32) {  // ascending: ties keep the first
    bool ban = v >= a.vocab;
    if (a.use_manager)
      ban = ban || p.man[v] > 0.5f || (balanced && v == a.rbrace) ||
            (is_sos && p.man[Vp + v] > 0.5f) || (over && v == last);
    const float x = ban ? NEG_INF : G[r * Vp + v];
    if (x > best) { best = x; pick = v; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, pick, o);
    if (ob > best || (ob == best && oi < pick)) { best = ob; pick = oi; }
  }
  if (lane == 0) {
    int* so = mstate_out + 4LL * (b0 + r);
    tok_out[b0 + r] = pick;
    so[0] = pick;
    so[1] = pick == last ? run + 1 : 1;
    so[2] = lb + (pick == a.lbrace);
    so[3] = rb + (pick == a.rbrace);
  }
}

template <typename T, int D>
int launch(const void* token, void* caches, const void* cross,
           const void* mstate, const FusedParams& p, void* tok_out,
           void* mstate_out, void* logits, const StepArgs& a,
           cudaStream_t stream) {
  size_t smem = (layer_smem_floats(a.H, a.F) + static_cast<size_t>(TB) * a.Vp)
                * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fused_greedy_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.B + TB - 1) / TB);
  fused_greedy_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const int*>(token), static_cast<T*>(caches),
      static_cast<const T*>(cross), static_cast<const int*>(mstate), p,
      static_cast<int*>(tok_out), static_cast<int*>(mstate_out),
      static_cast<float*>(logits), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
    int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || (d != 32 && d != 64) || F % CPT || Vp % CPT || Vp < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedParams p{w_qkv, b_qkv, w_out, b_out, ln1, w_q2, b_q2, w_out2, b_out2,
                ln2, w_ff0, b_ff0, w_ff1, b_ff1, ln3, embed, pe, w_gen,
                static_cast<const float*>(b_gen), static_cast<const float*>(man)};
  StepArgs a{B, H, heads, F, S, L, NL, Vp, pos, cache_outputs, use_manager,
             sos, eos, lbrace, rbrace, vocab};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance by head width: 32 (EfficientSATRN), 64 (SwinTRN)
  auto run = [&](auto head) {
    constexpr int D = decltype(head)::value;
    if (bf16)
      return launch<__nv_bfloat16, D>(token, caches, cross, mstate, p, tok_out,
                                      mstate_out, logits, a, s);
    return launch<float, D>(token, caches, cross, mstate, p, tok_out,
                            mstate_out, logits, a, s);
  };
  return d == 32 ? run(std::integral_constant<int, 32>{})
                 : run(std::integral_constant<int, 64>{});
}
