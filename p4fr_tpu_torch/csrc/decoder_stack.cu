// Every decoder layer of one autoregressive step in one launch (kernel 7,
// "v3").
//
// Replaces p4fr_tpu/ops/pallas/decoder_stack_v3.py::decoder_stack_step_v3
// (:279, kernel body _kernel). Per batch row:
//   for each of NL layers: kernel 3's layer step (decoder_common.cuh's
//     contract, the online softmax) over layer l's slab of the batch-major
//     stacked cache [NL, B, L, 2H] (slot `pos` written in place) and cross
//     K|V [NL, B, S, 2H]; x := its output rounded to the type, as the TPU
//     kernel's x_buf holds it between layers
//   out [B, H] := the last layer's output, in the type
// No embedding, no generator: those stay outside, as in
// p4fr_tpu/decoding/fast_step.py::make_v3_step. The TPU kernel's grid runs
// (batch tile, layer) in order on one core and carries x in VMEM scratch
// from layer to layer; here greedy rows are independent, so one cluster
// owns its rows from the first layer to the last and carries x in shared
// memory. Its kv_slots output and the dynamic_update_slice after it
// (:392-395) become a store of slot `pos` per layer: a cluster touches only
// its own rows, and the attention reads slots < pos, so no cluster reads
// what another writes.
//
// Bound on the card: the bytes (each layer's cache prefix and cross K|V
// from device memory; the weights, about 3 M values at SwinTRN's width,
// from L2 for each row group). At 4 rows a group every product is a GEMV,
// so a group's step is the time its SMs take to pull the weights through
// in sequence; at SwinTRN's B=32 (8 groups) one CTA a group left 124 of
// the 132 SMs idle.
//
// Design: kernel 6's layer loop without its embedding and generator. A
// thread-block cluster of C CTAs (1 to 16; the wrapper picks C from this
// kernel's own residency, ops/decoder_stack_v3.py) per group of TB = 4
// rows, 512 threads a CTA in a cluster, 256 (two CTAs an SM) at C = 1.
// Every layer runs decoder_cluster.cuh's layer_body_cluster: each rank
// computes 1/C of every product's columns and of the (row, head) attention
// pairs and pushes its slice into its peers' shared memory, one cluster
// barrier a phase; every rank holds every activation of the group. Between
// layers each rank rounds the output it already holds (Q2) into the next
// layer's input, locally, and the next layer opens with the body's release
// arrive (`chained`), which keeps a peer's q|k|v push out of Q while this
// rank still reads the last layer's k|v there for its slot. Each rank
// writes its columns of out from Q2. No DSMEM access follows the last
// layer's last cluster barrier, which is therefore the kernel's exit
// barrier: no CTA leaves while a peer may still push into it. The weights
// and the K|V load through the read-only path (__ldg): the launch writes
// only slot `pos` of each layer's cache, which it never reads.
#include <type_traits>

#include "decoder_cluster.cuh"

namespace {

template <int NT, typename T, int D>
__global__ void __launch_bounds__(NT, 512 / NT) decoder_stack_kernel(
    const T* __restrict__ x, T* __restrict__ caches, const T* __restrict__ src,
    T* __restrict__ out, const __grid_constant__ LayerTable layers, int B, int H,
    int heads, int F, int S, int L, int NL, int pos, int cache_outputs, int C) {
  extern __shared__ __align__(16) float sm[];
  const ClusterSmem s = carve_cluster_smem(sm, H, F);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b0 = static_cast<int>(blockIdx.x) / C * TB;
  const int nrows = min(TB, B - b0);
  for (int i = threadIdx.x; i < TB * H; i += NT)
    s.X[i] = i / H < nrows ? to_f(__ldg(x + static_cast<long long>(b0) * H + i)) : 0.f;

  const int slot = 2 * H;
  for (int l = 0; l < NL; ++l) {
    if (l > 0)  // layer l-1's output, rounded to the type
      for (int i = threadIdx.x; i < TB * H; i += NT)
        s.X[i] = i / H < nrows ? round_t<T>(s.Q2[i]) : 0.f;
    __syncthreads();
    // the batch-major cache: row stride L * 2H, position stride 2H
    layer_body_cluster<NT, T, D, KvQ::kNone>(
        s, layers.w[l], caches + static_cast<long long>(l) * B * L * slot, L * slot, slot,
        nullptr, src + static_cast<long long>(l) * B * S * slot, nullptr, b0, nrows, H,
        heads, F, S, L, pos, cache_outputs, C, rank, l > 0);
  }

  // this rank's columns of the output
  const Cols hc = rank_cols(H, C, rank);
  const int n = hc.e - hc.b;
  for (int i = threadIdx.x; i < nrows * n; i += NT) {
    const int r = i / n, c = hc.b + i % n;
    out[static_cast<long long>(b0 + r) * H + c] = from_f<T>(s.Q2[r * H + c]);
  }
}

template <int NT, typename T, int D>
int launch(const void* x, void* caches, const void* src, void* out,
           const StackedWeights& stacked, int B, int H, int heads, int F, int S, int L,
           int NL, int pos, int cache_outputs, int C, cudaStream_t stream) {
  LayerTable layers{};
  for (int l = 0; l < NL; ++l) layers.w[l] = layer_weights<T>(stacked, l, H, F);
  return launch_cluster<decoder_stack_kernel<NT, T, D>>(
      (B + TB - 1) / TB, C, NT, cluster_smem_floats<NT>(H, F) * sizeof(float), stream,
      static_cast<const T*>(x), static_cast<T*>(caches), static_cast<const T*>(src),
      static_cast<T*>(out), layers, B, H, heads, F, S, L, NL, pos, cache_outputs, C);
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
  if ((d != 32 && d != 64) || C < 1 || C > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto by_threads = [&](auto nt) {
    auto by_head = [&](auto t) {
      return d == 32 ? fn(nt, t, std::integral_constant<int, 32>{})
                     : fn(nt, t, std::integral_constant<int, 64>{});
    };
    return bf16 ? by_head(Type<__nv_bfloat16>{}) : by_head(Type<float>{});
  };
  return C == 1 ? by_threads(std::integral_constant<int, 256>{})
                : by_threads(std::integral_constant<int, 512>{});
}

}  // namespace

// x, caches and src in the weights' type (f32, or bf16 with bf16 != 0);
// `cluster` CTAs a group of 4 rows (the wrapper's C)
extern "C" int p4fr_decoder_stack_v3(
    const void* x, void* caches, const void* src, void* out,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1, const void* w_q2, const void* b_q2, const void* w_out2,
    const void* b_out2, const void* ln2, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3, int B, int H,
    int heads, int F, int S, int L, int NL, int pos, int cache_outputs,
    int cluster, int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || F % CPT || NL < 1 || NL > MAX_NL)
    return static_cast<int>(cudaErrorInvalidValue);
  const StackedWeights stacked{w_qkv, b_qkv, w_out, b_out, ln1, w_q2, b_q2, w_out2,
                               b_out2, ln2, w_ff0, b_ff0, w_ff1, b_ff1, ln3};
  return with_instance(bf16, d, cluster, [&](auto nt, auto t, auto head) {
    return launch<decltype(nt)::value, typename decltype(t)::type, decltype(head)::value>(
        x, caches, src, out, stacked, B, H, heads, F, S, L, NL, pos, cache_outputs,
        cluster, static_cast<cudaStream_t>(stream));
  });
}

// bf16, head width d, widths H and F, cluster size C -> clusters of C
// resident at once, and the instance's registers and local memory bytes a
// thread (kernel 7's own: its registers are its own)
extern "C" int p4fr_decoder_stack_v3_query(int bf16, int d, int H, int F, int C,
                                           int* clusters, int* regs, int* local) {
  return with_instance(bf16, d, C, [&](auto nt, auto t, auto head) {
    constexpr int NT = decltype(nt)::value;
    return query_cluster<decoder_stack_kernel<NT, typename decltype(t)::type,
                                              decltype(head)::value>>(
        C, NT, cluster_smem_floats<NT>(H, F) * sizeof(float), clusters, regs, local);
  });
}
