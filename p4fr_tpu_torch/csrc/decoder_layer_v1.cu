// One transformer-decoder layer's autoregressive step with the whole-prefix
// softmax (kernel 8, "v1").
//
// Replaces p4fr_tpu/ops/pallas/decoder_layer.py::decoder_layer_step (:198,
// kernel body _layer_kernel). Not kernel 3 (csrc/decoder_layer.cu, the v2
// TPU kernel's online softmax): the contract is the same, the attention's
// form is the TPU kernel's own. Per batch row, over a batch-major
// [B, L, 2H] cache:
//   q|k|v of the current token; k|v rounded to the cache type and stored
//     into slot `pos` (the TPU kernel's store_slot, :141)
//   self-attention over slots 0..pos read back from the cache, the exact
//     two-pass softmax (every score, their max, then the sum of exp(score
//     - max), then the values with the normalised probabilities;
//     decoder_layer.py:96-117); no online rescaling, so the form stays
//     distinct from kernel 3's; out-proj; LN1
//   cross-attention over src K|V in the same form; out-proj; LN2
//   FF, ReLU after both linears; LN3
//   with cache_outputs, slot `pos` := the output's k|v (:181-188)
// The TPU kernel also copies the whole cache block in and out of VMEM every
// step, the slowness its header names; here the cache stays in device
// memory and only slot `pos` of the group's rows is written, which gives
// the same cache.
//
// Design: kernel 3's cluster body (decoder_cluster.cuh's layer_step_kernel
// and layer_body_cluster) with its two-pass attention (Softmax::kTwoPass,
// attend_two_pass): a thread-block cluster of C CTAs (the caller's
// `cluster`, from kernel 8's own plan, ops/decoder_layer_v1.py) per group
// of TB = 4 rows, 512 threads a CTA in a cluster, 256 at C = 1. Each rank
// computes 1/C of every product's columns and stores its columns of slot
// `pos` right after the q|k|v product, before the cluster barrier that
// gathers q|k|v; the (row, head) pairs split across the ranks, a pair's
// positions across a rank's warps in chunks, 16-byte coalesced loads, the
// scores in shared memory, and the max, sum and values merged in split
// order. The trap: slot `pos` is read back in the launch that wrote it,
// so its loads take a volatile load, never the read-only path (__ldg,
// ld.global.nc), which is not coherent with that store; slots < pos and
// the src K|V take the read-only path, as in kernel 3.
//
// Bound on the card: the bytes, as kernel 3's (its rows' cache prefix and
// src K|V from device memory, the layer's weights streamed from L2 by each
// group, 1/C a CTA). The two-pass form reads a pair's keys in one pass and
// its values in a later one (each byte once, but two rounds of memory
// latency where the online form overlaps them), and its scores make three
// passes through shared memory. The scores take max(L, S) floats for
// each pair a rank has in flight (two_pass_smem_floats), so the wrapper
// refuses L or S above MAX_POSITIONS = 1024.
#include <type_traits>

#include "decoder_cluster.cuh"

namespace {

constexpr int MAX_POSITIONS = 1024;

template <typename T>
struct Type {
  using type = T;
};

template <int NT>
size_t smem_bytes(int H, int F, int heads, int C, int L, int S) {
  return two_pass_smem_floats<NT>(H, F, heads, C, L > S ? L : S) * sizeof(float);
}

// fn(threads, Type<T>, head width) for the instance by type, head width (32:
// EfficientSATRN, 64: SwinTRN) and threads a CTA (256 at C = 1, else 512)
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

// x, cache and src in the weights' type (f32, or bf16 with bf16 != 0);
// `cluster` CTAs a group of 4 rows
extern "C" int p4fr_decoder_layer_v1(
    const void* x, void* cache, const void* src, void* out,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1_s, const void* ln1_b, const void* w_q2, const void* b_q2,
    const void* w_out2, const void* b_out2, const void* ln2_s,
    const void* ln2_b, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3_s,
    const void* ln3_b, int B, int H, int heads, int F, int S, int L, int pos,
    int cache_outputs, int cluster, int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || F % CPT || L > MAX_POSITIONS || S > MAX_POSITIONS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights w{w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w_q2, b_q2, w_out2,
                  b_out2, ln2_s, ln2_b, w_ff0, b_ff0, w_ff1, b_ff1, ln3_s, ln3_b};
  return with_instance(bf16, d, cluster, [&](auto nt, auto t, auto head) {
    constexpr int NT = decltype(nt)::value;
    using T = typename decltype(t)::type;
    return launch_cluster<
        layer_step_kernel<NT, T, decltype(head)::value, KvQ::kNone, Softmax::kTwoPass>>(
        (B + TB - 1) / TB, cluster, NT, smem_bytes<NT>(H, F, heads, cluster, L, S),
        static_cast<cudaStream_t>(stream), static_cast<const T*>(x), static_cast<T*>(cache),
        static_cast<float*>(nullptr), static_cast<const T*>(src),
        static_cast<const float*>(nullptr), static_cast<T*>(out), w, B, H, heads, F, S, L,
        pos, cache_outputs, cluster);
  });
}

// bf16, head width d, widths H and F, n_pos = max(L, S), cluster size C ->
// clusters of C resident at once, and the instance's registers and local
// memory bytes a thread (kernel 8's own: its shared memory holds the
// scores beside kernel 3's buffers)
extern "C" int p4fr_decoder_layer_v1_query(int bf16, int d, int H, int F, int n_pos,
                                           int C, int* clusters, int* regs, int* local) {
  if (n_pos > MAX_POSITIONS) return static_cast<int>(cudaErrorInvalidValue);
  return with_instance(bf16, d, C, [&](auto nt, auto t, auto head) {
    constexpr int NT = decltype(nt)::value;
    return query_cluster<layer_step_kernel<NT, typename decltype(t)::type,
                                           decltype(head)::value, KvQ::kNone,
                                           Softmax::kTwoPass>>(
        C, NT, smem_bytes<NT>(H, F, H / d, C, n_pos, n_pos), clusters, regs, local);
  });
}
