// One transformer-decoder layer's autoregressive step over a packed KV cache.
//
// Replaces p4fr_tpu/ops/pallas/decoder_layer_v2.py::decoder_layer_step_v2
// (kernel body _kernel); contract: decoder_common.cuh. One launch a layer
// step over a batch-major [B, L, 2H] cache, instanced for f32 and bf16 and
// for heads of 32 and of 64. The TPU kernel's int8 operand forms
// (src_scale; the int8 cache) are instanced too: one entry point each,
// p4fr_decoder_layer_int8 (int8 cross K|V) and p4fr_decoder_layer_int8_cache
// (and the int8 self cache), the same body with other operand loads
// (decoder_common.cuh's KvQ).
//
// Design: decoder_cluster.cuh's layer_body_cluster, a thread-block cluster
// of C CTAs (the caller's `cluster`, 1 to 16) per group of TB = 4 rows,
// launched with cudaLaunchKernelEx: 512 threads a CTA in a cluster, 256
// (two CTAs an SM) at C = 1. Bound on the card: at 4 rows a product is a
// GEMV, so a group's time is the bytes of the layer's weights that one SM
// pulls from L2 (plus its rows' cache prefix and src K|V from device
// memory), paid in memory latency; C CTAs a group pull 1/C each, and every
// loop issues its loads in batches before using them.
#include <type_traits>

#include "decoder_cluster.cuh"

namespace {

template <int NT, typename T, int D, KvQ KQ>
int launch(const void* x, void* cache, void* cache_scale, const void* src,
           const void* src_scale, void* out, const Weights& w, int B, int H,
           int heads, int F, int S, int L, int pos, int cache_outputs, int C,
           cudaStream_t stream) {
  return launch_cluster<layer_step_kernel<NT, T, D, KQ, Softmax::kOnline>>(
      (B + TB - 1) / TB, C, NT, cluster_smem_floats<NT>(H, F) * sizeof(float), stream,
      static_cast<const T*>(x), static_cast<CacheT<T, KQ>*>(cache),
      static_cast<float*>(cache_scale), static_cast<const SrcT<T, KQ>*>(src),
      static_cast<const float*>(src_scale), static_cast<T*>(out), w, B, H, heads, F, S, L,
      pos, cache_outputs, C);
}

// What the wrapper picks C from, for one instance at widths H, F: the
// clusters of C that can be resident at once, and the instance's
// registers and local memory a thread.
template <int NT, typename T, int D, KvQ KQ>
int query(int H, int F, int C, int* clusters, int* regs, int* local) {
  return query_cluster<layer_step_kernel<NT, T, D, KQ, Softmax::kOnline>>(
      C, NT, cluster_smem_floats<NT>(H, F) * sizeof(float), clusters, regs, local);
}

template <typename T, int DD, KvQ Q>
struct Instance {
  using type = T;
  static constexpr int D = DD;
  static constexpr KvQ KQ = Q;
};

// fn(Instance<...>{}) for the instance by operand form, type and head
// width: 32 (EfficientSATRN), 64 (SwinTRN)
template <KvQ KQ, typename Fn>
int with_instance(int bf16, int d, Fn&& fn) {
  if (d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return d == 32 ? fn(Instance<__nv_bfloat16, 32, KQ>{})
                   : fn(Instance<__nv_bfloat16, 64, KQ>{});
  return d == 32 ? fn(Instance<float, 32, KQ>{}) : fn(Instance<float, 64, KQ>{});
}

template <KvQ KQ>
int dispatch(const void* x, void* cache, void* cache_scale, const void* src,
             const void* src_scale, void* out, const Weights& w, int B, int H,
             int heads, int F, int S, int L, int pos, int cache_outputs, int C,
             int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || F % CPT || C < 1 || C > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_instance<KQ>(bf16, d, [&](auto inst) {
    using I = decltype(inst);
    auto run = [&](auto nt) {
      return launch<decltype(nt)::value, typename I::type, I::D, I::KQ>(
          x, cache, cache_scale, src, src_scale, out, w, B, H, heads, F, S, L, pos,
          cache_outputs, C, static_cast<cudaStream_t>(stream));
    };
    return C == 1 ? run(std::integral_constant<int, 256>{})
                  : run(std::integral_constant<int, 512>{});
  });
}

}  // namespace

#define P4FR_LAYER_WEIGHTS                                                     \
  const void *w_qkv, const void *b_qkv, const void *w_out, const void *b_out, \
      const void *ln1_s, const void *ln1_b, const void *w_q2,                  \
      const void *b_q2, const void *w_out2, const void *b_out2,                \
      const void *ln2_s, const void *ln2_b, const void *w_ff0,                 \
      const void *b_ff0, const void *w_ff1, const void *b_ff1,                 \
      const void *ln3_s, const void *ln3_b
#define P4FR_WEIGHTS_STRUCT                                                     \
  Weights{w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w_q2, b_q2, w_out2,       \
          b_out2, ln2_s, ln2_b, w_ff0, b_ff0, w_ff1, b_ff1, ln3_s, ln3_b}

// x, cache and src in the weights' type (f32, or bf16 with bf16 != 0);
// `cluster` CTAs a group of 4 rows
extern "C" int p4fr_decoder_layer(
    const void* x, void* cache, const void* src, void* out, P4FR_LAYER_WEIGHTS,
    int B, int H, int heads, int F, int S, int L, int pos, int cache_outputs,
    int cluster, int bf16, void* stream) {
  return dispatch<KvQ::kNone>(x, cache, nullptr, src, nullptr, out,
                              P4FR_WEIGHTS_STRUCT, B, H, heads, F, S, L, pos,
                              cache_outputs, cluster, bf16, stream);
}

// src int8 [B, S, 2H] with f32 src_scale [B, 2, S]; the cache in the
// weights' type
extern "C" int p4fr_decoder_layer_int8(
    const void* x, void* cache, const void* src, const void* src_scale,
    void* out, P4FR_LAYER_WEIGHTS, int B, int H, int heads, int F, int S,
    int L, int pos, int cache_outputs, int cluster, int bf16, void* stream) {
  return dispatch<KvQ::kSrc>(x, cache, nullptr, src, src_scale, out,
                             P4FR_WEIGHTS_STRUCT, B, H, heads, F, S, L, pos,
                             cache_outputs, cluster, bf16, stream);
}

// src as above, and the cache int8 [B, L, 2H] with f32 cache_scale [B, L, 2]
extern "C" int p4fr_decoder_layer_int8_cache(
    const void* x, void* cache, void* cache_scale, const void* src,
    const void* src_scale, void* out, P4FR_LAYER_WEIGHTS, int B, int H,
    int heads, int F, int S, int L, int pos, int cache_outputs, int cluster,
    int bf16, void* stream) {
  return dispatch<KvQ::kSrcCache>(x, cache, cache_scale, src, src_scale, out,
                                  P4FR_WEIGHTS_STRUCT, B, H, heads, F, S, L, pos,
                                  cache_outputs, cluster, bf16, stream);
}

// form 0, 1, 2 (p4fr_decoder_layer, _int8, _int8_cache), bf16, head width
// d, widths H and F, cluster size C -> clusters of C resident at once, and
// the instance's registers and local memory bytes a thread
extern "C" int p4fr_decoder_layer_query(int form, int bf16, int d, int H, int F,
                                        int C, int* clusters, int* regs, int* local) {
  auto fn = [&](auto inst) {
    using I = decltype(inst);
    return C == 1 ? query<256, typename I::type, I::D, I::KQ>(H, F, C, clusters, regs, local)
                  : query<512, typename I::type, I::D, I::KQ>(H, F, C, clusters, regs, local);
  };
  if (C < 1 || C > 16) return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case 0: return with_instance<KvQ::kNone>(bf16, d, fn);
    case 1: return with_instance<KvQ::kSrc>(bf16, d, fn);
    case 2: return with_instance<KvQ::kSrcCache>(bf16, d, fn);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
