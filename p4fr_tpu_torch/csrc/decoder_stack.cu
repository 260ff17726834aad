// Every decoder layer of one autoregressive step in one launch (kernel 7,
// "v3").
//
// Replaces p4fr_tpu/ops/pallas/decoder_stack_v3.py::decoder_stack_step_v3
// (:279, kernel body _kernel). Per batch row, in one CTA:
//   for each of NL layers: decoder_common.cuh's layer_body (kernel 3's
//     online form) over layer l's slab of the batch-major stacked cache
//     [NL, B, L, 2H] and cross K|V [NL, B, S, 2H], and write_slot (slot
//     `pos` of layer l written in place); x := its output rounded to the
//     type, as the TPU kernel's x_buf holds it between layers
//   out [B, H] := the last layer's output, in the type
// No embedding, no generator: those stay outside, as in
// p4fr_tpu/decoding/fast_step.py::make_v3_step. The TPU kernel's grid runs
// (batch tile, layer) in order on one core and carries x in VMEM scratch
// from layer to layer; here greedy rows are independent, so one CTA owns
// its TB rows from the first layer to the last and carries x in shared
// memory, and nothing crosses CTAs. Its kv_slots output and the
// dynamic_update_slice after it (:392-395) become a store of slot `pos` per
// layer: each CTA touches only its own rows, and the attention reads slots
// < pos, so no CTA reads what another writes.
//
// Bound on the card: the bytes (each layer's cache prefix and cross K|V
// from device memory, the layers' weights, about 3 M values, from L2 for
// each CTA); one launch takes the place of NL kernel-3 launches and the
// host's work between them.
#include <type_traits>

#include "decoder_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT) decoder_stack_kernel(
    const T* __restrict__ x, T* __restrict__ caches, const T* __restrict__ src,
    T* __restrict__ out, StackedWeights p, int B, int H, int heads, int F,
    int S, int L, int NL, int pos, int cache_outputs) {
  extern __shared__ float sm[];
  const LayerSmem s = carve_layer_smem(sm, H, F);
  const int b0 = blockIdx.x * TB;
  const int nrows = min(TB, B - b0);

  for (int i = threadIdx.x; i < TB * H; i += NT) {
    int r = i / H;
    s.A[i] = r < nrows ? to_f(x[static_cast<long long>(b0) * H + i]) : 0.f;
  }
  __syncthreads();

  const int slot = 2 * H;
  for (int l = 0; l < NL; ++l) {
    const Weights w = layer_weights<T>(p, l, H, F);
    T* cache = caches + static_cast<long long>(l) * B * L * slot;
    layer_body<T, D>(s, w, cache, L, src + static_cast<long long>(l) * B * S * slot, b0,
                     nrows, H, heads, F, S, pos);
    write_slot<T>(s, w, cache, L, b0, nrows, H, pos, cache_outputs);
    for (int i = threadIdx.x; i < TB * H; i += NT) s.A[i] = round_t<T>(s.Dd[i]);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nrows * H; i += NT)
    out[static_cast<long long>(b0) * H + i] = from_f<T>(s.A[i]);
}

template <typename T, int D>
int launch(const void* x, void* caches, const void* src, void* out,
           const StackedWeights& p, int B, int H, int heads, int F, int S,
           int L, int NL, int pos, int cache_outputs, cudaStream_t stream) {
  size_t smem = layer_smem_floats(H, F) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decoder_stack_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + TB - 1) / TB);
  decoder_stack_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(caches),
      static_cast<const T*>(src), static_cast<T*>(out), p, B, H, heads, F, S,
      L, NL, pos, cache_outputs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p4fr_decoder_stack_v3(
    const void* x, void* caches, const void* src, void* out,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1, const void* w_q2, const void* b_q2, const void* w_out2,
    const void* b_out2, const void* ln2, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3, int B, int H,
    int heads, int F, int S, int L, int NL, int pos, int cache_outputs,
    int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || (d != 32 && d != 64) || F % CPT || NL < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  StackedWeights p{w_qkv, b_qkv, w_out, b_out, ln1, w_q2, b_q2, w_out2,
                   b_out2, ln2, w_ff0, b_ff0, w_ff1, b_ff1, ln3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance by head width: 32 (EfficientSATRN), 64 (SwinTRN)
  auto run = [&](auto head) {
    constexpr int D = decltype(head)::value;
    if (bf16)
      return launch<__nv_bfloat16, D>(x, caches, src, out, p, B, H, heads, F,
                                      S, L, NL, pos, cache_outputs, s);
    return launch<float, D>(x, caches, src, out, p, B, H, heads, F, S, L, NL,
                            pos, cache_outputs, s);
  };
  return d == 32 ? run(std::integral_constant<int, 32>{})
                 : run(std::integral_constant<int, 64>{});
}
