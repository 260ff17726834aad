// One transformer-decoder layer's autoregressive step over a packed KV cache.
//
// Replaces p4fr_tpu/ops/pallas/decoder_layer_v2.py::decoder_layer_step_v2
// (kernel body _kernel); contract and design: decoder_common.cuh, whose
// layer_body and write_slot this kernel runs once over a batch-major
// [B, L, 2H] cache, instanced for heads of 32 and of 64.
//
// Bound on the card: each CTA streams the layer's weights (about 1 M
// values) from L2 once for its TB rows and its rows' cache prefix and src
// K/V from device memory; with one CTA per SM, memory LATENCY is what
// limits it, so every loop issues its loads in batches before using them.
#include <type_traits>

#include "decoder_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT) decoder_layer_kernel(
    const T* __restrict__ x, T* __restrict__ cache, const T* __restrict__ src,
    T* __restrict__ out, Weights wt, int B, int H, int heads, int F, int S,
    int L, int pos, int cache_outputs) {
  extern __shared__ float sm[];
  const LayerSmem s = carve_layer_smem(sm, H, F);
  const int b0 = blockIdx.x * TB;
  const int nrows = min(TB, B - b0);

  for (int i = threadIdx.x; i < TB * H; i += NT) {
    int r = i / H;
    s.A[i] = r < nrows ? to_f(x[static_cast<long long>(b0) * H + i]) : 0.f;
  }
  __syncthreads();
  layer_body<T, true, D>(s, wt, cache, L, 2 * H, src, S, b0, nrows, H, heads, F,
                      S, pos);
  for (int i = threadIdx.x; i < nrows * H; i += NT)
    out[static_cast<long long>(b0) * H + i] = from_f<T>(s.Dd[i]);
  write_slot<T, true>(s, wt, cache, L, 2 * H, b0, nrows, H, pos, cache_outputs);
}

template <typename T, int D>
int launch(const void* x, void* cache, const void* src, void* out,
           const Weights& w, int B, int H, int heads, int F, int S, int L,
           int pos, int cache_outputs, cudaStream_t stream) {
  size_t smem = layer_smem_floats(H, F) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decoder_layer_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + TB - 1) / TB);
  decoder_layer_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(cache),
      static_cast<const T*>(src), static_cast<T*>(out), w, B, H, heads, F, S,
      L, pos, cache_outputs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p4fr_decoder_layer(
    const void* x, void* cache, const void* src, void* out,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1_s, const void* ln1_b, const void* w_q2, const void* b_q2,
    const void* w_out2, const void* b_out2, const void* ln2_s,
    const void* ln2_b, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3_s,
    const void* ln3_b, int B, int H, int heads, int F, int S, int L, int pos,
    int cache_outputs, int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || (d != 32 && d != 64) || F % CPT)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w{w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w_q2, b_q2, w_out2,
            b_out2, ln2_s, ln2_b, w_ff0, b_ff0, w_ff1, b_ff1, ln3_s, ln3_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instance by head width: 32 (EfficientSATRN), 64 (SwinTRN)
  auto run = [&](auto head) {
    constexpr int D = decltype(head)::value;
    if (bf16)
      return launch<__nv_bfloat16, D>(x, cache, src, out, w, B, H, heads, F,
                                      S, L, pos, cache_outputs, s);
    return launch<float, D>(x, cache, src, out, w, B, H, heads, F, S, L, pos,
                            cache_outputs, s);
  };
  return d == 32 ? run(std::integral_constant<int, 32>{})
                 : run(std::integral_constant<int, 64>{});
}
