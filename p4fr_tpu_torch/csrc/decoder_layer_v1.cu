// One transformer-decoder layer's autoregressive step with the whole-prefix
// softmax (kernel 8, "v1").
//
// Replaces p4fr_tpu/ops/pallas/decoder_layer.py::decoder_layer_step (:198,
// kernel body _layer_kernel). Not kernel 3 (csrc/decoder_layer.cu, the v2
// TPU kernel's online softmax): the contract is the same, the attention's
// form is the TPU kernel's own. Per batch row, decoder_common.cuh's
// layer_body in its full form over a batch-major [B, L, 2H] cache:
//   q|k|v of the current token; k|v rounded to the cache type and stored
//     into slot `pos` (the TPU kernel's store_slot, :141)
//   self-attention over slots 0..pos read back from the cache, the exact
//     two-pass softmax (scores, their max and sum, then the values with the
//     normalised probabilities; decoder_layer.py:96-117); out-proj; LN1
//   cross-attention over src K|V in the same form; out-proj; LN2
//   FF, ReLU after both linears; LN3
//   with cache_outputs, slot `pos` := the output's k|v (:181-188)
// The TPU kernel also copies the whole cache block in and out of VMEM every
// step, the slowness its header names; here the cache stays in device
// memory and only slot `pos` of the CTA's rows is written, which gives the
// same cache.
//
// Bound on the card: as kernel 3, the bytes (the layer's weights streamed
// from L2 for each CTA of TB rows, its rows' cache prefix and src K|V from
// device memory); the scores make one more pass through shared memory, in
// rowmm's partial-sum scratch, which the attention leaves idle (n floats a
// warp, so the wrapper refuses L or S above RED_FLOATS / NWARP = 1024).
#include <type_traits>

#include "decoder_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT) decoder_layer_v1_kernel(
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
  layer_body<T, D, true>(s, wt, cache, L, src, b0, nrows, H, heads, F, S, pos);
  for (int i = threadIdx.x; i < nrows * H; i += NT)
    out[static_cast<long long>(b0) * H + i] = from_f<T>(s.Dd[i]);
  if (cache_outputs)
    write_slot<T>(s, wt, cache, L, b0, nrows, H, pos, 1);
}

template <typename T, int D>
int launch(const void* x, void* cache, const void* src, void* out,
           const Weights& w, int B, int H, int heads, int F, int S, int L,
           int pos, int cache_outputs, cudaStream_t stream) {
  size_t smem = layer_smem_floats(H, F) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decoder_layer_v1_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((B + TB - 1) / TB);
  decoder_layer_v1_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(cache),
      static_cast<const T*>(src), static_cast<T*>(out), w, B, H, heads, F, S,
      L, pos, cache_outputs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p4fr_decoder_layer_v1(
    const void* x, void* cache, const void* src, void* out,
    const void* w_qkv, const void* b_qkv, const void* w_out, const void* b_out,
    const void* ln1_s, const void* ln1_b, const void* w_q2, const void* b_q2,
    const void* w_out2, const void* b_out2, const void* ln2_s,
    const void* ln2_b, const void* w_ff0, const void* b_ff0,
    const void* w_ff1, const void* b_ff1, const void* ln3_s,
    const void* ln3_b, int B, int H, int heads, int F, int S, int L, int pos,
    int cache_outputs, int bf16, void* stream) {
  const int d = heads > 0 ? H / heads : 0;
  if (H != heads * d || (d != 32 && d != 64) || F % CPT ||
      (L > S ? L : S) * NWARP > RED_FLOATS)
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
