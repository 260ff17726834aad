// u8 NHWC image -> per-channel x * scale[c] + shift[c], cast to f32 or bf16.
//
// Replaces p4fr_tpu/ops/pallas/preprocess.py::_standardize_pallas.
// Bound on the card: device-memory bytes (1 byte read, 2 or 4 written per
// element, one FMA each). Design: one thread per 16 input bytes, read as
// one 16-byte vector load and written as 16-byte vector stores, so a warp
// moves whole 128-byte lines; the channel of element i is i % C (NHWC is
// channel-minor). A scalar tail handles sizes that are not multiples of 16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store16(float* out, const float* v) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* v) {
  __align__(16) __nv_bfloat162 p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  uint4* o = reinterpret_cast<uint4*>(out);
  const uint4* s = reinterpret_cast<const uint4*>(p);
  o[0] = s[0];
  o[1] = s[1];
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void standardize_kernel(const uint8_t* __restrict__ in,
                                   T* __restrict__ out,
                                   const float* __restrict__ scale_shift,
                                   long long n, int channels) {
  long long base = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  if (base >= n) return;
  const float* scale = scale_shift;
  const float* shift = scale_shift + channels;
  if (base + 16 <= n) {
    uint4 raw = *reinterpret_cast<const uint4*>(in + base);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    float v[16];
    int c = static_cast<int>(base % channels);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = fmaf(static_cast<float>(b[i]), scale[c], shift[c]);
      c = (c + 1 == channels) ? 0 : c + 1;
    }
    store16(out + base, v);
  } else {
    for (long long i = base; i < n; ++i) {
      int c = static_cast<int>(i % channels);
      store1(out + i, fmaf(static_cast<float>(in[i]), scale[c], shift[c]));
    }
  }
}

}  // namespace

extern "C" int p4fr_standardize(const void* in, void* out,
                                const void* scale_shift, long long n,
                                int channels, int out_bf16, void* stream) {
  const int threads = 256;
  long long vecs = (n + 15) / 16;
  unsigned blocks = static_cast<unsigned>((vecs + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks == 0) return 0;
  if (out_bf16) {
    standardize_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<__nv_bfloat16*>(out),
        static_cast<const float*>(scale_shift), n, channels);
  } else {
    standardize_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(in), static_cast<float*>(out),
        static_cast<const float*>(scale_shift), n, channels);
  }
  return static_cast<int>(cudaGetLastError());
}
