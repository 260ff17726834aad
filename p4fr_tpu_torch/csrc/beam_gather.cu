// Parent-beam reorder of one KV cache, in place: for every row i of
// cache [B*W, L, F], slots 0..pos take the values of row parent[i].
//
// Replaces p4fr_tpu/ops/pallas/beam_gather.py::beam_parent_gather.
// Bound on the card: device-memory bytes. It is a pure copy: every row
// whose parent is not itself is read (as a parent) and written over slots
// 0..pos, nothing else.
//
// Design. Beam parents are block-diagonal (parent[i] / W == i / W: top-k
// runs within each sample), so the W rows of a group only ever exchange
// values among themselves. One CTA owns one group over a range of 256
// 16-byte vectors of the rows' slot-0..pos prefix (contiguous in memory):
//   1. the first W threads load the group's parents (there is no scalar
//      prefetch on the card); a group whose parents are the identity
//      returns at once: the buffer already holds the answer. This is the
//      TPU kernel's tile skip, and it matters once beams stabilise;
//   2. every row that is some other row's parent is read into shared
//      memory, one vector per thread;
//   3. every row whose parent is not itself is written from there.
// Each thread stages and writes back only its own vector column of the W
// rows, so its reads precede its writes in program order and no barrier is
// needed between the two; no other CTA touches the group's rows in that
// vector range, so the in-place write is safe without atomics. A parent
// outside its group breaks the contract and traps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one 16-byte vector per thread and row
constexpr int kMaxGroup = 32;

__global__ void beam_gather_kernel(uint4* __restrict__ cache,
                                   const long long* __restrict__ parent,
                                   int group, long long row_vecs,
                                   long long prefix_vecs) {
  extern __shared__ uint4 tile[];  // [group][kThreads]
  __shared__ int lp[kMaxGroup];    // group-local parent of each row
  __shared__ int is_parent[kMaxGroup];
  const long long row0 = static_cast<long long>(blockIdx.x) * group;
  const int tid = threadIdx.x;
  int moved = 0;
  if (tid < group) {
    long long p = parent[row0 + tid] - row0;
    if (p < 0 || p >= group) __trap();
    lp[tid] = static_cast<int>(p);
    is_parent[tid] = 0;
    moved = p != tid;
  }
  if (!__syncthreads_or(moved)) return;  // identity group: no traffic
  if (tid < group && lp[tid] != tid) is_parent[lp[tid]] = 1;
  __syncthreads();

  const long long v = static_cast<long long>(blockIdx.y) * kThreads + tid;
  const bool live = v < prefix_vecs;
  for (int k = 0; k < group; ++k) {
    if (live && is_parent[k]) tile[k * kThreads + tid] = cache[(row0 + k) * row_vecs + v];
  }
  for (int k = 0; k < group; ++k) {
    const int p = lp[k];
    if (live && p != k) cache[(row0 + k) * row_vecs + v] = tile[p * kThreads + tid];
  }
}

}  // namespace

// cache: [rows, L, F] with L*F*itemsize a multiple of 16 bytes, as
// row_vecs 16-byte vectors per row; prefix_vecs: the vectors of slots
// 0..pos; parent: [rows] int64; rows a multiple of group.
extern "C" int p4fr_beam_gather(void* cache, const void* parent,
                                long long rows, int group, long long row_vecs,
                                long long prefix_vecs, void* stream) {
  if (group < 1 || group > kMaxGroup || rows % group) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (prefix_vecs + kThreads - 1) / kThreads;
  if (rows == 0 || chunks == 0) return 0;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  const size_t smem = static_cast<size_t>(group) * kThreads * sizeof(uint4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(beam_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>(rows / group), static_cast<unsigned>(chunks));
  beam_gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const long long*>(parent), group,
      row_vecs, prefix_vecs);
  return static_cast<int>(cudaGetLastError());
}
