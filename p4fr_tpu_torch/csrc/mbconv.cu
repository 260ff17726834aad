// Stride-1 MBConv(+SE) block at inference, BatchNorms folded to per-channel
// (scale, bias) on each product's output side:
//   h1 = SiLU(x @ pw_w * pw_s + pw_b)                 1x1 expand
//   h2 = SiLU(dw3x3(h1) * dw_s + dw_b)               depthwise, zero pad 1
//   g  = sigmoid(SiLU(mean(h2) @ se_rw + se_rb) @ se_ew + se_eb)   SE gate
//   out = (h2 * g) @ pwl_w * pwl_s + pwl_b (+ x)      1x1 project (+ residual)
//
// Replaces p4fr_tpu/ops/pallas/mbconv.py::fused_mbconv_chain / fused_mbconv
// (kernel body _chain_kernel / _apply_block), which keeps a whole image's
// expanded map in VMEM. On Hopper the place that can hold one image's map
// (16x32x960 f32 at stage 4: 2 MB) is the shared memory of a thread-block
// cluster, so the block runs as two launches:
//   A (expand_gate): one cluster of C CTAs (1-16) per image, persistent over
//     the batch; rank r owns mid channels [c0, c0 + nc) (whole groups of 8)
//     of EVERY pixel, so there is no halo and no recompute. Per image: the
//     1x1 expand over K chunks of x streamed by cp.async into a ring whose
//     slot 0 has room of its own (the next image's first chunk lands there
//     during this image's tail) and whose other slots lie in the map, free
//     while the expand runs; the rank's pw_w slice stays in shared memory;
//     the whole image's accumulators sit in registers (bf16: ldmatrix +
//     mma.sync m16n8k16 on the tensor cores; f32: FMA on the CUDA cores at
//     the same fragment positions), one instance per tiling; BN + SiLU into
//     an f32 map in shared memory; the 3x3 depthwise in place, a channel's
//     plane owned by one warp, neighbours by shuffles, a row read two steps
//     before it is overwritten; BN + SiLU and the channel sums in a fixed
//     order. The SE reduce FC mixes every channel: each rank's partial sums
//     over its channels go to every peer's shared memory (DSMEM), a cluster
//     barrier, then each rank sums the C partials in rank order and gates
//     its own channels. round(h2 * gate) leaves in the activation type as
//     the [B, H, W, Cmid] operand of B. A split cluster barrier (arrive
//     with release after the partials are read, wait with acquire before
//     the next image's push) keeps a push from landing in a buffer a peer
//     still reads.
//   A, band form (expand_gate_band), for maps a cluster of 16 cannot hold
//     whole (EfficientASTER's 16x64 stages 3-4: up to 3.9 MB an image): the
//     same clusters and slices, the image's rows in bands (two of 8 rows at
//     16), one band at a time through the map. A band's rows and one
//     recomputed halo row at each inner edge are expanded in chunks of
//     pixels (9 x 64 = 576 pixels a band at 16x64, 1.125x the useful
//     expand); the depthwise runs in place over the band's rows; every band
//     but the last leaves its f32 h2 in a per-cluster scratch that L2 serves
//     back; after the SE exchange each band is gated and written once.
//   B (project): [B*H*W, Cmid] @ pwl_w, one CTA tile of 256 rows (Couts up
//     to 160) or 128 (up to 256) by the whole Cout, so the operand is read
//     once; operands by cp.async in a 4-stage ring; bf16 on the tensor
//     cores (ldmatrix + mma.sync), f32 on the CUDA cores; BN fold, the
//     residual in f32 and one cast in the epilogue, staged through shared
//     memory for 16-byte stores.
// What bounds it on the card: launch A's per-image phases on 16 warps an
// SM, none near a hardware limit: the depthwise's issue (loads, shuffles,
// FMAs and the SFU SiLUs, a row at a time), the x stream from L2 (a cluster
// reads each image's x once per rank), the SE's cluster barrier and the
// gated write; launch B's operand and weight rows from L2 (each CTA reads
// every weight row). chip_smoke.py prints each phase's cycles (`trace`).
// The band form adds the halo rows' expand and the spilled bands' round
// trip through L2. Channels that are not multiples of 8 go to the
// three-launch kernels of mbconv_tiled.cu; ops/mbconv.py::mbconv_plan
// decides from the shape alone.
// Numerics follow the TPU kernel's contract: f32 accumulation, exact SiLU,
// the pooled mean and SE hidden rounded to the activation type before
// their products, h2 * g rounded once before the projection, the residual
// added in f32, one final cast.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cluster_launch.cuh"

namespace {

// Phase timeline of CTA 0 when a launch is traced (clock64 at each phase's
// end): launch A rows 0-14, one a processed image (0: the image's start,
// 1: the expand's K loop done, 2: h1 in the map, 3: the depthwise done, 4:
// the gate known; the next row's 0 ends the gated write; the band form: 1
// band 0's expand done, 2 its depthwise done, 3 the last band's expand
// done, 4 its depthwise done, 5 the gate known, 6 the last band written;
// the next row's 0 ends the spilled bands' writes), launch B row 15
// (start, K loop done, epilogue done). p4fr_mbconv_trace copies it out.
__device__ unsigned long long g_trace[16][8];

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int NT = 512;  // threads a CTA, both launches
constexpr int NWARP = NT / 32;
constexpr int MAXT = 4;  // A: m-tiles and n-tiles a warp (64 accumulators)
constexpr int DW_CMAX = 4;  // A's depthwise: columns a lane (W <= 4 x its lanes a channel)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// round an f32 value through the activation type T
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}
// exact SiLU of an f32 value, v * logistic(v), on the special-function
// units: MUFU.EX2 for e^-v and MUFU.RCP for the quotient, each within 2 ulp
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }
__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled where !ok (src must still exist)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
// the L2 a hint to fetch `bytes` (a multiple of 16) from global memory at p
// (16-byte aligned), issued by one thread
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" :: "l"(p), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (0-4) committed groups are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}
// four 8x8 bf16 matrices; lanes 8m .. 8m+7 give matrix m's row addresses
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// the B fragment of a 16 x 8 tile stored [k][n]: lanes 0-15 give rows k
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// eight f32 values -> 8 contiguous T (16-byte aligned), rounded once
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
// 8 contiguous T (16-byte aligned) -> f32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
// v, which the compiler may not treat as loop-invariant: addresses built
// from it are recomputed in each image instead of hoisted out of the image
// loop and spilled
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// K chunk of A's x stream (bf16: 64 bytes a pixel; f32: 32) and the padded
// row of an x stage (80 or 48 bytes), so that the 8 rows an ldmatrix phase
// (or a warp's 8 fragment rows) reads fall in 8 different bank groups
template <typename T> struct ACfg;
template <> struct ACfg<bf16> { static constexpr int KC = 32, LDX = 40; };
template <> struct ACfg<float> { static constexpr int KC = 8, LDX = 12; };
constexpr int RMAX = 6;  // x ring slots at most (cp_async_wait takes up to 4)

__host__ __device__ constexpr int align_up(int n, int a) { return (n + a - 1) / a * a; }
__host__ __device__ constexpr int cdiv(int n, int d) { return (n + d - 1) / d; }

// Launch A's expand tiling: wm of the 16 warps along the pixels, each with
// MPW m-tiles of 16 pixels (2 or 4) and NPW n-tiles of 8 channels (2 to 4),
// the image's pixels and the widest slice padded up to that grid
struct ATile {
  int wm, mpw, npw;
};
__host__ __device__ inline ATile a_tile(int S, int ncmax, int wm) {
  const int mpw = cdiv(cdiv(S, 16), wm), npw = cdiv(ncmax / 8, NWARP / wm);
  return {wm, mpw <= 2 ? 2 : mpw, npw <= 2 ? 2 : npw};
}

// Launch A's shared memory, in bytes from the start: the f32 map [S][ldm],
// x ring slot 0 [SP][LDX] (SP = the padded pixels; the next image's first
// chunk lands there while this one finishes), the slice's pw_w [Cin rounded
// up to KC][ldw] in T (loaded once a CTA), pooled mean / gate [ncmax], the
// SE hidden [rd], the exchange [C][rd], the
// slice's per-channel constants (pw_s, pw_b, dw_w [9], dw_s, dw_b, se_eb)
// [14][ncmax] and se_rb [rd] in f32 (loaded once a CTA), and (bf16) the
// slice's SE weights, both [rd][ncmax] (loaded once a CTA; f32 reads them
// from global memory, to leave room for its wider operands). Ring slots 1
// .. ns - 1 lie in the map, which is free while the expand runs.
// ops/mbconv.py::launch_a_layout mirrors it.
struct ALayout {
  int S, ldm, ldw, xstage, ns, slot0, pw, vec, hid, xbuf, cst, sew, bytes;
};
__host__ __device__ inline ALayout a_layout(bool is_bf16, int H, int W, int Cin, int ncmax,
                                            int C, int rd, int wm) {
  ALayout L{};
  const int es = is_bf16 ? 2 : 4, kc = is_bf16 ? 32 : 8, ldx = is_bf16 ? 40 : 12;
  const ATile t = a_tile(H * W, ncmax, wm);
  const int np = (NWARP / wm) * t.npw * 8;  // padded slice width
  L.S = H * W;
  // map rows an odd multiple of 4 floats apart: the depthwise's 8 lanes of a
  // channel (8 rows apart) hit 8 different bank quads, and a warp's float2
  // stores of 8 fragment rows take two wavefronts
  L.ldm = ncmax + 4;
  // bf16 weight rows an odd number of 16-byte units apart (ldmatrix.trans)
  L.ldw = is_bf16 ? np + ((np / 8) % 2 == 0 ? 8 : 16) : np;
  L.xstage = align_up(wm * t.mpw * 16 * ldx * es, 128);
  const int map = align_up(L.S * L.ldm * 4, 128);
  L.ns = 1 + (map / L.xstage < RMAX - 1 ? map / L.xstage : RMAX - 1);
  L.slot0 = map;
  L.pw = L.slot0 + L.xstage;
  L.vec = L.pw + align_up(align_up(Cin, kc) * L.ldw * es, 128);
  L.hid = L.vec + align_up(ncmax * 4, 16);
  L.xbuf = L.hid + align_up(rd * 4, 16);
  L.cst = L.xbuf + align_up(C * rd * 4, 16);
  L.sew = L.cst + align_up((14 * ncmax + rd) * 4, 16);
  L.bytes = L.sew + (is_bf16 ? 2 * align_up(rd * ncmax * es, 16) : 0);
  return L;
}

// The band form's rows: band k of `bands` outputs rows [r0, r1) and expands
// rows [e0, e1), its rows and one halo row at each inner edge
struct BandRows {
  int r0, r1, e0, e1;
};
__host__ __device__ inline BandRows band_rows(int H, int bands, int k) {
  const int r0 = H * k / bands, r1 = H * (k + 1) / bands;
  return {r0, r1, r0 > 0 ? r0 - 1 : 0, r1 < H ? r1 + 1 : H};
}
// the band form's n-tiles a warp, with wm of the 16 warps along the pixels
__host__ __device__ inline int band_npw(int ncmax, int wm) {
  const int npw = cdiv(ncmax / 8, NWARP / wm);
  return npw <= 2 ? 2 : npw;
}
constexpr int SMEM_CAP = 232448;  // an H100 CTA's opt-in shared memory

// The band form's shared memory, in bytes from the start: the f32 map of
// the tallest band with its halo rows [rows x W][ldm] (also the room of a
// spilled band read back, [band_px][ldr]), the slice's pw_w, pooled mean /
// gate, SE hidden, the exchange and the per-channel constants as in
// a_layout (the SE weights stay in global memory), then the x ring of ns
// slots of [P][LDX] (P = wm x mpw x 16 pixels, a chunk), as many as
// SMEM_CAP holds up to RMAX. The map's rows are an odd number of float2
// apart, so that the depthwise's 16 lanes of a channel (columns g + 16 k)
// hit 16 different bank pairs; a band read back has rows of whole 16-byte
// units, for 16-byte copies. ops/mbconv.py::launch_a_layout mirrors it.
struct BLayout {
  int ldm, ldr, ldw, xstage, ns, pw, vec, hid, xbuf, cst, ring, bytes;
};
__host__ __device__ inline BLayout b_layout(bool is_bf16, int H, int W, int Cin, int ncmax,
                                            int C, int rd, int wm, int mpw, int bands) {
  BLayout L{};
  const int es = is_bf16 ? 2 : 4, kc = is_bf16 ? 32 : 8, ldx = is_bf16 ? 40 : 12;
  const int np = (NWARP / wm) * band_npw(ncmax, wm) * 8;  // padded slice width
  int rows = 0;  // the tallest band with its halo rows
  for (int k = 0; k < bands; ++k) {
    const BandRows r = band_rows(H, bands, k);
    rows = r.e1 - r.e0 > rows ? r.e1 - r.e0 : rows;
  }
  L.ldm = ncmax + 2;
  L.ldr = ncmax + 4;
  L.ldw = is_bf16 ? np + ((np / 8) % 2 == 0 ? 8 : 16) : np;
  L.xstage = align_up(wm * mpw * 16 * ldx * es, 128);
  const int map = rows * W * L.ldm, back = cdiv(H, bands) * W * L.ldr;
  L.pw = align_up((map > back ? map : back) * 4, 128);
  L.vec = L.pw + align_up(align_up(Cin, kc) * L.ldw * es, 128);
  L.hid = L.vec + align_up(ncmax * 4, 16);
  L.xbuf = L.hid + align_up(rd * 4, 16);
  L.cst = L.xbuf + align_up(C * rd * 4, 16);
  L.ring = align_up(L.cst + align_up((14 * ncmax + rd) * 4, 16), 128);
  const int room = L.ring < SMEM_CAP ? (SMEM_CAP - L.ring) / L.xstage : 0;
  L.ns = room < RMAX ? room : RMAX;
  L.bytes = L.ring + L.ns * L.xstage;
  return L;
}
__host__ __device__ inline bool band_layout_ok(const BLayout& L) {
  return L.ns >= 2 && L.bytes <= SMEM_CAP;
}

template <typename T>
struct AArgs {
  const T* x;
  const T* pw_w;
  const float *pw_s, *pw_b, *dw_w, *dw_s, *dw_b;
  const T* se_rw;  // null: no SE (rd = 0)
  const float* se_rb;
  const T* se_ew;
  const float* se_eb;
  T* g2;
  int B, H, W, Cin, Cmid, rd;
  int C, ncmax, wm;  // cluster size, widest slice, warps along the pixels
  int trace;         // record g_trace
  ALayout L;  // from the host: read from the constant bank, not held in registers
};

// The expand's products of one x chunk into the image's accumulators:
// warp (wmi, wni) owns m-tiles wmi + wm i (i < MPW) and n-tiles wni + wn j
// (j < NPW); thread (g, q) = (lane / 4, lane % 4) holds, per tile, rows g
// and g + 8, columns 2q and 2q + 1 (mma.sync's accumulator layout). ws:
// the slice's pw_w at the chunk's first row. LIM (the band form): m-tiles
// from mt on hold no pixel and are skipped.
template <int MPW, int NPW, bool LIM = false>
__device__ __forceinline__ void expand_chunk(float (&acc)[MPW][NPW][4], const bf16* xs,
                                             const bf16* ws, int ldw, int wmi, int wni,
                                             int wm, int wn, int lane, int mt = 0) {
  constexpr int LDX = ACfg<bf16>::LDX;
#pragma unroll
  for (int kk = 0; kk < ACfg<bf16>::KC; kk += 16) {
    unsigned bfr[NPW][2];
#pragma unroll
    for (int j = 0; j < NPW; ++j)
      ldsm_x2_trans(bfr[j], ws + (kk + (lane & 15)) * ldw + (wni + wn * j) * 8);
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (LIM && wmi + wm * i >= mt) continue;
      unsigned afr[4];
      ldsm_x4(afr, xs + ((wmi + wm * i) * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NPW; ++j) mma_bf16(acc[i][j], afr, bfr[j]);
    }
  }
}

template <int MPW, int NPW, bool LIM = false>
__device__ __forceinline__ void expand_chunk(float (&acc)[MPW][NPW][4], const float* xs,
                                             const float* ws, int ldw, int wmi, int wni,
                                             int wm, int wn, int lane, int mt = 0) {
  constexpr int LDX = ACfg<float>::LDX;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int k = 0; k < ACfg<float>::KC; ++k) {
    float av[MPW][2], bv[NPW][2];
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (LIM && wmi + wm * i >= mt) continue;
      av[i][0] = xs[((wmi + wm * i) * 16 + g) * LDX + k];
      av[i][1] = xs[((wmi + wm * i) * 16 + g + 8) * LDX + k];
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const float2 b2 =
          *reinterpret_cast<const float2*>(ws + k * ldw + (wni + wn * j) * 8 + 2 * q);
      bv[j][0] = b2.x;
      bv[j][1] = b2.y;
    }
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (LIM && wmi + wm * i >= mt) continue;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        acc[i][j][0] = fmaf(av[i][0], bv[j][0], acc[i][j][0]);
        acc[i][j][1] = fmaf(av[i][0], bv[j][1], acc[i][j][1]);
        acc[i][j][2] = fmaf(av[i][1], bv[j][0], acc[i][j][2]);
        acc[i][j][3] = fmaf(av[i][1], bv[j][1], acc[i][j][3]);
      }
    }
  }
}

// h1 of row yy of channel c at this lane's DW_CMAX columns g + LPC k and
// their left and right neighbours (zero outside the image), from the map:
// lane g - 1 sends column x - 1 (the channel's last lane to its lane 0: its
// column LPC k - 1), lane g + 1 column x + 1 (lane 0 to the last lane: its
// column LPC (k + 1))
template <int LPC>
__device__ __forceinline__ void dw_row(const float* map, int ldm, int W, int H, int yy, int c,
                                       int g, int gb, float (&r)[DW_CMAX][3]) {
  float v[DW_CMAX];
#pragma unroll
  for (int k = 0; k < DW_CMAX; ++k) {
    const int x = g + LPC * k;
    v[k] = (x < W && yy < H) ? map[(yy * W + x) * ldm + c] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < DW_CMAX; ++k) {
    const float to_right = g == LPC - 1 ? (k > 0 ? v[k - 1] : 0.f) : v[k];
    const float to_left = g == 0 ? (k + 1 < DW_CMAX ? v[k + 1] : 0.f) : v[k];
    const float lf = __shfl_sync(0xffffffffu, to_right, gb + ((g + LPC - 1) & (LPC - 1)));
    const float rt = __shfl_sync(0xffffffffu, to_left, gb + ((g + 1) & (LPC - 1)));
    r[k][0] = lf;
    r[k][1] = v[k];
    r[k][2] = rt;
  }
}

// Row y of channel c: the 3x3 window (rows y - 1, y and the freshly read y
// + 1), BN and SiLU, written over h1's row y; the sum of its values
template <int LPC>
__device__ __forceinline__ float dw_out(float* map, int ldm, int W, int y, int c, int g,
                                        const float (&kw)[9], float s2, float b2,
                                        const float (&up)[DW_CMAX][3],
                                        const float (&mid)[DW_CMAX][3],
                                        const float (&dn)[DW_CMAX][3]) {
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < DW_CMAX; ++k) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t0 = fmaf(up[k][d], kw[d], t0);
      t1 = fmaf(mid[k][d], kw[3 + d], t1);
      t2 = fmaf(dn[k][d], kw[6 + d], t2);
    }
    const int x = g + LPC * k;
    if (x < W) {
      const float v = silu(fmaf(t0 + t1 + t2, s2, b2));
      map[(y * W + x) * ldm + c] = v;
      sum += v;
    }
  }
  return sum;
}

// The 3x3 depthwise of this warp's channels, in place: a channel takes LPC
// lanes, lane g of them columns g + LPC k. Every reader and writer of a
// channel's plane is in one warp. Step y reads row y + 2, __syncwarp, then
// computes row y from rows y - 1 .. y + 1 (read two and one steps before)
// and writes it over h1: a row is read two steps before it is overwritten,
// with a __syncwarp between, and its read overlaps the step's arithmetic.
// The four rows' roles rotate over four steps. The channel's sum over its
// lanes, in a fixed order, is pooled into vec[c] (rounded to T).
// BAND: the map holds H rows of a band with its halo rows, the output rows
// are [ys, ye), a row past them (the halo) is read and kept; the band's
// channel sums go into vec[c] (first band) or onto it, and the last band
// turns vec[c] into the image's pooled mean (hw pixels), rounded to T.
template <typename T, int LPC, bool BAND = false>
__device__ void depthwise(float* map, float* vec, const float* cst, int ldm, int ncmax,
                          int nc, int W, int H, int warp, int lane, int ys = 0, int ye = 0,
                          int hw = 0, bool first = true, bool last = true) {
  constexpr int CPW = 32 / LPC;
  const int cl = lane / LPC, g = lane & (LPC - 1), gb = lane - g;
  const int y0 = BAND ? ys : 0, y1 = BAND ? ye : H;
  for (int cw = warp * CPW; cw < nc; cw += NWARP * CPW) {
    const int c = cw + cl;  // nc is a multiple of 8: the warp's channels all valid
    float kw[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) kw[k] = cst[(2 + k) * ncmax + c];
    const float s2 = cst[11 * ncmax + c], b2 = cst[12 * ncmax + c];
    float ra[DW_CMAX][3], rb[DW_CMAX][3], rc[DW_CMAX][3], rd[DW_CMAX][3];
#pragma unroll
    for (int k = 0; k < DW_CMAX; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d) ra[k][d] = 0.f;
    if (BAND && y0 > 0) dw_row<LPC>(map, ldm, W, H, y0 - 1, c, g, gb, ra);  // the upper halo
    dw_row<LPC>(map, ldm, W, H, y0, c, g, gb, rb);
    dw_row<LPC>(map, ldm, W, H, y0 + 1, c, g, gb, rc);
    float sum = 0.f;
    for (int y = y0; y < y1; y += 4) {
      dw_row<LPC>(map, ldm, W, H, y + 2, c, g, gb, rd);
      __syncwarp();
      sum += dw_out<LPC>(map, ldm, W, y, c, g, kw, s2, b2, ra, rb, rc);
      if (y + 1 >= y1) break;
      dw_row<LPC>(map, ldm, W, H, y + 3, c, g, gb, ra);
      __syncwarp();
      sum += dw_out<LPC>(map, ldm, W, y + 1, c, g, kw, s2, b2, rb, rc, rd);
      if (y + 2 >= y1) break;
      dw_row<LPC>(map, ldm, W, H, y + 4, c, g, gb, rb);
      __syncwarp();
      sum += dw_out<LPC>(map, ldm, W, y + 2, c, g, kw, s2, b2, rc, rd, ra);
      if (y + 3 >= y1) break;
      dw_row<LPC>(map, ldm, W, H, y + 5, c, g, gb, rc);
      __syncwarp();
      sum += dw_out<LPC>(map, ldm, W, y + 3, c, g, kw, s2, b2, rd, ra, rb);
    }
#pragma unroll
    for (int o = LPC / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if constexpr (BAND) {
      if (g == 0) {
        const float band_sums = first ? sum : vec[c] + sum;
        vec[c] = last ? round_t<T>(band_sums / static_cast<float>(hw)) : band_sums;
      }
    } else {
      if (g == 0) vec[c] = round_t<T>(sum / static_cast<float>(W * H));
    }
  }
}

// Once a CTA of the band form: its slice's pw_w rows (zero past Cin) by
// cp.async, its per-channel constants [14][ncmax] and se_rb (the SE weights
// are read from global memory, to leave the room to the x ring)
template <typename T>
__device__ __forceinline__ void load_slice(const AArgs<T>& a, T* pws, float* cst, int ldw,
                                           int c0, int nc, int nk, int tid) {
  constexpr int KC = ACfg<T>::KC, EPV = 16 / sizeof(T);
  const int per = nc / EPV;
  for (int i = tid; i < nk * KC * per; i += NT) {
    const int r = i / per, pc = i % per;
    const bool ok = r < a.Cin;
    cp_async16(pws + r * ldw + pc * EPV,
               ok ? a.pw_w + static_cast<long long>(r) * a.Cmid + c0 + pc * EPV : a.pw_w, ok);
  }
  cp_async_commit();
  for (int c = tid; c < nc; c += NT) {
    cst[c] = a.pw_s[c0 + c];
    cst[a.ncmax + c] = a.pw_b[c0 + c];
#pragma unroll
    for (int k = 0; k < 9; ++k) cst[(2 + k) * a.ncmax + c] = a.dw_w[k * a.Cmid + c0 + c];
    cst[11 * a.ncmax + c] = a.dw_s[c0 + c];
    cst[12 * a.ncmax + c] = a.dw_b[c0 + c];
    cst[13 * a.ncmax + c] = a.rd > 0 ? a.se_eb[c0 + c] : 0.f;
  }
  for (int j = tid; j < a.rd; j += NT) cst[14 * a.ncmax + j] = a.se_rb[j];
  cp_async_wait(0);
}

// The SE gate of an image: vec holds the rank's pooled means (rounded) and
// gets its channels' gates. The reduce FC's partials over this rank's
// channels are stored into every rank's exchange (xbuf, over DSMEM); the C
// partials summed in rank order, SiLU (rounded); the expand FC and sigmoid
// for own channels. rw_at(j, c) / ew_at(j, c): the slice's SE weights.
template <typename T, typename RW, typename EW>
__device__ __forceinline__ void se_gate(float* vec, float* hid, float* xbuf, const float* cst,
                                        RW rw_at, EW ew_at, int rd, int nc, int ncmax, int C,
                                        int rank, bool exchange, int tid, int warp, int lane) {
  // peers done reading the last image's partials (at the first image:
  // every CTA running)
  if (exchange) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  {
    cg::cluster_group cl = cg::this_cluster();
    for (int j = warp; j < rd; j += NWARP) {
      float s = 0.f;
#pragma unroll 4
      for (int c = lane; c < nc; c += 32) s = fmaf(vec[c], rw_at(j, c), s);
      s = warp_sum(s);
      if (lane < C) {
        float* dst = xbuf + rank * rd + j;
        if (exchange)
          *cl.map_shared_rank(dst, lane) = s;
        else
          *dst = s;
      }
    }
  }
  if (exchange) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
  for (int j = tid; j < rd; j += NT) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += xbuf[r * rd + j];
    hid[j] = round_t<T>(silu(s + cst[14 * ncmax + j]));
  }
  __syncthreads();
  // this CTA is done with the exchange buffer
  if (exchange) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  // the expand FC: JQ adjacent lanes (a power of two up to 8) share a
  // channel, lane jq summing units j = jq mod JQ; the JQ partials meet by
  // shuffles in a fixed order
  int JQ = 8;
  while (JQ > 1 && JQ * nc > NT) JQ >>= 1;
  {
    const int c = tid / JQ, jq = tid % JQ;
    float s = 0.f;
    if (c < nc)
#pragma unroll 8
      for (int j = jq; j < rd; j += JQ) s = fmaf(hid[j], ew_at(j, c), s);
    for (int o = JQ / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (c < nc && jq == 0) vec[c] = sigmoid(s + cst[13 * ncmax + c]);
  }
  __syncthreads();
}

// Launch A: expand, depthwise and gate. gridDim.x = groups * C, clusters of
// C CTAs; cluster k takes images k, k + groups, ...
template <typename T, int MPW, int NPW>
__global__ void __launch_bounds__(NT, 1) expand_gate(const AArgs<T> a) {
  constexpr int KC = ACfg<T>::KC, LDX = ACfg<T>::LDX, EPV = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const ALayout& L = a.L;
  float* map = reinterpret_cast<float*>(smem);
  T* pws = reinterpret_cast<T*>(smem + L.pw);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* xbuf = reinterpret_cast<float*>(smem + L.xbuf);
  float* cst = reinterpret_cast<float*>(smem + L.cst);  // [14][ncmax], then se_rb
  T* rws = reinterpret_cast<T*>(smem + L.sew);  // rws[j][c] = se_rw[c0 + c][j]
  T* ews = reinterpret_cast<T*>(smem + L.sew + align_up(a.rd * a.ncmax * sizeof(T), 16));

  const int C = a.C, S = L.S, ns = L.ns;
  const int rank = static_cast<int>(blockIdx.x) % C;  // clusters are C consecutive CTAs
  const int group = static_cast<int>(blockIdx.x) / C, groups = gridDim.x / C;
  const int G8 = a.Cmid / 8;
  const int c0 = 8 * (G8 * rank / C), nc = 8 * (G8 * (rank + 1) / C) - c0;
  const bool exchange = C > 1 && a.rd > 0;
  constexpr bool SE_SMEM = sizeof(T) == 2;
  // the SE weights of this slice: reduce (channel c, unit j), expand (j, c)
  auto rw_at = [&](int j, int c) {
    return to_f(SE_SMEM ? rws[j * a.ncmax + c]
                        : a.se_rw[static_cast<long long>(c0 + c) * a.rd + j]);
  };
  auto ew_at = [&](int j, int c) {
    return to_f(SE_SMEM ? ews[j * a.ncmax + c]
                        : a.se_ew[static_cast<long long>(j) * a.Cmid + c0 + c]);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = a.wm, wn = NWARP / wm, wmi = warp % wm, wni = warp / wm;
  const int SP = wm * MPW * 16;  // padded pixels of an x stage
  const int nk = (a.Cin + KC - 1) / KC;

  // once a CTA: the slice's pw_w rows (zero past Cin), its per-channel
  // constants and SE weights
  {
    const int per = nc / EPV;
    for (int i = tid; i < nk * KC * per; i += NT) {
      const int r = i / per, pc = i % per;
      const bool ok = r < a.Cin;
      cp_async16(pws + r * L.ldw + pc * EPV,
                 ok ? a.pw_w + static_cast<long long>(r) * a.Cmid + c0 + pc * EPV : a.pw_w, ok);
    }
    cp_async_commit();
    for (int c = tid; c < nc; c += NT) {
      cst[c] = a.pw_s[c0 + c];
      cst[a.ncmax + c] = a.pw_b[c0 + c];
#pragma unroll
      for (int k = 0; k < 9; ++k) cst[(2 + k) * a.ncmax + c] = a.dw_w[k * a.Cmid + c0 + c];
      cst[11 * a.ncmax + c] = a.dw_s[c0 + c];
      cst[12 * a.ncmax + c] = a.dw_b[c0 + c];
      cst[13 * a.ncmax + c] = a.rd > 0 ? a.se_eb[c0 + c] : 0.f;
    }
    for (int j = tid; j < a.rd; j += NT) cst[14 * a.ncmax + j] = a.se_rb[j];
    for (int i = tid; i < (SE_SMEM ? a.rd * nc : 0); i += NT) {
      const int j = i / nc, c = i % nc;
      rws[j * a.ncmax + c] = a.se_rw[static_cast<long long>(c0 + c) * a.rd + j];
      ews[j * a.ncmax + c] = a.se_ew[static_cast<long long>(j) * a.Cmid + c0 + c];
    }
    cp_async_wait(0);
  }
  // every CTA of the cluster running before the first DSMEM store
  if (exchange) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // x rows [0, SP) of image xi, K chunk kc, into ring slot s (slot 0 of its
  // own, slots 1 .. ns - 1 in the map): PPX pieces a pixel, thread t piece
  // t % PPX of pixels t / PPX + (NT / PPX) j
  constexpr int PPX = KC / EPV;
  auto issue = [&](const T* xi, int kc, int s) {
    T* xs = reinterpret_cast<T*>(smem + (s == 0 ? L.slot0 : (s - 1) * L.xstage));
    const int k = kc * KC + (tid % PPX) * EPV;
    const bool kin = k < a.Cin;
    const T* src = xi + k;
    for (int p = tid / PPX; p < SP; p += NT / PPX) {
      const bool ok = kin && p < S;
      cp_async16(xs + p * LDX + (tid % PPX) * EPV,
                 ok ? src + static_cast<long long>(p) * a.Cin : a.x, ok);
    }
  };
  auto slot_ptr = [&](int s) {
    return reinterpret_cast<const T*>(smem + (s == 0 ? L.slot0 : (s - 1) * L.xstage));
  };

  const bool tl = a.trace && blockIdx.x == 0 && tid == 0;
  int img = 0;
#define TL(ph) if (tl && img < 15) g_trace[img][ph] = clock64();
  for (int b = group; b < a.B; b += groups, ++img) {
    const T* xb = a.x + static_cast<long long>(b) * S * a.Cin;
    const int ldm = opaque(L.ldm);
    TL(0)
    __syncthreads();  // the last image's map reads done: ring slots 1.. are free
    // chunk 0 of every image after the first was issued during the last one
    for (int kc = b == group ? 0 : 1; kc < ns - 1; ++kc) {
      if (kc < nk) issue(xb, kc, kc);
      cp_async_commit();
    }

    // ---- 1x1 expand: [S, Cin] x [Cin, nc], the image's tiles in registers
    {
      float acc[MPW][NPW][4];
#pragma unroll
      for (int i = 0; i < MPW; ++i)
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      int cur = 0, nxt = ns - 1;  // ring slots of chunks kc and kc + ns - 1
      for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait(ns - 2);
        __syncthreads();  // chunk kc landed; every thread is done with kc - 1's slot
        if (kc + ns - 1 < nk) issue(xb, kc + ns - 1, nxt);
        cp_async_commit();
        expand_chunk<MPW, NPW>(acc, slot_ptr(cur), pws + kc * KC * L.ldw, L.ldw, wmi, wni,
                                 wm, wn, lane);
        cur = cur + 1 == ns ? 0 : cur + 1;
        nxt = nxt + 1 == ns ? 0 : nxt + 1;
      }
      TL(1)
      __syncthreads();  // every product done: the map's ring slots are free
      // BN + SiLU into the map (rows past S and columns past nc dropped)
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int col = (wni + wn * j) * 8 + 2 * q;
        if (col >= nc) continue;
        const float sa = cst[col], sb = cst[col + 1];
        const float ba = cst[a.ncmax + col], bb = cst[a.ncmax + col + 1];
#pragma unroll
        for (int i = 0; i < MPW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (wmi + wm * i) * 16 + g + 8 * h;
            if (row < S)
              *reinterpret_cast<float2*>(map + row * ldm + col) =
                  make_float2(silu(fmaf(acc[i][j][2 * h], sa, ba)),
                              silu(fmaf(acc[i][j][2 * h + 1], sb, bb)));
          }
      }
    }
    __syncthreads();  // h1 complete
    TL(2)
    // the next image's first chunk lands in slot 0 while this one finishes
    if (b + groups < a.B) issue(xb + static_cast<long long>(groups) * S * a.Cin, 0, 0);
    cp_async_commit();

    // ---- 3x3 depthwise in place (a channel on 8 lanes, or on 4 where a
    // row is 16 pixels or fewer: a step's latency, not its lanes, sets the
    // pace)
    if (a.W <= 4 * DW_CMAX)
      depthwise<T, 4>(map, vec, cst, ldm, a.ncmax, nc, a.W, a.H, warp, lane);
    else
      depthwise<T, 8>(map, vec, cst, ldm, a.ncmax, nc, a.W, a.H, warp, lane);
    __syncthreads();  // h2 and the pooled means complete
    TL(3)

    // ---- SE gate: pooled mean (rounded); the reduce FC's partials over
    // this rank's channels, stored into every rank's exchange; the C
    // partials summed in rank order, SiLU (rounded); the expand FC and
    // sigmoid for own channels
    if (a.rd > 0) {
      // peers done reading the last image's partials (at the first image:
      // every CTA running)
      if (exchange) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      {
        cg::cluster_group cl = cg::this_cluster();
        for (int j = warp; j < a.rd; j += NWARP) {
          float s = 0.f;
          for (int c = lane; c < nc; c += 32) s = fmaf(vec[c], rw_at(j, c), s);
          s = warp_sum(s);
          if (lane < C) {
            float* dst = xbuf + rank * a.rd + j;
            if (exchange)
              *cl.map_shared_rank(dst, lane) = s;
            else
              *dst = s;
          }
        }
      }
      if (exchange) {
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      } else {
        __syncthreads();
      }
      for (int j = tid; j < a.rd; j += NT) {
        float s = 0.f;
        for (int r = 0; r < C; ++r) s += xbuf[r * a.rd + j];
        hid[j] = round_t<T>(silu(s + cst[14 * a.ncmax + j]));
      }
      __syncthreads();
      // this CTA is done with the exchange buffer
      if (exchange) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      // the expand FC: JQ adjacent lanes (a power of two up to 8) share a
      // channel, lane jq summing units j = jq mod JQ; the JQ partials meet
      // by shuffles in a fixed order
      int JQ = 8;
      while (JQ > 1 && JQ * nc > NT) JQ >>= 1;
      {
        const int c = tid / JQ, jq = tid % JQ;
        float s = 0.f;
        if (c < nc)
          for (int j = jq; j < a.rd; j += JQ) s = fmaf(hid[j], ew_at(j, c), s);
        for (int o = JQ / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (c < nc && jq == 0) vec[c] = sigmoid(s + cst[13 * a.ncmax + c]);
      }
      __syncthreads();
    }
    TL(4)

    // ---- out: round(h2 * gate) in T; thread t channels 8 (t % n8) .. + 7
    // of pixels t / n8 + ppp i
    const int n8 = nc / 8, ppp = NT / n8;
    if (tid < ppp * n8) {
      const int k = (tid % n8) * 8;
      float gk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) gk[e] = a.rd > 0 ? vec[k + e] : 1.f;
      T* out = a.g2 + static_cast<long long>(b) * S * a.Cmid + c0 + k;
      for (int p = tid / n8; p < S; p += ppp) {
        const float* m = map + p * ldm + k;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = m[e] * gk[e];
        store8(out + static_cast<long long>(p) * a.Cmid, v);
      }
    }
  }
  if (tl && img < 15) g_trace[img][0] = clock64();
#undef TL
  // the last arrive's wait: no CTA leaves before its peers are done
  if (exchange) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  cp_async_wait(0);
}

template <typename T>
struct BandArgs {
  AArgs<T> a;      // a.L unused
  float* scratch;  // [groups][bands - 1][band_px][Cmid] f32: the spilled bands' h2
  int mpw, bands, band_px;  // m-tiles a warp, bands, pixels of the tallest band
  BLayout L;
};

// Launch A's band form: launch A for maps that no cluster holds whole. The
// same clusters, persistent over the batch, rank r the same channel slice;
// per image, band k of `bands` at a time through the map: the 1x1 expand
// of its rows and halo rows in chunks of P pixels (the chunk's tiles in
// registers; the x stream runs on through chunks, bands and images in one
// ring of its own), BN + SiLU into the map, the depthwise in place, its
// channel sums onto the pooled means (band 0 first). Every band but the
// last leaves its h2 rows, f32, in this cluster's scratch (each rank its
// channels; ~2 MB a band at 16x64x960, so the read back comes from L2),
// stored in pieces during the next band's first K loop, which writes the
// map only after it. Then the SE gate (se_gate), and round(h2 * gate)
// written for the last band from the map, and for each spilled band after
// cp.async brings it back into the map: its wait and a barrier come before
// any thread reads it. What bounds it (chip_smoke.py's phase cycles): the
// expand's ring steps, about half an image's time (a barrier a step, and
// the x stream from L2: each rank reads each band's x rows, halo rows
// included; one thread asks L2 for the next band's rows a band ahead), the
// depthwise's issue (a quarter), the SE's cluster barrier and the spilled
// bands' round trip through L2.
template <typename T, int MPW, int NPW>
__global__ void __launch_bounds__(NT, 1) expand_gate_band(const BandArgs<T> p) {
  constexpr int KC = ACfg<T>::KC, LDX = ACfg<T>::LDX, EPV = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const AArgs<T>& a = p.a;
  const BLayout& L = p.L;
  float* map = reinterpret_cast<float*>(smem);
  T* pws = reinterpret_cast<T*>(smem + L.pw);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* xbuf = reinterpret_cast<float*>(smem + L.xbuf);
  float* cst = reinterpret_cast<float*>(smem + L.cst);

  const int C = a.C, H = a.H, W = a.W, bands = p.bands, ns = L.ns;
  const int rank = static_cast<int>(blockIdx.x) % C;
  const int group = static_cast<int>(blockIdx.x) / C, groups = gridDim.x / C;
  const int G8 = a.Cmid / 8;
  const int c0 = 8 * (G8 * rank / C), nc = 8 * (G8 * (rank + 1) / C) - c0;
  const bool exchange = C > 1 && a.rd > 0;
  auto rw_at = [&](int j, int c) {
    return to_f(__ldg(a.se_rw + static_cast<long long>(c0 + c) * a.rd + j));
  };
  auto ew_at = [&](int j, int c) {
    return to_f(__ldg(a.se_ew + static_cast<long long>(j) * a.Cmid + c0 + c));
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = a.wm, wn = NWARP / wm, wmi = warp % wm, wni = warp / wm;
  const int P = wm * MPW * 16;  // pixels of a chunk
  const int nk = (a.Cin + KC - 1) / KC;
  const int n4 = nc / 4, n8 = nc / 8, ppp = NT / n8;

  load_slice(a, pws, cst, L.ldw, c0, nc, nk, tid);
  if (exchange) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the x stream: step (image b, band, chunk, kc) is K chunk kc of the
  // chunk's pixels; the producer issues step t + ns - 1 while step t runs
  constexpr int PPX = KC / EPV;
  auto chunks = [&](int k) {
    const BandRows r = band_rows(H, bands, k);
    return cdiv((r.e1 - r.e0) * W, P);
  };
  int pb = group, pband = 0, pchunk = 0, pkc = 0;
  BandRows pr = band_rows(H, bands, 0);  // the producer's band, its chunks
  int pnch = chunks(0);
  auto produce = [&](int s) {
    if (pb < a.B) {
      const int p0 = pr.e0 * W + pchunk * P, np = min(P, pr.e1 * W - p0);
      T* xs = reinterpret_cast<T*>(smem + L.ring + s * L.xstage);
      const int k = pkc * KC + (tid % PPX) * EPV;
      const bool kin = k < a.Cin;
      const T* src = a.x + (static_cast<long long>(pb) * H * W + p0) * a.Cin + k;
      for (int px = tid / PPX; px < P; px += NT / PPX) {
        const bool ok = kin && px < np;
        cp_async16(xs + px * LDX + (tid % PPX) * EPV,
                   ok ? src + static_cast<long long>(px) * a.Cin : a.x, ok);
      }
      if (++pkc == nk) {
        pkc = 0;
        if (++pchunk == pnch) {
          pchunk = 0;
          if (++pband == bands) pband = 0, pb += groups;
          pr = band_rows(H, bands, pband);
          pnch = chunks(pband);
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < ns - 1; ++s) produce(s);
  int cur = 0, nxt = ns - 1;  // ring slots of steps t and t + ns - 1

  const bool tl = a.trace && blockIdx.x == 0 && tid == 0;
  int img = 0;
#define TL(ph) if (tl && img < 15) g_trace[img][ph] = clock64();
  for (int b = group; b < a.B; b += groups, ++img) {
    TL(0)
    const int ldm = opaque(L.ldm);
    float* spill = p.scratch + static_cast<long long>(group) * (bands - 1) * p.band_px * a.Cmid;
    for (int k = 0; k < bands; ++k) {
      const BandRows r = band_rows(H, bands, k);
      const int npx = (r.e1 - r.e0) * W, nch = cdiv(npx, P);
      // the next band's x rows (the next image's first, after the last) into
      // L2, a band ahead of the ring, by one thread of the cluster
      if (rank == 0 && tid == 0) {
        const int nb = k + 1 < bands ? b : b + groups;
        const BandRows rn = band_rows(H, bands, k + 1 < bands ? k + 1 : 0);
        if (nb < a.B)
          prefetch_l2(a.x + (static_cast<long long>(nb) * H * W + rn.e0 * W) * a.Cin,
                      (rn.e1 - rn.e0) * W * a.Cin * sizeof(T));
      }
      // band k - 1's h2 rows, to be spilled over chunk 0's K loop: items of
      // 4 channels of a pixel, [i0, i1) in step kc
      const BandRows rs = band_rows(H, bands, k > 0 ? k - 1 : 0);
      const int ns_items = k > 0 ? (rs.r1 - rs.r0) * W * n4 : 0;
      const float* from = map + (rs.r0 - rs.e0) * W * ldm;
      float* to = spill + static_cast<long long>(k > 0 ? k - 1 : 0) * p.band_px * a.Cmid + c0;
      // ---- 1x1 expand of the band's rows and halo rows, a chunk at a time
      for (int ch = 0; ch < nch; ++ch) {
        const int mt = cdiv(min(P, npx - ch * P), 16);  // m-tiles holding pixels
        float acc[MPW][NPW][4];
#pragma unroll
        for (int i = 0; i < MPW; ++i)
#pragma unroll
          for (int j = 0; j < NPW; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        for (int kc = 0; kc < nk; ++kc) {
          cp_async_wait(ns - 2);
          __syncthreads();  // step t landed; every thread is done with t - 1's slot
          produce(nxt);
          if (ch == 0)  // ---- spill a piece of band k - 1 to the scratch
            for (int i = ns_items * kc / nk + tid; i < ns_items * (kc + 1) / nk; i += NT) {
              const int px = i / n4, e = (i % n4) * 4;
              const float2 lo = *reinterpret_cast<const float2*>(from + px * ldm + e);
              const float2 hi = *reinterpret_cast<const float2*>(from + px * ldm + e + 2);
              *reinterpret_cast<float4*>(to + static_cast<long long>(px) * a.Cmid + e) =
                  make_float4(lo.x, lo.y, hi.x, hi.y);
            }
          expand_chunk<MPW, NPW, true>(
              acc, reinterpret_cast<const T*>(smem + L.ring + cur * L.xstage),
              pws + kc * KC * L.ldw, L.ldw, wmi, wni, wm, wn, lane, mt);
          cur = cur + 1 == ns ? 0 : cur + 1;
          nxt = nxt + 1 == ns ? 0 : nxt + 1;
        }
        if (ch == 0 && ns_items) __syncthreads();  // the spill's reads of the map done
        // BN + SiLU into the chunk's map rows (nobody reads them before the
        // band's barrier; pixels past the band and columns past nc dropped)
        const int g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int col = (wni + wn * j) * 8 + 2 * q;
          if (col >= nc) continue;
          const float sa = cst[col], sb = cst[col + 1];
          const float ba = cst[a.ncmax + col], bb = cst[a.ncmax + col + 1];
#pragma unroll
          for (int i = 0; i < MPW; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int px = ch * P + (wmi + wm * i) * 16 + g + 8 * h;
              if (px < npx)
                *reinterpret_cast<float2*>(map + px * ldm + col) =
                    make_float2(silu(fmaf(acc[i][j][2 * h], sa, ba)),
                                silu(fmaf(acc[i][j][2 * h + 1], sb, bb)));
            }
        }
      }
      if (k == 0) TL(1)
      if (k + 1 == bands) TL(3)
      __syncthreads();  // the band's h1 complete
      // ---- 3x3 depthwise in place over the band's rows
      const int ys = r.r0 - r.e0, ye = r.r1 - r.e0;
      if (W <= 8 * DW_CMAX)
        depthwise<T, 8, true>(map, vec, cst, ldm, a.ncmax, nc, W, r.e1 - r.e0, warp, lane, ys,
                              ye, H * W, k == 0, k + 1 == bands);
      else
        depthwise<T, 16, true>(map, vec, cst, ldm, a.ncmax, nc, W, r.e1 - r.e0, warp, lane,
                               ys, ye, H * W, k == 0, k + 1 == bands);
      __syncthreads();  // the band's h2 and channel sums complete
      if (k == 0) TL(2)
    }
    TL(4)

    // ---- SE gate
    if (a.rd > 0) se_gate<T>(vec, hid, xbuf, cst, rw_at, ew_at, a.rd, nc, a.ncmax, C, rank,
                             exchange, tid, warp, lane);
    TL(5)

    // ---- out: round(h2 * gate) in T, band by band: the last from the map,
    // then each spilled band brought back into the map ([band_px][ldr]);
    // thread t channels 8 (t % n8) .. + 7 of the band's pixels t / n8 + ppp i
    for (int kk = 0; kk < bands; ++kk) {
      const int k = kk == 0 ? bands - 1 : kk - 1;
      const BandRows r = band_rows(H, bands, k);
      const int npx = (r.r1 - r.r0) * W;
      if (kk > 0) {
        __syncthreads();  // the last band's reads of the map done
        const float* src = spill + static_cast<long long>(k) * p.band_px * a.Cmid + c0;
        for (int i = tid; i < npx * n4; i += NT) {
          const int px = i / n4, e = (i % n4) * 4;
          cp_async16(map + px * L.ldr + e, src + static_cast<long long>(px) * a.Cmid + e, true);
        }
        cp_async_commit();
        cp_async_wait(0);
        __syncthreads();  // the band back in the map, for every thread
      }
      const float* h2 = kk > 0 ? map : map + (r.r0 - r.e0) * W * ldm;
      const int ld = kk > 0 ? L.ldr : ldm;
      if (tid < ppp * n8) {
        const int c = (tid % n8) * 8;
        float gk[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) gk[e] = a.rd > 0 ? vec[c + e] : 1.f;
        T* out = a.g2 + (static_cast<long long>(b) * H * W + r.r0 * W) * a.Cmid + c0 + c;
        for (int px = tid / n8; px < npx; px += ppp) {
          const float2* m = reinterpret_cast<const float2*>(h2 + px * ld + c);
          float v[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = m[e];
            v[2 * e] = f.x * gk[2 * e];
            v[2 * e + 1] = f.y * gk[2 * e + 1];
          }
          store8(out + static_cast<long long>(px) * a.Cmid, v);
        }
      }
      if (kk == 0) TL(6)
    }
  }
  if (tl && img < 15) g_trace[img][0] = clock64();
#undef TL
  if (exchange) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  cp_async_wait(0);
}

// ---- launch B: the projection
template <typename T> struct BCfg;  // K chunk (64 bytes a row) and padded A row
template <> struct BCfg<bf16> { static constexpr int BK = 32, LDA = 40; };
template <> struct BCfg<float> { static constexpr int BK = 16, LDA = 20; };
constexpr int PNS = 4, PWN = 4;  // ring stages; warps along the columns
constexpr int LDB = 256 + 8;     // B rows: 33 16-byte units in bf16
// A CTA of 512 threads takes BM rows x up to 32 NPW columns: warps (BM /
// 16 / MTW) x 4, each MTW m-tiles x NPW n-tiles (BM 128: 2 x 8, Couts up to
// 256; BM 256: 4 x 5, Couts up to 160, which halves the weight rows each
// CTA reads from L2). A stage holds A [BM][LDA] and B [BK][LDB] (the same
// bytes in both types); the f32 result tile [BM][ldc] lies over the ring.
template <int BM, int NPW> struct PCfg {
  static constexpr int LDC = NPW * 32 + 8;
  static constexpr int STAGE = BM * 80 + 32 * LDB * 2;
  static constexpr int SMEM =
      PNS * STAGE > BM * LDC * 4 ? PNS * STAGE : BM * LDC * 4;
};

template <typename T>
struct BArgs {
  const T* a;  // [M, K], launch A's gated operand
  const T* w;  // [K, N]
  const float *s3, *b3;
  const T* res;  // [M, N] or null
  T* out;
  int M, K, N;
  int trace;  // record g_trace[15]
};

template <int MTW, int NPW>
__device__ __forceinline__ void project_stage(float (&acc)[MTW][NPW][4], const bf16* As,
                                              const bf16* Bs, int NT8, int row0, int wni,
                                              int lane) {
  constexpr int LDA = BCfg<bf16>::LDA;
#pragma unroll
  for (int kk = 0; kk < BCfg<bf16>::BK; kk += 16) {
    unsigned afr[MTW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
      ldsm_x4(afr[i], As + (row0 + i * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int nt = wni + PWN * j;
      if (nt >= NT8) continue;
      unsigned bfr[2];
      ldsm_x2_trans(bfr, Bs + (kk + (lane & 15)) * LDB + nt * 8);
#pragma unroll
      for (int i = 0; i < MTW; ++i) mma_bf16(acc[i][j], afr[i], bfr);
    }
  }
}

template <int MTW, int NPW>
__device__ __forceinline__ void project_stage(float (&acc)[MTW][NPW][4], const float* As,
                                              const float* Bs, int NT8, int row0, int wni,
                                              int lane) {
  constexpr int LDA = BCfg<float>::LDA;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BCfg<float>::BK; ++k) {
    float av[MTW][2];
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      av[i][0] = As[(row0 + i * 16 + g) * LDA + k];
      av[i][1] = As[(row0 + i * 16 + g + 8) * LDA + k];
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int nt = wni + PWN * j;
      if (nt >= NT8) continue;
      const float2 b2 = *reinterpret_cast<const float2*>(Bs + k * LDB + nt * 8 + 2 * q);
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        acc[i][j][0] = fmaf(av[i][0], b2.x, acc[i][j][0]);
        acc[i][j][1] = fmaf(av[i][0], b2.y, acc[i][j][1]);
        acc[i][j][2] = fmaf(av[i][1], b2.x, acc[i][j][2]);
        acc[i][j][3] = fmaf(av[i][1], b2.y, acc[i][j][3]);
      }
    }
  }
}

// grid (ceil(M / BM), ceil(N / (32 NPW))); warp (wmi, wni) owns rows wmi *
// 16 MTW .. + 16 MTW - 1 and n-tiles wni + 4 j of the tile
template <typename T, int BM, int MTW, int NPW>
__global__ void __launch_bounds__(NT, 1) project(const BArgs<T> p) {
  constexpr int BK = BCfg<T>::BK, LDA = BCfg<T>::LDA, EPV = 16 / sizeof(T);
  constexpr int STAGE = PCfg<BM, NPW>::STAGE, LDC = PCfg<BM, NPW>::LDC;
  constexpr int WMW = BM / 16 / MTW;  // warps along the rows
  static_assert(WMW * PWN == NWARP, "16 warps");
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * NPW * 32;
  const int NT8 = min(NPW * 32, p.N - n0) / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wmi = warp % WMW, wni = warp / WMW, row0 = wmi * 16 * MTW;
  const int nk = (p.K + BK - 1) / BK;

  auto issue = [&](int kc) {
    T* As = reinterpret_cast<T*>(smem + (kc % PNS) * STAGE);
    T* Bs = reinterpret_cast<T*>(smem + (kc % PNS) * STAGE + BM * LDA * sizeof(T));
    const int k0 = kc * BK;
    const int k = k0 + (tid & 3) * EPV;
    for (int r = tid >> 2; r < BM; r += NT / 4) {  // A: BM rows x 4 pieces
      const bool ok = m0 + r < p.M && k < p.K;
      cp_async16(As + r * LDA + (tid & 3) * EPV,
                 ok ? p.a + static_cast<long long>(m0 + r) * p.K + k : p.a, ok);
    }
    const int per = NT8 * 8 / EPV;
    for (int i = tid; i < BK * per; i += NT) {
      const int r = i / per, pc = i % per;
      const bool ok = k0 + r < p.K;
      cp_async16(Bs + r * LDB + pc * EPV,
                 ok ? p.w + static_cast<long long>(k0 + r) * p.N + n0 + pc * EPV : p.w, ok);
    }
  };

  const bool tl = p.trace && blockIdx.x == 0 && tid == 0;
  if (tl) g_trace[15][0] = clock64();
  float acc[MTW][NPW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int s = 0; s < PNS - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait(PNS - 2);
    __syncthreads();  // chunk kc landed; every thread is done with kc - 1's stage
    if (kc + PNS - 1 < nk) issue(kc + PNS - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kc % PNS) * STAGE;
    project_stage<MTW, NPW>(acc, reinterpret_cast<const T*>(st),
                              reinterpret_cast<const T*>(st + BM * LDA * sizeof(T)), NT8, row0,
                              wni, lane);
  }
  if (tl) g_trace[15][1] = clock64();

  // BN fold into an f32 tile over the ring, then the residual in f32 and
  // one cast, 8 columns (16 or 32 bytes) a thread, rows whole
  cp_async_wait(0);
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int nt = wni + PWN * j;
    if (nt >= NT8) continue;
    const int col = nt * 8 + 2 * q;
    const float sa = p.s3[n0 + col], sb = p.s3[n0 + col + 1];
    const float ba = p.b3[n0 + col], bb = p.b3[n0 + col + 1];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Cs + (row0 + i * 16 + g + 8 * h) * LDC + col) =
            make_float2(fmaf(acc[i][j][2 * h], sa, ba), fmaf(acc[i][j][2 * h + 1], sb, bb));
  }
  __syncthreads();
  for (int i = tid; i < BM * NT8; i += NT) {
    const int r = i / NT8, c8 = (i % NT8) * 8;
    if (m0 + r >= p.M) break;
    const long long o = static_cast<long long>(m0 + r) * p.N + n0 + c8;
    float v[8];
    const float4 lo = *reinterpret_cast<const float4*>(Cs + r * LDC + c8);
    const float4 hi = *reinterpret_cast<const float4*>(Cs + r * LDC + c8 + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    if (p.res) {
      float rv[8];
      load8(p.res + o, rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += rv[e];
    }
    store8(p.out + o, v);
  }
  if (tl) g_trace[15][2] = clock64();
}

template <typename T, int BM, int MTW, int NPW>
int launch_project(const BArgs<T>& args, cudaStream_t s) {
  constexpr int smem = PCfg<BM, NPW>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(project<T, BM, MTW, NPW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((args.M + BM - 1) / BM, (args.N + NPW * 32 - 1) / (NPW * 32));
  project<T, BM, MTW, NPW><<<grid, NT, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Couts up to 160 take 256-row tiles, wider ones 128-row tiles
template <typename T>
int project_any(const BArgs<T>& args, cudaStream_t s) {
  return args.N <= 160 ? launch_project<T, 256, 4, 5>(args, s)
                       : launch_project<T, 128, 2, 8>(args, s);
}

template <typename T>
AArgs<T> a_args(const void* x, const void* pw_w, const void* pw_s, const void* pw_b,
                const void* dw_w, const void* dw_s, const void* dw_b, const void* se_rw,
                const void* se_rb, const void* se_ew, const void* se_eb, void* g2, int B,
                int H, int W, int Cin, int Cmid, int rd, int C, int ncmax, int wm, int trace) {
  return {static_cast<const T*>(x), static_cast<const T*>(pw_w),
          static_cast<const float*>(pw_s), static_cast<const float*>(pw_b),
          static_cast<const float*>(dw_w), static_cast<const float*>(dw_s),
          static_cast<const float*>(dw_b), static_cast<const T*>(se_rw),
          static_cast<const float*>(se_rb), static_cast<const T*>(se_ew),
          static_cast<const float*>(se_eb), static_cast<T*>(g2), B, H, W, Cin, Cmid,
          rd, C, ncmax, wm, trace, a_layout(sizeof(T) == 2, H, W, Cin, ncmax, C, rd, wm)};
}

// what launch A takes, as ops/mbconv.py::mbconv_plan checks it
bool a_valid(bool is_bf16, int H, int W, int Cin, int Cmid, int C, int ncmax, int wm,
             int rd) {
  if (Cin % 8 || Cmid % 8 || C < 1 || C > 16 || ncmax != 8 * ((Cmid / 8 + C - 1) / C) ||
      Cmid / 8 < C || ncmax > NT || wm < 1 || NWARP % wm || W > 8 * DW_CMAX)
    return false;
  const ATile t = a_tile(H * W, ncmax, wm);
  return (t.mpw == 2 || t.mpw == 4) && t.npw <= 4 &&
         a_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm).ns >= 2;
}

// f(the launch A instance of a type and tiling, MPW 2 or 4 and NPW 2 to 4,
// as a std::integral_constant)
template <auto K> using KernelC = std::integral_constant<decltype(K), K>;
template <typename T, typename F>
int with_instance(const ATile& t, F f) {
  switch (t.mpw * 8 + t.npw) {
    case 2 * 8 + 2: return f(KernelC<expand_gate<T, 2, 2>>{});
    case 2 * 8 + 3: return f(KernelC<expand_gate<T, 2, 3>>{});
    case 2 * 8 + 4: return f(KernelC<expand_gate<T, 2, 4>>{});
    case 4 * 8 + 2: return f(KernelC<expand_gate<T, 4, 2>>{});
    case 4 * 8 + 3: return f(KernelC<expand_gate<T, 4, 3>>{});
    case 4 * 8 + 4: return f(KernelC<expand_gate<T, 4, 4>>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// what the band form takes, as ops/mbconv.py::mbconv_plan checks it
bool band_valid(bool is_bf16, int H, int W, int Cin, int Cmid, int C, int ncmax, int wm,
                int mpw, int bands, int rd) {
  if (Cin % 8 || Cmid % 8 || C < 1 || C > 16 || ncmax != 8 * ((Cmid / 8 + C - 1) / C) ||
      Cmid / 8 < C || ncmax > NT || wm < 1 || NWARP % wm || W > 16 * DW_CMAX || bands < 2 ||
      bands > H)
    return false;
  return band_layout_ok(b_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm, mpw, bands)) &&
         mpw >= 2 && mpw <= 4 && (band_npw(ncmax, wm) == 2 || band_npw(ncmax, wm) == 3);
}

// f(the band form's instance of a type and tiling, MPW 2 to 4 and NPW 2 or
// 3, as a std::integral_constant)
template <typename T, typename F>
int with_band_instance(int mpw, int npw, F f) {
  switch (mpw * 8 + npw) {
    case 2 * 8 + 2: return f(KernelC<expand_gate_band<T, 2, 2>>{});
    case 2 * 8 + 3: return f(KernelC<expand_gate_band<T, 2, 3>>{});
    case 3 * 8 + 2: return f(KernelC<expand_gate_band<T, 3, 2>>{});
    case 3 * 8 + 3: return f(KernelC<expand_gate_band<T, 3, 3>>{});
    case 4 * 8 + 2: return f(KernelC<expand_gate_band<T, 4, 2>>{});
    case 4 * 8 + 3: return f(KernelC<expand_gate_band<T, 4, 3>>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// launch A's bytes of dynamic shared memory a CTA
extern "C" int p4fr_mbconv_cluster_smem(int H, int W, int Cin, int ncmax, int C, int rd,
                                        int wm, int is_bf16) {
  return a_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm).bytes;
}

// launch A's instance for the type and tiling: its clusters of C resident at
// once with that shared memory, registers and local-memory bytes a thread
extern "C" int p4fr_mbconv_cluster_query(int H, int W, int Cin, int ncmax, int C, int rd,
                                         int wm, int is_bf16, int* clusters, int* regs,
                                         int* local) {
  const size_t smem = a_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm).bytes;
  const ATile t = a_tile(H * W, ncmax, wm);
  auto q = [&](auto k) {
    return query_cluster<decltype(k)::value>(C, NT, smem, clusters, regs, local);
  };
  return is_bf16 ? with_instance<bf16>(t, q) : with_instance<float>(t, q);
}

// launch A: groups clusters of C CTAs; g2 [B, H, W, Cmid] in the type
extern "C" int p4fr_mbconv_expand_gate(
    const void* x, const void* pw_w, const void* pw_s, const void* pw_b, const void* dw_w,
    const void* dw_s, const void* dw_b, const void* se_rw, const void* se_rb,
    const void* se_ew, const void* se_eb, void* g2, int B, int H, int W, int Cin, int Cmid,
    int rd, int C, int ncmax, int wm, int groups, int is_bf16, int trace, void* stream) {
  if (!se_rw) rd = 0;
  if (!a_valid(is_bf16, H, W, Cin, Cmid, C, ncmax, wm, rd) || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = a_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm).bytes;
  const ATile t = a_tile(H * W, ncmax, wm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const AArgs<bf16> args = a_args<bf16>(x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b, se_rw, se_rb,
                                          se_ew, se_eb, g2, B, H, W, Cin, Cmid, rd, C, ncmax,
                                          wm, trace);
    return with_instance<bf16>(t, [&](auto k) {
      return launch_cluster<decltype(k)::value>(groups, C, NT, smem, s, args);
    });
  }
  const AArgs<float> args = a_args<float>(x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b, se_rw, se_rb,
                                          se_ew, se_eb, g2, B, H, W, Cin, Cmid, rd, C, ncmax,
                                          wm, trace);
  return with_instance<float>(t, [&](auto k) {
    return launch_cluster<decltype(k)::value>(groups, C, NT, smem, s, args);
  });
}

// the band form's bytes of dynamic shared memory a CTA (0: no ring of two
// slots fits)
extern "C" int p4fr_mbconv_band_smem(int H, int W, int Cin, int ncmax, int C, int rd, int wm,
                                     int mpw, int bands, int is_bf16) {
  const BLayout L = b_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm, mpw, bands);
  return band_layout_ok(L) ? L.bytes : 0;
}

// the band form's instance for the type and tiling: its clusters of C
// resident at once with that shared memory, registers and local-memory bytes
// a thread
extern "C" int p4fr_mbconv_band_query(int H, int W, int Cin, int ncmax, int C, int rd, int wm,
                                      int mpw, int bands, int is_bf16, int* clusters,
                                      int* regs, int* local) {
  const size_t smem = b_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm, mpw, bands).bytes;
  auto q = [&](auto k) {
    return query_cluster<decltype(k)::value>(C, NT, smem, clusters, regs, local);
  };
  const int npw = band_npw(ncmax, wm);
  return is_bf16 ? with_band_instance<bf16>(mpw, npw, q)
                 : with_band_instance<float>(mpw, npw, q);
}

// launch A's band form: groups clusters of C CTAs; g2 [B, H, W, Cmid] in the
// type; scratch f32, groups x (bands - 1) x ceil(H / bands) x W x Cmid
extern "C" int p4fr_mbconv_band_expand_gate(
    const void* x, const void* pw_w, const void* pw_s, const void* pw_b, const void* dw_w,
    const void* dw_s, const void* dw_b, const void* se_rw, const void* se_rb,
    const void* se_ew, const void* se_eb, void* g2, void* scratch, int B, int H, int W,
    int Cin, int Cmid, int rd, int C, int ncmax, int wm, int mpw, int bands, int groups,
    int is_bf16, int trace, void* stream) {
  if (!se_rw) rd = 0;
  if (!band_valid(is_bf16, H, W, Cin, Cmid, C, ncmax, wm, mpw, bands, rd) || groups < 1 ||
      !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const BLayout L = b_layout(is_bf16, H, W, Cin, ncmax, C, rd, wm, mpw, bands);
  const int npw = band_npw(ncmax, wm), band_px = cdiv(H, bands) * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto args) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(args.a.x)>>;
    return with_band_instance<T>(mpw, npw, [&](auto k) {
      return launch_cluster<decltype(k)::value>(groups, C, NT, L.bytes, s, args);
    });
  };
  if (is_bf16)
    return launch(BandArgs<bf16>{
        a_args<bf16>(x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b, se_rw, se_rb, se_ew, se_eb, g2, B,
                     H, W, Cin, Cmid, rd, C, ncmax, wm, trace),
        static_cast<float*>(scratch), mpw, bands, band_px, L});
  return launch(BandArgs<float>{
      a_args<float>(x, pw_w, pw_s, pw_b, dw_w, dw_s, dw_b, se_rw, se_rb, se_ew, se_eb, g2, B,
                    H, W, Cin, Cmid, rd, C, ncmax, wm, trace),
      static_cast<float*>(scratch), mpw, bands, band_px, L});
}

// launch B: out [M, N] = a [M, K] @ w [K, N] * s3 + b3 (+ res), K and N
// multiples of 8
extern "C" int p4fr_mbconv_project_cluster(const void* a, const void* w, const void* s3,
                                           const void* b3, const void* res, void* out, int M,
                                           int K, int N, int is_bf16, int trace,
                                           void* stream) {
  if (K % 8 || N % 8 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const BArgs<bf16> args{static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                           static_cast<const float*>(s3), static_cast<const float*>(b3),
                           static_cast<const bf16*>(res), static_cast<bf16*>(out), M, K, N,
                           trace};
    return project_any(args, s);
  }
  const BArgs<float> args{static_cast<const float*>(a), static_cast<const float*>(w),
                          static_cast<const float*>(s3), static_cast<const float*>(b3),
                          static_cast<const float*>(res), static_cast<float*>(out), M, K, N,
                          trace};
  return project_any(args, s);
}

// the traced launches' timeline, 16 x 8 u64 cycle counts, into host memory
extern "C" int p4fr_mbconv_trace(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));
}
