// Hopper's asynchronous machinery for the port's kernels (sm_90a): mbarrier
// rings, TMA tile loads, and the warpgroup tensor-core product (wgmma) on
// 128-byte-swizzled shared tiles.
//
// The one shared-memory tile format. A tile is R rows of 128 bytes (64 bf16
// values), 1024-byte aligned. The 16-byte chunk c of row r lies at byte
//   r * 128 + ((c ^ (r & 7)) << 4)                                (swz())
// which is what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes and what
// the wgmma descriptors below read. Threads that fill a tile themselves (a
// gathered operand) write the same addresses, so one descriptor format
// serves every operand.
//
// The descriptors (PTX ISA, "Matrix Descriptor Format"; SBO 1024 bytes, the
// step between groups of 8 rows; layout type 1, 128B swizzle):
// - K-major (the 64 values of a row run along the product's depth K): rows
//   are M or N. A warpgroup's 64 rows start 8 KB apart; the k-step of 16
//   moves the start address by 32 bytes inside the swizzle atom.
// - MN-major (a row runs along M or N, rows are K): a 64-wide M or N is one
//   swizzle atom; the k-step of 16 moves the start by 16 rows, 2048 bytes.
//   wgmma's transpose bit (1) says which operand is MN-major.
// wgmma.m64n64k16's fp32 accumulator: thread (warp w of its warpgroup, lane
// l) holds d[n][i] at row 16 w + l / 4 + 8 (i / 2) and column 8 n + 2 (l % 4)
// + (i % 2), the layout of mma.m16n8k16's C tiles.
// An A operand from registers (the RS form, wgmma64_rs): a 64 x 16 bf16
// tile, warp w holding rows 16 w.. as mma.m16n8k16's A fragment: a[0] =
// (row l / 4, columns 2 (l % 4) + {0, 1}), a[1] the same 8 rows down, a[2]
// and a[3] the same 8 columns right. So accumulator columns 16 kk.. of
// one product are the A operand of k-step kk of the next, with no trip
// through shared memory (acc_to_a).
// Wider outputs (d 128 in the flash backward) are n64 pairs: one
// accumulator and one MN-major B atom a 64-column half.
//
// fp32 tiles (TF32 wgmma, flash_bwd_tf32.cuh) use the same format: a row
// of an atom holds 32 floats, so a d-64 row is two atoms (f32_map4 loads
// boxes of 32 columns). TF32's k-step of 8 is 32 bytes, as bf16's of 16,
// so desc() and the K-major steps hold unchanged. TF32 wgmma has no
// transpose bit (PTX allows imm-trans-a/b for f16 and bf16 only): both
// operands are K-major, and an operand needed with its other index
// contiguous is written transposed by threads. The tf32 RS A fragment (a
// 64 x 8 tile, four b32 registers, warp w rows 16 w..) is mma.m16n8k8's:
// a[0] = (row l / 4, column l % 4), a[1] 8 rows down, a[2] and a[3] the
// same 4 columns right. An accumulator's chunk n holds columns 8 n + 2 (l
// % 4) + {0, 1}, so it feeds a k-step with its 8 columns renamed: column
// 2 t is the fragment's t and 2 t + 1 its t + 4 (A = {d[n][0], d[n][2],
// d[n][1], d[n][3]}), and the B operand's k rows are written in that
// order.
//
// Shared memory that threads write (st.shared, cp.async) is read by wgmma
// and TMA through the async proxy, so a proxy fence (fence.proxy.async)
// must lie between the writes and the reads, or wgmma reads stale data
// without any error: the writer fences after its st.shared writes and
// before the barrier that hands them on; cp.async copies land on their own
// and arrive on an mbarrier (cp_arrive), so there the reader fences once
// its wait on that barrier is over.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

// ---- device side ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive, and expect `bytes` more from TMA loads in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// ~10 s at the H100's clocks: a barrier that never completes (a lost
// arrival, a wrong byte count) traps, and the launch fails, instead of
// hanging the card
constexpr long long kHangCycles = 20000000000LL;

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > kHangCycles) __trap();
  }
}

// Move registers between warpgroups (PTX setmaxnreg, sm_90a): every warp
// of a warpgroup runs the same one. A producer that only issues TMA loads
// gives its registers back (dec) and the consumers take them (inc, which
// waits until the block's pool holds them). N is a multiple of 8 in [24,
// 256]; the kernel's launch bounds set the count every thread starts at.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// box of a 3-D tensor map at element coordinates (c0 innermost) into shared
// memory at dst; completion counted in bytes on barrier bar
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// the same for a 4-D tensor map
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// arrive on bar once every earlier cp.async of this thread has landed
// (the arrival counts towards the barrier's expected count)
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over n threads (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// named barrier that also returns whether v is true in any of its threads
__device__ __forceinline__ bool bar_any(int id, int n, bool v) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(out) : "r"((uint32_t)v), "r"(id), "r"(n) : "memory");
  return out != 0;
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma wait
template <int NN>
__device__ __forceinline__ void acc_fence(float (&d)[NN][4]) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i]) :: "memory");
}

// d[64 x 64] += A[64 x 16] B[16 x 64], bf16 operands from shared memory by
// descriptor, fp32 accumulator. TA / TB: A / B MN-major (1) or K-major (0).
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[8][4], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// the four k-steps of one 64-deep chunk; a_step / b_step: the start
// address step of a k-step (32 bytes K-major, 2048 MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_chunk(float (&d)[8][4], uint32_t a,
                                            uint32_t b) {
  constexpr uint32_t sa = TA ? 2048 : 32, sb = TB ? 2048 : 32;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma64<TA, TB>(d, desc(a + ks * sa), desc(b + ks * sb));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the RS form: the
// A fragment above, bf16 pairs), B from shared memory by descriptor; TB: B
// MN-major (1) or K-major (0). The registers of a must keep their values
// until a wgmma.wait_group covers this product.
template <int TB>
__device__ __forceinline__ void wgmma64_rs(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TB));
}

// A 64 x 64 fp32 accumulator as the bf16 A operand of the next product's
// four k-steps (a[kk]: its columns 16 kk..16 kk + 15), rounded to nearest
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&d)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack2(d[2 * kk][0], d[2 * kk][1]);
    a[kk][1] = pack2(d[2 * kk][2], d[2 * kk][3]);
    a[kk][2] = pack2(d[2 * kk + 1][0], d[2 * kk + 1][1]);
    a[kk][3] = pack2(d[2 * kk + 1][2], d[2 * kk + 1][3]);
  }
}

// d (NH 64-column halves) += A[64 x 64] B[64 x 64 NH], A from registers
// (acc_to_a), B NH atoms `atom` bytes apart, each 64 rows of K running
// along N: MN-major (TB 1), so the k-step of 16 moves each start by 16
// rows, 2048 bytes
template <int TB, int NH>
__device__ __forceinline__ void wgmma_rs_chunk(float (&d)[NH][8][4],
                                               const uint32_t (&a)[4][4],
                                               uint32_t b, uint32_t atom) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < NH; ++h)
      wgmma64_rs<TB>(d[h], a[kk], desc(b + h * atom + kk * 2048));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], tf32 operands from shared memory
// by descriptor (both K-major), fp32 accumulator. ACC false: d = A B, the
// old d neither read nor added (scale-d 0), so a fresh accumulator needs
// no zeroing (zeroing that ptxas hoisted into earlier products' windows
// cost registers).
template <bool ACC = true>
__device__ __forceinline__ void wgmma32_tf32(float (&d)[4][4], uint64_t a,
                                             uint64_t b) {
#define HOP_WGMMA32_TF32(C)                                                  \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15}, %16, %17, p, 1, 1;\n}\n"                                        \
      : C(d[0][0]), C(d[0][1]), C(d[0][2]), C(d[0][3]), C(d[1][0]),          \
        C(d[1][1]), C(d[1][2]), C(d[1][3]), C(d[2][0]), C(d[2][1]),          \
        C(d[2][2]), C(d[2][3]), C(d[3][0]), C(d[3][1]), C(d[3][2]),          \
        C(d[3][3])                                                           \
      : "l"(a), "l"(b), "r"(ACC ? 1 : 0))
  if constexpr (ACC) HOP_WGMMA32_TF32("+f");
  else HOP_WGMMA32_TF32("=f");
#undef HOP_WGMMA32_TF32
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], A from registers (the tf32
// fragment above), B K-major from shared memory by descriptor; ACC as
// above. The registers of a must keep their values until a
// wgmma.wait_group covers this product. TIED (with ACC false): d's old
// values are not read, but its registers are named as read, so that the
// compiler keeps d in one set of registers from product to product
// instead of renaming a fresh set for each (which lets a product start
// before the last one's result is used, at 32 registers a set).
template <bool ACC = true, bool TIED = false>
__device__ __forceinline__ void wgmma64_tf32_rs(float (&d)[8][4],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
#define HOP_WGMMA64_TF32_RS(C)                                               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"        \
      : C(d[0][0]), C(d[0][1]), C(d[0][2]), C(d[0][3]), C(d[1][0]),          \
        C(d[1][1]), C(d[1][2]), C(d[1][3]), C(d[2][0]), C(d[2][1]),          \
        C(d[2][2]), C(d[2][3]), C(d[3][0]), C(d[3][1]), C(d[3][2]),          \
        C(d[3][3]), C(d[4][0]), C(d[4][1]), C(d[4][2]), C(d[4][3]),          \
        C(d[5][0]), C(d[5][1]), C(d[5][2]), C(d[5][3]), C(d[6][0]),          \
        C(d[6][1]), C(d[6][2]), C(d[6][3]), C(d[7][0]), C(d[7][1]),          \
        C(d[7][2]), C(d[7][3])                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                  \
        "r"(ACC ? 1 : 0))
  if constexpr (ACC || TIED) HOP_WGMMA64_TF32_RS("+f");
  else HOP_WGMMA64_TF32_RS("=f");
#undef HOP_WGMMA64_TF32_RS
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), through the runtime
// (no -lcuda)
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor [n2][n1][n0] (n0 contiguous) read in boxes of 64 x b1 x 1
// elements, 128B-swizzled; out-of-bounds elements read as zeros.
inline bool bf16_map3(CUtensorMap* m, const void* base, uint64_t n0,
                      uint64_t n1, uint64_t n2, uint32_t b1) {
  const EncodeTiled enc = encoder();
  if (!enc || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  const cuuint32_t box[3] = {64, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A strided bf16 tensor of dims n[0..3] (n[0] contiguous) with the element
// strides st[0..2] of dims 1-3 (a [b, s, h, d] view: n = {d, s, h, b}, st
// = {s, h, b} strides), read in boxes of 64 x b1 x 1 x 1 elements,
// 128B-swizzled; out-of-bounds elements read as zeros. TMA takes strides
// that are positive multiples of 16 bytes and a 16-byte aligned base; a
// dimension of size 1 is never stepped, so a stride of 0 there becomes the
// packed one. A broadcast dimension (stride 0, size > 1) is refused.
// (the map of either element type: `es` bytes an element, 128 / es of
// them a box row)
inline bool map4_128b(CUtensorMap* m, CUtensorMapDataType type, uint32_t es,
                      const void* base, const uint64_t (&n)[4],
                      const int64_t (&st)[3], uint32_t b1) {
  const EncodeTiled enc = encoder();
  if (!enc || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[4] = {n[0], n[1], n[2], n[3]};
  cuuint64_t strides[3], packed = n[0] * es;
  for (int i = 0; i < 3; ++i) {
    if (st[i] < 0 || (st[i] == 0 && n[i + 1] != 1) || (st[i] * es) % 16)
      return false;
    strides[i] = st[i] ? (cuuint64_t)st[i] * es : packed;
    packed *= n[i + 1];
  }
  const cuuint32_t box[4] = {128 / es, b1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(m, type, 4, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool bf16_map4(CUtensorMap* m, const void* base, const uint64_t (&n)[4],
                      const int64_t (&st)[3], uint32_t b1) {
  return map4_128b(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, n, st, b1);
}

// The same for an fp32 tensor: boxes of 32 x b1 x 1 x 1 elements (a box
// row is one 128-byte swizzle row, so a d-64 row takes two boxes).
inline bool f32_map4(CUtensorMap* m, const void* base, const uint64_t (&n)[4],
                     const int64_t (&st)[3], uint32_t b1) {
  return map4_128b(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, n, st, b1);
}

}  // namespace hop
