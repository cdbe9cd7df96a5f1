// Pieces shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): bf16 packing, the m16n8k16 tensor-core product,
// ldmatrix fragment loads, and the global -> shared tile loader (with
// cp.async, so that the next tile streams in while the block computes).
// The kernels take bf16 q, k, v and dO only: the tensor cores' input type,
// so no input is rounded on the way in.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 inputs): lane = 4 * g
// + t (g = lane >> 2, t = lane & 3).
//   A 16x16, four b32 registers: {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//     (g+8, 2t+8..)} as (row, column pair).
//   B 16x8 (k x n), two b32 registers: {(k 2t..2t+1, n g), (k 2t+8.., n g)}.
//   C 16x8 fp32, four registers: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// A C tile of 16 x 16 (two n-tiles) in fp32 becomes an A fragment of the
// next product by packing pairs to bf16, with no data movement.
//
// Shared tiles are row-major bf16 with LD = D + 8 elements a row: rows are
// 16-byte aligned for ldmatrix and the 8 rows an ldmatrix phase reads fall
// in 8 distinct 4-bank groups (LD / 2 = 4 mod 32 words), so loads are free
// of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -1e30f;      // finite mask value of the Pallas kernels
constexpr float kClamp = -1e25f;    // clamp of the subtracted max / lse
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A * B, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the address of row (i & 7) of matrix
// i >> 3. Without .trans lane (g, t) receives (row g, columns 2t, 2t+1) of
// each matrix; with .trans it receives (rows 2t, 2t+1, column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Per-lane row addresses of the x4 loads, for a 16 x 16 block whose top
// left is (r0, c0) in a row-major shared tile with LD elements a row.
//   a_addr: matrices (r0, c0), (r0+8, c0), (r0, c0+8), (r0+8, c0+8). Without
//     .trans: the A fragment of rows r0.., columns c0... With .trans on a
//     [k][n] tile (k rows): B fragments {b0b1, b2b3} of n-tile c0, then of
//     n-tile c0 + 8, for k = r0..r0+15.
//   b_addr: matrices (r0, c0), (r0, c0+8), (r0+8, c0), (r0+8, c0+8). Without
//     .trans on an [n][k] tile (n rows): B fragments {b0b1, b2b3} of n-tile
//     r0, then of n-tile r0 + 8, for k = c0..c0+15.
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int r0,
                                              int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0
         + (lane >> 4) * 8;
}

template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int r0,
                                              int c0, int lane) {
  return tile + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0
         + ((lane >> 3) & 1) * 8;
}

// cp.async: a 16-byte global -> shared copy that does not hold the
// thread; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ROWS x D bf16 tile from global rows `row_stride` elements apart into
// shared memory (LD elements a row) with cp.async, so the threads are not
// held; rows at or past n_valid are zero-filled. Neighbouring threads copy
// neighbouring 16-byte chunks of a row. The caller commits the group and
// waits for it before the barrier that publishes the tile.
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int64_t row_stride,
                                                int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < n_valid;
    cp_async16(dst + r * LD + c, ok ? src + r * row_stride + c : src,
               ok ? 16 : 0);
  }
}

// lets a kernel use more than 48 KB of dynamic shared memory
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The causal mask of the Pallas kernels, aligned bottom-right: query row r
// sees key column c when c <= r + off, off = sk - sq.
__device__ __forceinline__ bool visible(int row, int col, int sq, int sk,
                                        int off, bool causal) {
  return row < sq && col < sk && (!causal || col <= row + off);
}

}  // namespace flash
