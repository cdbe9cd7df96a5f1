// Pieces shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): bf16 packing, the m16n8k16 bf16 tensor-core
// product, ldmatrix fragment loads, the fp32 mode's 3xTF32 product, and the
// global -> shared tile loader (with cp.async, so that the next tile streams
// in while the block computes). The kernels take bf16 or fp32 q, k, v and
// dO, all of one type; no input is rounded to another type on the way in.
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
//
// fp32 mode (3xTF32). A product of fp32 operands keeps fp32 accuracy on the
// TF32 tensor cores when each operand is split into hi = tf32(x) and lo =
// tf32(x - hi) (round to nearest both times, so hi + lo is x to 2^-22 at
// worst, ~2^-24 typically) and the sum takes lo*hi + hi*lo + hi*hi in fp32
// (the dropped lo*lo is up to 2^-22 of the product). The backward's dP
// takes lo*lo as a fourth pass (mma4). mma.m16n8k8 with .tf32 inputs,
// per lane:
//   A 16x8: {(g, t), (g+8, t), (g, t+4), (g+8, t+4)};
//   B 8x8 (k x n): {(k t, n g), (k t+4, n g)};
//   C as above.
// ldmatrix has no 32-bit layout, so fragments come from plain shared
// loads. A C tile (16 x 8, lane holding columns 2t and 2t+1) feeds the next
// product as an A fragment with no shuffle by renaming the 8 keys of the
// k-step: logical column t is key 2t and t+4 is key 2t+1, so A = {c0, c2,
// c1, c3}, and the B operand reads rows 2t and 2t+1 to match. fp32 tiles
// take LD = D + 4 floats a row (16-byte rows; LD = 4 mod 32 words), which
// keeps both access patterns, (row g, column t) and (row 2t, column g),
// free of bank conflicts.
//
// Dropout (philox.cuh): each lane draws the keep bits of the score elements
// it holds, from (batch * head, query, key), in the forward and again in
// both backward kernels.
//
// Segment ids (the end of this file): tile skipping from per-grain id
// ranges, and the element test of a lane's ids.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

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

// ROWS x D tile (bf16 or fp32) from global rows `row_stride` elements
// apart into shared memory (LD elements a row) with cp.async, so the
// threads are not held; rows at or past n_valid are zero-filled.
// Neighbouring threads copy neighbouring 16-byte chunks of a row. The
// caller commits the group and waits for it before the barrier that
// publishes the tile.
template <int ROWS, int D, int LD, int NT, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int64_t row_stride,
                                                int n_valid) {
  constexpr int kPer = 16 / sizeof(T);   // elements in 16 bytes
  constexpr int kChunks = D / kPer;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Row pitch of a shared tile of head dim D (see the header comment).
template <typename T, int D>
struct Pitch {
  static constexpr int LD = std::is_same<T, float>::value ? D + 4 : D + 8;
};

// ---- fp32 mode: 3xTF32 products on mma.m16n8k8 ----

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// D += A * B, tf32 inputs, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 A fragment of mma.m16n8k8 split into its hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// D += A * B to fp32 accuracy, B = {b0, b1} in fp32. The three passes (the
// small terms first) sum into a fresh accumulator, which is then added to
// D on the CUDA cores: the tensor cores align a sum to its largest term
// and truncate, so a long chain of mma on one accumulator (a k loop over a
// whole sequence) drifts by up to an ulp of the running sum per step,
// while IEEE adds round to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a.lo, bh0, bh1);
  mma_tf32(part, a.hi, bl0, bl1);
  mma_tf32(part, a.hi, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += part[i];
}

// The A fragment of rows r0.., columns c0..c0+7 of a row-major fp32 tile.
template <int LD>
__device__ __forceinline__ FragA frag_a(const float* tile, int r0, int c0,
                                        int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * LD + c0 + (lane & 3);
  return split_a(p[0], p[8 * LD], p[4], p[8 * LD + 4]);
}

// mma3 and the fourth pass, lo*lo (the backward's dP, where a row that
// sees one key takes its dq and its key's dk from dP's rounding alone).
__device__ __forceinline__ void mma4(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a.lo, bl0, bl1);
  mma_tf32(part, a.lo, bh0, bh1);
  mma_tf32(part, a.hi, bl0, bl1);
  mma_tf32(part, a.hi, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += part[i];
}

typedef void (*MmaF32)(float (&)[4], const FragA&, float, float);

// acc[n] += A (16 rows at r0, D columns) . B[n0 + 8n .. + 8)^T for n < NT:
// both fp32 row-major tiles, B's rows the n index ([n][k]); each k-step
// by MMA (mma3, or mma4 for the backward's dP).
template <int NT, int D, int LD, MmaF32 MMA = mma3>
__device__ __forceinline__ void nt_product_f32(float (&acc)[NT][4],
                                               const float* A, int r0,
                                               const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const FragA a = frag_a<LD>(A, r0, ks * 8, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = B + (n * 8 + g) * LD + ks * 8 + t;
      MMA(acc[n], a, b[0], b[4]);
    }
  }
}

// acc[n] += C (16 x KT, C fragments c[kk] of 8 columns each) . B[0..KT) x
// [8n .. 8n + 8) for n < D / 8: B an fp32 row-major [k][n] tile. Each
// 8-column C fragment is an A operand with its keys renamed (see above).
template <int KT, int D, int LD>
__device__ __forceinline__ void nn_product_f32(float (&acc)[D / 8][4],
                                               const float (&c)[KT / 8][4],
                                               const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
    const FragA a = split_a(c[kk][0], c[kk][2], c[kk][1], c[kk][3]);
    const float* b = B + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) mma3(acc[n], a, b[n * 8], b[LD + n * 8]);
  }
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

// ---- segment-id mode (packed sequences, flash_attn_unpadded) ----
//
// A query sees a key only when their int32 segment ids are equal (after
// the causal test, as the Pallas kernels mask, :143-146). The wrapper
// summarises each grain of kSegGrain consecutive tokens as an int4
// (min id, max id, first, end): [first, end) are the grains of the other
// side (keys for a query grain, queries for a key grain) outside which no
// id can equal one of this grain's. A tile is a whole number of grains;
// a pair of tiles whose [min, max] ranges do not meet holds no kept
// pair, so the loops skip it, and they run only over the tiles that
// [first, end) touches. Both are right for any ids; for the sorted ids
// of cu_seqlens every tile in [first, end) is live, and every tile pair
// but those a segment boundary crosses holds one id, where the element
// test is left out.
constexpr int kSegGrain = 32;

struct SegRange {
  int lo, hi;        // min and max id of the tile
  int first, end;    // grains of the other side that can meet it
};

// The union of grains [g, g + N) of info, clipped at n_grains (a tile at
// the ragged end).
template <int N>
__device__ __forceinline__ SegRange seg_range(const int4* __restrict__ info,
                                              int g, int n_grains) {
  const int4 a = __ldg(info + g);
  SegRange r = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 1; i < N; ++i) {
    if (g + i < n_grains) {
      const int4 b = __ldg(info + g + i);
      r.lo = min(r.lo, b.x);
      r.hi = max(r.hi, b.y);
      r.first = min(r.first, b.z);
      r.end = max(r.end, b.w);
    }
  }
  return r;
}

// whether two [lo, hi] id ranges share an id
__device__ __forceinline__ bool ranges_meet(int alo, int ahi, int blo,
                                            int bhi) {
  return alo <= bhi && blo <= ahi;
}

// Which score elements of a lane share their ids, for a tile pair that
// holds more than one id: bit 4 * nt + 2 * c + r is set when the id of
// the lane's row r (ids[r]) equals that of column base + 8 * nt + 2 * t
// + c (the C fragment layout; columns at or past n read no id). One
// register carries the test through the tile's products.
template <int NT>
__device__ __forceinline__ uint32_t same_ids(const int* __restrict__ other,
                                             int base, int n,
                                             const int (&ids)[2], int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = base + nt * 8 + 2 * t + c;
      const int id = col < n ? __ldg(other + col) : INT_MIN;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bits |= (uint32_t)(ids[r] == id) << (4 * nt + 2 * c + r);
    }
  }
  return bits;
}

// the bit of same_ids for C fragment element i (of 4) of n-tile nt
__device__ __forceinline__ bool same_bit(uint32_t bits, int nt, int i) {
  return (bits >> (4 * nt + 2 * (i & 1) + (i >> 1))) & 1u;
}

// The walk of a block over the other side's tiles (G grains each) that
// can meet its own tile's ids [lo, hi], below end. A block loads the range
// of the tile after the next one while it computes the current one
// (range(), then live() on it later), so the common step of sorted ids
// waits on no load; next() is the slow step, for a tile that turns out
// dead. uniform(): both tiles hold one id, so every element pair of the
// tile pair shares it and the element test can be left out.
template <int G>
struct SegWalk {
  const int4* info;
  int n_grains, end, lo, hi;

  __device__ __forceinline__ SegRange range(int j) const {
    return seg_range<G>(info, j * G, n_grains);
  }
  __device__ __forceinline__ bool live(const SegRange& r) const {
    return ranges_meet(lo, hi, r.lo, r.hi);
  }
  // the first live tile at or after j (end if none), its range in r
  __device__ __forceinline__ int next(int j, SegRange& r) const {
    for (; j < end; ++j) {
      r = range(j);
      if (live(r)) break;
    }
    return j;
  }
  __device__ __forceinline__ bool uniform(const SegRange& r) const {
    return lo == hi && r.lo == r.hi;
  }
};

}  // namespace flash
