// The pieces of the fp32 flash kernels on TF32 wgmma (sm_90a, head_dim
// 64) that the forward (flash_fwd_tf32.cuh) and the backward
// (flash_bwd_tf32.cuh) share: the block's shape, the ring tiles of 32 rows,
// the producer's split of a landed tile into its tf32 hi and lo parts (and
// its transpose, in the renamed k order of the RS A fragment), and the
// 3xTF32 products: an m64n32 product over d 64 from shared memory
// (passes_small, pass_hh) and an m64n64 one with A from registers
// (acc_to_a_tf32, product_rs) into a fresh accumulator that the CUDA cores
// add to the running one (add_to). flash_bwd_tf32.cuh's header says why
// each is shaped so.

#pragma once

#include "flash_wg_common.cuh"

namespace flash_tf32 {

using flash_wg::Mode;
using flash_wg::kept;
using flash_wg::zero;

constexpr int kThreads = 384;            // consumers 0 and 1, producer 2
constexpr int kT = 32;                   // rows of a ring tile
constexpr uint32_t kAtomT = kT * 128;    // one 32-column atom of a ring tile
constexpr uint32_t kTile = 2 * kAtomT;   // a ring tile, d 64: 8 KB
constexpr uint32_t kTrans = 64 * 128;    // its transpose: 64 rows of 32
constexpr int kSplitThreads = 128;       // the producer warpgroup

// x becomes its tf32 hi; returns the rest, rounded to tf32
__device__ __forceinline__ float split1(float& x) {
  uint32_t h, l;
  flash::split_tf32(x, h, l);
  x = __uint_as_float(h);
  return __uint_as_float(l);
}

__device__ __forceinline__ float4 split4(float4& x) {
  return make_float4(split1(x.x), split1(x.y), split1(x.z), split1(x.w));
}

// shared-memory accesses of the split by 32-bit address (the producer
// has few registers for 64-bit pointers)
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(a), "f"(v) : "memory");
}

// A resident tile of `bytes` at shared address p in place into hi, and lo
// at the same offsets from `lo` (the same swizzled layout), by the
// producer's thread i.
__device__ __forceinline__ void split_plain(uint32_t p, uint32_t lo,
                                            int bytes, int i) {
#pragma unroll 1
  for (int o = 16 * i; o < bytes; o += 16 * kSplitThreads) {
    float4 x = lds4(p + o);
    const float4 l = split4(x);
    sts4(p + o, x);
    sts4(lo + o, l);
  }
}

// The column of a transposed tile that holds tile row r: the renamed k
// order of the RS A fragment (hopper.cuh), within each group of 8 the even
// rows first
__device__ __forceinline__ int renamed(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// A ring tile at p (32 rows x 64 columns: two atoms) split as split_plain,
// and, with TRANS, its transpose (64 rows of 32: row c holds column c of
// the tile) hi at th and lo at tl, tile row r = lane at column col
// (renamed(lane)). Lane = tile row, so a warp's transposed stores fill one
// 128-byte row, free of bank conflicts; warp w takes logical chunks 4
// w..4 w + 3 of the 16 in a row.
template <bool TRANS>
__device__ __forceinline__ void split_tile(uint32_t p, uint32_t lo,
                                           uint32_t th, uint32_t tl,
                                           int warp, int lane, int col) {
  const int r = lane;
#pragma unroll 1                 // the producer's 40 registers: no hoisting
  for (int i = 0; i < 4; ++i) {
    const int cc = 4 * warp + i, atom = cc >> 3, c = cc & 7;
    const uint32_t o = atom * kAtomT + hop::swz(r, c);
    float4 x = lds4(p + o);
    const float4 l = split4(x);
    sts4(p + o, x);
    sts4(lo + o, l);
    if constexpr (TRANS) {
      const float hv[4] = {x.x, x.y, x.z, x.w}, lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int drow = 32 * atom + 4 * c + e;
        const uint32_t to = hop::swz(drow, col >> 2) + (col & 3) * 4;
        sts(th + to, hv[e]);
        sts(tl + to, lv[e]);
      }
    }
  }
}

// The small passes of an m64n32 product over d 64 into d, which they
// start (its old values are not read): lo*lo (FOUR, dP's fourth pass),
// lo*hi and hi*lo, each over the 8 k-steps. a, b: the hi tiles' start
// addresses (two atoms `a_atom` / kAtomT bytes apart), a_lo, b_lo: the lo
// tiles'.
template <bool FOUR>
__device__ __forceinline__ void passes_small(float (&d)[4][4], uint32_t a,
                                             uint32_t a_lo, uint32_t a_atom,
                                             uint32_t b, uint32_t b_lo) {
  const uint32_t as[2] = {a_lo, a}, bs[2] = {b_lo, b};
  constexpr int first = FOUR ? 0 : 1;
#pragma unroll
  for (int pass = first; pass < 3; ++pass)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = hop::desc(as[pass >> 1] + c * a_atom + ks * 32);
        const uint64_t db = hop::desc(bs[pass & 1] + c * kAtomT + ks * 32);
        if (pass == first && c == 0 && ks == 0)
          hop::wgmma32_tf32<false>(d, da, db);
        else
          hop::wgmma32_tf32(d, da, db);
      }
}

// The hi*hi pass over the 4 k-steps of atom c into d (S: one chain)
__device__ __forceinline__ void pass_hh(float (&d)[4][4], uint32_t a,
                                        uint32_t a_atom, uint32_t b, int c) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    hop::wgmma32_tf32(d, hop::desc(a + c * a_atom + ks * 32),
                      hop::desc(b + c * kAtomT + ks * 32));
}

// An accumulator of 32 columns (4 chunks) as the tf32 A operand of 4
// k-steps, split: hi[kk], lo[kk] = chunk kk, renamed (hopper.cuh)
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4][4],
                                              uint32_t (&lo)[4][4],
                                              const float (&d)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float v[4] = {d[kk][0], d[kk][2], d[kk][1], d[kk][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) flash::split_tf32(v[i], hi[kk][i], lo[kk][i]);
  }
}

// part[64 x 64] = A[64 x 32] B (part's old values not read; with FRESH
// false, += them), A from registers (acc_to_a_tf32), B the transposed hi
// (th) and lo (tl) tiles: lo*hi, hi*lo, hi*hi. TIED: part keeps its
// registers (hop::wgmma64_tf32_rs).
template <bool FRESH = true, bool TIED = false>
__device__ __forceinline__ void product_rs(float (&part)[8][4],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint32_t th, uint32_t tl) {
  hop::wgmma64_tf32_rs<!FRESH, TIED>(part, lo[0], hop::desc(th));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    hop::wgmma64_tf32_rs(part, lo[kk], hop::desc(th + kk * 32));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma64_tf32_rs(part, hi[kk], hop::desc(tl + kk * 32));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma64_tf32_rs(part, hi[kk], hop::desc(th + kk * 32));
}

__device__ __forceinline__ void add_to(float (&acc)[8][4],
                                       const float (&part)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
}

}  // namespace flash_tf32
