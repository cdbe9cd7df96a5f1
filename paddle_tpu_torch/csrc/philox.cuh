// The keep mask of flash attention's in-kernel dropout, element by element:
// Philox4x32-10 (Salmon et al., SC 2011; the generator of Random123 and
// cuRAND's Philox). Its plain twin is paddle_tpu_torch/ops/kernels/philox.py;
// the two compute the same words, and the definition is the one there:
//   key (seed, offset); element (bh, row, col) of the [b*h, sq, sk] scores
//   takes word (col & 3) of the block at counter (col >> 2, row, bh, 0) and
//   is kept when that word is >= thresh = min(int(p * 2^32), 2^32 - 1).
// The mask depends on the element alone, so tile sizes never change it and
// the forward and both backward kernels draw it again instead of storing it.
//
// Lane exchanges (keep_bits_qk, keep_bits_kq): in a tensor-core accumulator
// frame (mma.m16n8k16's C tile, a warp's slab of wgmma.m64n64's) lane
// (g = lane >> 2, t = lane & 3) holds rows g and g + 8 and columns 8 n + 2 t
// + {0, 1} of the chunks n = 0..7. A block holds the words of four
// neighbouring keys of one query, which that frame spreads over two or four
// lanes; each lane draws one block a chunk and the lanes trade words by
// shuffle, so every block is drawn once. Both return bit 4 n + i for the
// lane's element (n, i), i = 2 * (row g + 8) + (odd column), the order of
// the accumulator's registers, for the first NC chunks (8: an m64n64
// tile; 4: the 32 columns of the fp32 backward's m64n32 tiles).

#pragma once

#include <stdint.h>

namespace flash {

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// the keep bit of element (bh, row, col)
__device__ __forceinline__ bool drop_keep(int bh, int row, int col,
                                          uint32_t k0, uint32_t k1,
                                          uint32_t thresh) {
  const uint4 w = philox4x32_10((uint32_t)col >> 2, (uint32_t)row,
                                (uint32_t)bh, 0u, k0, k1);
  const int j = col & 3;
  const uint32_t word = j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  return word >= thresh;
}

// the keep bits of elements (bh, row, col) and (bh, row, col + 1) for an
// even col: both lie in one Philox block, so one call gives both
__device__ __forceinline__ void drop_keep2(int bh, int row, int col,
                                           uint32_t k0, uint32_t k1,
                                           uint32_t thresh, bool& keep0,
                                           bool& keep1) {
  const uint4 w = philox4x32_10((uint32_t)col >> 2, (uint32_t)row,
                                (uint32_t)bh, 0u, k0, k1);
  const bool upper = (col & 2) != 0;
  keep0 = (upper ? w.z : w.x) >= thresh;
  keep1 = (upper ? w.w : w.y) >= thresh;
}

// bit c: word c of block w is kept
__device__ __forceinline__ uint32_t keep_nibble(uint4 w, uint32_t thresh) {
  return (uint32_t)(w.x >= thresh) | (uint32_t)(w.y >= thresh) << 1
         | (uint32_t)(w.z >= thresh) << 2 | (uint32_t)(w.w >= thresh) << 3;
}

// Rows are queries (row0, row1: the lane's two), columns keys (col0: the
// key of the lane's chunk-0 column, 2 t past the tile's first key, a
// multiple of 4). Lanes t and t ^ 1 hold the four
// keys of one block: the even lane draws row0's block and keeps words 0, 1,
// the odd lane row1's and keeps words 2, 3, and each hands its partner the
// other two words.
template <int NC = 8>
__device__ __forceinline__ uint32_t keep_bits_qk(int bh, int row0, int row1,
                                                 int col0, uint32_t k0,
                                                 uint32_t k1, uint32_t thresh,
                                                 int lane) {
  const bool odd = lane & 1;
  const uint32_t row = (uint32_t)(odd ? row1 : row0);
  uint32_t all = 0;
#pragma unroll
  for (int n = 0; n < NC; ++n)
    all |= keep_nibble(philox4x32_10((uint32_t)(col0 + 8 * n) >> 2, row,
                                     (uint32_t)bh, 0u, k0, k1),
                       thresh) << (4 * n);
  // even: words 0, 1 are its row0 elements (i 0, 1), words 2, 3 the odd
  // lane's row0 (its i 0, 1); odd: words 2, 3 its row1 elements (i 2, 3),
  // words 0, 1 the even lane's row1 (its i 2, 3)
  const uint32_t own = all & (odd ? 0xCCCCCCCCu : 0x33333333u);
  const uint32_t give = odd ? (all << 2) & 0xCCCCCCCCu
                            : (all >> 2) & 0x33333333u;
  return own | __shfl_xor_sync(0xffffffffu, give, 1);
}

// The transposed frame: rows are keys (key0, key1: the lane's two; g & 3 is
// key & 3), columns queries (q0: the lane's chunk-0 query, 2 t past the
// tile's first). The four
// lanes j = g & 3 that share t and g >> 2 hold four neighbouring keys of the
// same queries, so they need four blocks a chunk (two queries by two key
// rows): lane j draws the block of its element i = j (query q0 + 8 n + (j &
// 1), key row j >> 1), whose word c belongs to lane c's element i = j.
template <int NC = 8>
__device__ __forceinline__ uint32_t keep_bits_kq(int bh, int key0, int key1,
                                                 int q0, uint32_t k0,
                                                 uint32_t k1, uint32_t thresh,
                                                 int lane) {
  const int j = (lane >> 2) & 3;
  const uint32_t blk = (uint32_t)((j & 2) ? key1 : key0) >> 2;
  const int q = q0 + (j & 1);
  uint32_t all = 0;
#pragma unroll
  for (int n = 0; n < NC; ++n)
    all |= keep_nibble(philox4x32_10(blk, (uint32_t)(q + 8 * n),
                                     (uint32_t)bh, 0u, k0, k1),
                       thresh) << (4 * n);
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {   // lane s's blocks: element i = s
    const uint32_t w = __shfl_sync(0xffffffffu, all, (lane & ~12) | (s << 2));
    out |= ((w >> j) & 0x11111111u) << s;
  }
  return out;
}

}  // namespace flash
