// The keep mask of flash attention's in-kernel dropout, element by element:
// Philox4x32-10 (Salmon et al., SC 2011; the generator of Random123 and
// cuRAND's Philox). Its plain twin is paddle_tpu_torch/ops/kernels/philox.py;
// the two compute the same words, and the definition is the one there:
//   key (seed, offset); element (bh, row, col) of the [b*h, sq, sk] scores
//   takes word (col & 3) of the block at counter (col >> 2, row, bh, 0) and
//   is kept when that word is >= thresh = min(int(p * 2^32), 2^32 - 1).
// The mask depends on the element alone, so tile sizes never change it and
// the forward and both backward kernels draw it again instead of storing it.

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

}  // namespace flash
