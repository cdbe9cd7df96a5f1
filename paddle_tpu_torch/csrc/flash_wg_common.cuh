// The pieces that the bf16 wgmma flash kernels (flash_fwd_wgmma.cuh,
// flash_bwd_wgmma.cuh) and the fp32 TF32 wgmma ones (flash_fwd_tf32.cuh,
// flash_bwd_tf32.cuh) share: the block's shape (two consumer warpgroups
// and a producer), 128B-swizzled tile atoms, the shared-memory base, the
// bias and dropout arguments (Mode), and the fragment helpers of those
// modes.

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace flash_wg {

using flash::bf16;

constexpr int kThreads = 384;            // consumers 0 and 1, producer 2
constexpr int kRows = 128;               // a block's rows (keys in dK/dV)
constexpr uint32_t kAtom = 8192;         // 64 rows x 128 bytes
constexpr int kConsumerWarps = 8;        // arrivals that empty a stage

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
}

// 2^x on the special-function unit (ex2.approx.ftz: ~2^-22 relative, far
// below P's bf16 rounding; results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the dynamic shared memory, rounded up to 1024 bytes (swizzle atoms)
__device__ __forceinline__ unsigned char* tiles() {
  extern __shared__ __align__(16) unsigned char wg_smem[];
  return wg_smem + ((1024 - (hop::smem_u32(wg_smem) & 1023)) & 1023);
}

// The arguments of the bias and dropout modes: an fp32 bias, element (b,
// h, q, k) at bias[b_sb b + b_sh h + b_sq q + b_sk k] (a broadcast
// dimension: stride 0), and the Philox key (seed, offset) on the device
// with its threshold and 1 / (1 - p)
struct Mode {
  const float* bias;
  int64_t b_sb, b_sh, b_sq, b_sk;
  const int64_t* seed;
  uint32_t thresh;
  float inv_keep;
};

// HAS_BIAS: the bias of accumulator chunk n, elements [n][i] at p[i >> 1]
// + (8 n + (i & 1)) st, read where their column c0 + 8 n + (i & 1) lies
// below `end` (0 past it, where P is masked)
__device__ __forceinline__ void bias_chunk(float (&b)[4],
                                           const float* const (&p)[2],
                                           int64_t st, int n, int c0,
                                           int end) {
  const int c = c0 + 8 * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* e = p[r] + (int64_t)(8 * n) * st;
    b[2 * r] = c < end ? __ldg(e) : 0.f;
    b[2 * r + 1] = c + 1 < end ? __ldg(e + st) : 0.f;
  }
}

// DROP: x scaled by 1 / (1 - p) where bit `bit` of keep is set, else 0
__device__ __forceinline__ float kept(float x, uint32_t keep, int bit,
                                      float inv_keep) {
  return (keep >> bit) & 1u ? x * inv_keep : 0.f;
}

// acc_to_a of the dropped accumulator: element [n][i] kept by bit 4 n + i
__device__ __forceinline__ void acc_to_a_kept(uint32_t (&a)[4][4],
                                              const float (&d)[8][4],
                                              uint32_t keep, float ik) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 2 * kk + h;
      a[kk][2 * h] = hop::pack2(kept(d[n][0], keep, 4 * n, ik),
                                kept(d[n][1], keep, 4 * n + 1, ik));
      a[kk][2 * h + 1] = hop::pack2(kept(d[n][2], keep, 4 * n + 2, ik),
                                    kept(d[n][3], keep, 4 * n + 3, ik));
    }
}

// keep the compiler from reusing an RS product's A registers before the
// wgmma.wait_group that covers the product
__device__ __forceinline__ void frag_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]) :: "memory");
}

// The heads of a forward's block group (fwd_wgmma_kernel,
// flash_tf32::fwd_tf32_kernel): as many as keep their K and V within
// kGroupBytes, so that the blocks in flight (a wave is 132) read them from
// the 50 MB L2 and not each from memory.
constexpr int64_t kGroupBytes = 16 << 20;

// the tensor map of a strided [b, s, h, d] bf16 tensor (element strides
// sb, ss, sh), read in boxes of `rows` rows of 64 columns
template <int D>
bool map_bshd(CUtensorMap* m, const void* p, int64_t b, int64_t s, int64_t h,
              int64_t sb, int64_t ss, int64_t sh, uint32_t rows) {
  const uint64_t n[4] = {(uint64_t)D, (uint64_t)s, (uint64_t)h, (uint64_t)b};
  const int64_t st[3] = {ss, sh, sb};
  return hop::bf16_map4(m, p, n, st, rows);
}

}  // namespace flash_wg
