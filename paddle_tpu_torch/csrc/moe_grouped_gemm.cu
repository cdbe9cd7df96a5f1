// The fused grouped-GEMM MoE dispatch: the port of
// paddle_tpu/ops/pallas/moe_grouped_gemm.py, forward (_fwd_call, its
// pallas_call at :263), dX (_dx_call, :371) and dW (_dw_call, :485).
//
// Slot (e, s) of the [E, cpad] maps names its token row_id (T: empty) and
// its combine weight gate_w (0 when empty). With x [T, D], W_in and W_gate
// [E, D, H], W_out [E, H, D], all of one type X (bf16 or fp32), per slot:
//   h1 = x[row] W_in[e], hg = x[row] W_gate[e]   (fp32 sums)
//   h  = act(hg) * h1 (gated) or act(h1), rounded to X
//   y  = h W_out[e] (fp32), out[row] += gate_w * y (fp32 scatter-add)
//   dX: dgw = <g[row], y>; dy = X(g[row] * gate_w); dh = dy W_out[e]^T;
//       dh1 = X(dh * act(hg)), dhg = X(dh * h1 * act'(hg)) (gated) or
//       dh1 = X(dh * act'(h1)); dx[row] += dh1 W_in[e]^T + dhg W_gate[e]^T
//   dW: per expert, over its slots, dW_in = x^T dh1, dW_gate = x^T dhg,
//       dW_out = h^T dy, fp32 sums rounded once to X.
// These are the Pallas kernels' rounding points (casts to x's dtype, so in
// fp32 nothing is rounded). An empty slot adds 0: the kernels zero its x
// and g rows (the Pallas kernels gather row T - 1 and multiply by its gate
// weight 0) and skip slot blocks that hold no token.
//
// What bounds them on the H100: the tensor cores. At the Qwen2-MoE shapes
// (T 8192, D 1024, H 704, E 16, cpad 1280) the forward is 3 products of
// 2 x 20480 x 1024 x 704 (88.6 GFLOP if every slot were full, 0.09 ms at
// 989 TFLOP/s), dX and dW 6 each. fp32 products run at 3xTF32's
// fp32-accurate 494.7 / 3 TFLOP/s at best. What differs from the TPU:
// - The TPU grid is sequential, so its read-modify-write scatter-add is
//   race-free. Hopper blocks run in parallel: the scatter-add is an fp32
//   atomicAdd into a zeroed [T, D] buffer. A token row gets at most two
//   contributions (its top-2 copies) onto 0, and 0 + a + b == 0 + b + a
//   exactly in IEEE fp32, so the result does not depend on the schedule.
// - The TPU kept h in VMEM between its two products. Here each pass is a
//   few launches: the forward writes h ([E * cpad, H] in X) between a
//   gather-LHS launch and a W_out launch with the scatter epilogue; dX
//   writes h, dh1 and dhg for the dW launch to read (the values the Pallas
//   dW pass recomputes) and reduces <g, y> over the D tiles in a fixed
//   order; dW gives each block one output tile of one expert's dW and
//   loops over that expert's slots: no atomics there.
//
// bf16 forward, dX and dW (dx_h_wgmma_kernel, dx_out_wgmma_kernel, each
// with a FWD mode, and dw_wgmma_kernel): Hopper's wgmma.m64n64k16 on
// 128B-swizzled shared tiles (hopper.cuh), fed by a ring of 3 or 4 stages
// with full / empty mbarriers. A block (one an SM: the ring takes 97-225
// KB of shared memory) is two consumer
// warpgroups (64 rows each: 128 slots in dX, 128 D columns in dW) and a
// producer. The dense operands (the expert weights; h, dh1 and dhg in [E,
// cpad, H]) come by TMA, whose zero fill covers H = 704 = 11 x 64, H 32
// or 96 and the last slot block. The gathered rows (x[row], g[row]) have
// no TMA on sm_90a (TMA's row gather is sm_100's): a producer warpgroup
// copies them with cp.async into the same swizzled layout, and the copies
// arrive on the stage's full barrier as they land; the consumer fences
// them for the async proxy after its wait. dy = bf16(g[row] * gate_w) is
// made in place by the consumer warpgroup that reads it, before the
// chunk's products. Each chunk's wgmma group is drained before the next
// (drain_chunk).
// - dX pass 1 (block: 128 slots x 64 H columns, 4 stages): x W_in,
//   x W_gate and dy W_out^T over K = D, three 64 x 64 accumulators a
//   warpgroup, then h, dh1, dhg; a block without tokens writes their zeros.
//   The forward's pass 1 (FWD, 4 stages of 6 tiles): 128
//   slots x 128 H columns, x W_in and x W_gate alone (no g gather, no
//   W_out tile), writing h; setmaxnreg gives the gatherers' registers to
//   the consumers (four 64 x 64 accumulators a warpgroup).
// - dX pass 2 (128 slots x 64 D columns, every operand by TMA, 3 stages):
//   dh1 W_in^T + dhg W_gate^T and y = h W_out over K = H; dx by float2
//   atomicAdd, and this D tile's share of <g, y> for dgw_reduce_kernel.
//   The forward's pass 2 (FWD, 4 stages): y = h W_out alone, then
//   out[row] += gate_w y by float2 atomicAdd.
// - dW (128 D columns x 64 H columns of one expert, 3 stages): x^T dh1,
//   x^T dhg and dW_out^T's transpose h^T dy over the expert's 64-slot
//   chunks up to the last that holds a token (a chunk without tokens
//   before it passes through the ring with no loads and no products).
// What bounds them: not the tensor cores. At the Qwen2-MoE shapes they
// run at 200-290 TFLOP/s, and a chunk of 128 x 64 x 64 (x3) takes about a
// microsecond and a half, of which the products are a quarter. The
// 64-column tiles read each operand from shared memory at the SM's 128
// bytes a clock and reread the gathered rows for every 64 columns; the
// ring's loads (gathers most) set the pace. Wider tiles (m64n128) and a
// persistent grid were tried and measured slower (PERF.md).
// fp32 forward, dX and dW (dx_h_tf32_kernel and dx_out_tf32_kernel, each
// with a FWD mode, and dw_tf32_kernel):
// TF32 wgmma, each product to fp32 accuracy by three passes (lo*hi, hi*lo,
// hi*hi of x = hi + lo, both rounded to tf32: flash_common.cuh split_tf32;
// flash_tf32_common.cuh product_rs)
// into a fresh accumulator that the CUDA cores add to the running one, so
// that no truncating tensor-core sum spans more than one 32-deep chunk
// (ROADMAP C6). TF32 wgmma has no transpose bit (hopper.cuh): B is K-major
// in shared memory, hi and lo, and A comes from registers (the RS form),
// loaded by each consumer thread from the landed tile in whatever layout
// it has and split there: no operand a warpgroup reads is split twice, and
// the gathered rows need no copy of their own. The B operands are split
// (and where needed transposed) once a call by split_hilo_kernel into
// scratch that the wrapper allocates: the forward W_in^T, W_gate^T, W_out^T
// (hi and lo of 3 x [E, D, H] fp32); dX the three weights, each as [E, H,
// D] for pass 1 and [E, D, H] for pass 2 (hi and lo of 4 x [E, D, H] fp32
// a weight); dW the transposes [E, H, cpad] of h, dh1, dhg. The rings are
// 32-deep chunks (the hi / lo B tiles fill a stage); blocks as in bf16, two
// consumer warpgroups of 64 output rows and a producer:
// - dX pass 1 (128 slots x 64 H columns, K = D, 2 stages): A = x, dy = g *
//   gate_w (cp.async gathers), B = W_in^T, W_gate^T, W_out; h, dh1, dhg; a
//   block without tokens returns (the wrapper zeroes inter). The forward's
//   pass 1 (FWD): 128 slots x 128 H columns, two 64-column halves, so that
//   each split x fragment feeds four products (gated); no g, no W_out;
//   writes h.
// - dX pass 2 (128 slots x 64 D columns, K = H, every operand by TMA, 2
//   stages): A = dh1, dhg (one fresh accumulator for both), h; B = W_in,
//   W_gate, W_out^T. The forward's pass 2 (FWD, 4 stages): y = h W_out
//   alone (B = W_out^T) over 128 D columns (each split h fragment feeds two
//   products), then out[row] += gate_w y by float2 atomicAdd. Both passes
//   skip the same slot blocks (those without a token), so pass 2 never
//   reads an h row that pass 1 left unwritten.
// - dW (128 D columns x 64 H columns of one expert, K = its slots): A =
//   x^T, dy^T from the gathered rows (a padded layout that the transposed
//   fragment loads read without bank conflicts), B = dh1^T, dhg^T, h^T;
//   dW_out is stored transposed from its [d][j] accumulator.
// H need only be a multiple of 32: columns past H are zero-filled by TMA
// and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tf32_common.cuh"
#include "hopper.cuh"

namespace {

using flash::bf16;

constexpr int kT = 64;            // D and slot-count granule (dims_ok)

struct Dims {
  int T, D, H, E, cpad, act, gated;
};

__device__ __forceinline__ float act_f(int act, float v) {
  return act == 0 ? v * (1.f / (1.f + expf(-v))) : fmaxf(v, 0.f);
}

__device__ __forceinline__ float dact_f(int act, float v) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-v));
    return s * (1.f + v * (1.f - s));
  }
  return v > 0.f ? 1.f : 0.f;
}

// The N slots of block sb of expert e: their token rows (-1 for an empty
// slot or one past cpad) and combine weights, in shared memory. Returns
// whether any slot holds a token (the same answer for every thread).
template <int N>
__device__ __forceinline__ bool slot_rows(const int* row_id,
                                          const float* gate_w, int e, int sb,
                                          const Dims& d, int* rows,
                                          float* gw) {
  const int tid = threadIdx.x;
  bool live = false;
  if (tid < N) {
    const int s = sb * N + tid;
    int row = -1;
    float w = 0.f;
    if (s < d.cpad) {
      const int64_t i = (int64_t)e * d.cpad + s;
      const int r = row_id[i];
      if (r >= 0 && r < d.T) {
        row = r;
        w = gate_w[i];
      }
    }
    rows[tid] = row;
    gw[tid] = w;
    live = row >= 0;
  }
  return __syncthreads_or(live) != 0;
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// Accumulator element i of n-tile n of the calling lane: its row and
// column in the 64 x 64 tile (the C layout of mma.m16n8k16 and k8).
__device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return warp * 16 + (lane >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int lane, int n, int i) {
  return n * 8 + (lane & 3) * 2 + (i & 1);
}

__global__ void dgw_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ dgw, int n_slots,
                                  int n_tiles) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  float v = 0.f;
  for (int t = 0; t < n_tiles; ++t) v += part[(int64_t)t * n_slots + s];
  dgw[s] = v;
}

// ---- bf16 dX and dW on Hopper: wgmma fed by a TMA / cp.async ring ----

constexpr int kM = 128;               // dX slots a tile: 2 warpgroups x 64
constexpr int kConsumers = 256;       // warpgroups 0 and 1: the products
constexpr int kGatherers = 128;       // warpgroup 2: cp.async gathers + TMA
constexpr uint32_t kTile = 8192;      // 64 rows x 128 bytes

// Byte offsets in one stage of the ring (every tile 1024-byte aligned),
// and the ring's depth (STAGES x BYTES + 1024 bytes of dynamic shared
// memory and the kernel's static arrays fit the 227 KB of a block).
// dX pass 1: x and g rows [128 slots][64 d] (gathered); W_in, W_gate [64
// d][64 j] (MN-major B), W_out [64 j][64 d] (K-major B).
struct P1 {
  enum : uint32_t { X = 0, G = 2 * kTile, WI = 4 * kTile, WG = 5 * kTile,
                    WO = 6 * kTile, BYTES = 7 * kTile, STAGES = 4 };
};
// The forward's pass 1: x rows [128 slots][64 d] (gathered); W_in, W_gate
// [64 d][128 j] as two [64][64] tiles each (MN-major B). No g, no W_out: a
// stage of 6 tiles, 4 deep.
struct P1F {
  enum : uint32_t { X = 0, G = 0, WI = 2 * kTile, WG = 4 * kTile, WO = 0,
                    BYTES = 6 * kTile, STAGES = 4 };
};
// dX pass 2: dh1, dhg, h [128 slots][64 j] (K-major A); W_in, W_gate [64
// d][64 j] (K-major B), W_out [64 j][64 d] (MN-major B).
struct P2 {
  enum : uint32_t { DH1 = 0, DHG = 2 * kTile, H = 4 * kTile, WI = 6 * kTile,
                    WG = 7 * kTile, WO = 8 * kTile, BYTES = 9 * kTile,
                    STAGES = 3 };
};
// The forward's pass 2: h [128 slots][64 j] (K-major A), W_out [64 j][64 d]
// (MN-major B).
struct P2F {
  enum : uint32_t { DH1 = 0, DHG = 0, H = 0, WI = 0, WG = 0, WO = 2 * kTile,
                    BYTES = 3 * kTile, STAGES = 4 };
};
// dW: x and g rows [64 slots][128 d] as two [64][64] tiles (MN-major A of
// x^T; g becomes the MN-major B dy); dh1, dhg, h [64 slots][64 j] (MN-major
// B of x^T dh1, x^T dhg; MN-major A of h^T dy).
struct PW {
  enum : uint32_t { X = 0, G = 2 * kTile, DH1 = 4 * kTile, DHG = 5 * kTile,
                    H = 6 * kTile, BYTES = 7 * kTile, STAGES = 3 };
};

// The ring's barriers. Chunk k takes stage k % S. full completes when the
// stage holds its chunk (the producer's arrivals and the TMA bytes), empty
// when the 8 consumer warps are done with it.
template <int S>
struct Ring {
  uint64_t full[S], empty[S];
  __device__ uint32_t f(int k) const { return hop::smem_u32(&full[k % S]); }
  __device__ uint32_t e(int k) const { return hop::smem_u32(&empty[k % S]); }
  __device__ static uint32_t parity(int k) { return (k / S) & 1; }
  __device__ void init(uint32_t full_count) {
    for (int s = 0; s < S; ++s) {
      hop::mbar_init(hop::smem_u32(&full[s]), full_count);
      hop::mbar_init(hop::smem_u32(&empty[s]), kConsumers / 32);
    }
    hop::mbar_init_fence();
  }
};

// the ring's tiles: dynamic shared memory, rounded up to 1024 bytes
__device__ __forceinline__ unsigned char* ring_tiles() {
  extern __shared__ __align__(16) unsigned char ring_raw[];
  return ring_raw + ((1024 - (hop::smem_u32(ring_raw) & 1023)) & 1023);
}

// A consumer's wait for chunk k whose stage holds gathered rows: they
// were written by cp.async (the generic proxy), so fence before wgmma
// reads them.
template <int S>
__device__ __forceinline__ void wait_gathered(const Ring<S>& ring, int k) {
  hop::mbar_wait(ring.f(k), Ring<S>::parity(k));
  hop::proxy_fence();
}

// Commit chunk k's wgmma group, wait for it, and hand its stage back to
// the producer (one arrival per consumer warp). Draining each chunk was
// measured faster than keeping one group in flight across chunks: a
// consumer then holds one stage, not two, so the producer runs a stage
// further ahead; and no other instruction runs while a group is in flight
// (dy is made before the chunk's products), where ptxas had serialised
// the wgmmas of dX's first pass.
template <int S>
__device__ __forceinline__ void drain_chunk(const Ring<S>& ring, int k,
                                            int lane) {
  hop::wg_commit();
  hop::wg_wait<0>();
  if (lane == 0) hop::mbar_arrive(ring.e(k));
}

// dy = bf16(g * gw[row]) in place over one warpgroup's 64-row tile (its
// 128 threads, 4 chunks each; a chunk's row is its offset / 128, whatever
// the swizzle), fenced for wgmma and synchronised over the warpgroup.
__device__ __forceinline__ void make_dy(unsigned char* tile, const float* gw,
                                        int wg, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = t + 128 * i;
    uint4* q = reinterpret_cast<uint4*>(tile + p * 16);
    uint4 v = *q;
    bf16* e = reinterpret_cast<bf16*>(&v);
    const float w = gw[p >> 3];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * w);
    *q = v;
  }
  hop::proxy_fence();
  hop::bar_sync(1 + wg, 128);
}

// ---- pass 1 of dX (h, dh1, dhg) and, with FWD, of the forward (h).
// Block (jt, sb, e): slots sb*128.., H columns jt*BJ..; K = D in 64-deep
// chunks. Consumer warpgroup wg takes slots 64 wg.. of the block. GATED is
// d.gated as a compile-time branch: ptxas serialises the wgmmas of a kernel
// whose products sit under a run-time one. FWD drops the g gather, the
// W_out tile and the dy W_out^T product, writes h alone, and takes 128 H
// columns a block (BJ), two 64-column halves, so that each gathered x row
// feeds twice the products (with 64 the gathers set its pace: PERF.md).
template <bool GATED, bool FWD>
__global__ void __launch_bounds__(kConsumers + kGatherers, 1)
    dx_h_wgmma_kernel(const bf16* __restrict__ x,
                      const int* __restrict__ row_id,
                      const float* __restrict__ gate_w,
                      const bf16* __restrict__ g, bf16* __restrict__ h_out,
                      bf16* __restrict__ dh1_out, bf16* __restrict__ dhg_out,
                      Dims d, const __grid_constant__ CUtensorMap tm_wi,
                      const __grid_constant__ CUtensorMap tm_wg,
                      const __grid_constant__ CUtensorMap tm_wo) {
  using L = typename std::conditional<FWD, P1F, P1>::type;
  constexpr int S = L::STAGES;
  constexpr int NJ = FWD ? 2 : 1, BJ = 64 * NJ;   // H columns a block
  __shared__ Ring<S> ring;
  __shared__ int rows[kM];
  __shared__ float gw[kM];
  const int jt = blockIdx.x, sb = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  if (!slot_rows<kM>(row_id, gate_w, e, sb, d, rows, gw)) {
    for (int i = tid; i < kM * BJ / 8; i += blockDim.x) {   // zero them
      const int s = sb * kM + i / (BJ / 8), c = jt * BJ + i % (BJ / 8) * 8;
      if (s >= d.cpad || c >= d.H) continue;
      const int64_t o = ((int64_t)e * d.cpad + s) * d.H + c;
      const uint4 z = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(h_out + o) = z;
      if constexpr (!FWD) {
        *reinterpret_cast<uint4*>(dh1_out + o) = z;
        if constexpr (GATED) *reinterpret_cast<uint4*>(dhg_out + o) = z;
      }
    }
    return;
  }
  unsigned char* tiles = ring_tiles();
  const uint32_t base = hop::smem_u32(tiles);
  if (tid == 0) ring.init(kGatherers + 1);
  __syncthreads();
  const int nk = d.D / 64;
  if (tid >= kConsumers) {                       // the producer warpgroup
    if constexpr (FWD) hop::reg_dealloc<56>();
    const int t = tid - kConsumers;
    constexpr uint32_t kTma = (NJ * (GATED ? 2 : 1) + (FWD ? 0 : 1)) * kTile;
    for (int k = 0; k < nk; ++k) {
      hop::mbar_wait(ring.e(k), Ring<S>::parity(k) ^ 1);
      const uint32_t st = base + (k % S) * L::BYTES, full = ring.f(k);
      if (t == 0) {
        hop::mbar_arrive_tx(full, kTma);
        for (int h = 0; h < NJ; ++h) {
          hop::tma_load3(st + L::WI + h * kTile, &tm_wi, full,
                         jt * BJ + h * 64, k * 64, e);
          if constexpr (GATED)
            hop::tma_load3(st + L::WG + h * kTile, &tm_wg, full,
                           jt * BJ + h * 64, k * 64, e);
        }
        if constexpr (!FWD) hop::tma_load3(st + L::WO, &tm_wo, full, k * 64, jt * 64, e);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = t + kGatherers * i, r = idx >> 3, c = idx & 7;
        const int row = rows[r];
        const int64_t o = (int64_t)(row < 0 ? 0 : row) * d.D + k * 64 + c * 8;
        hop::cp16(st + L::X + hop::swz(r, c), x + o, row < 0 ? 0 : 16);
        if constexpr (!FWD)
          hop::cp16(st + L::G + hop::swz(r, c), g + o, row < 0 ? 0 : 16);
      }
      hop::cp_arrive(full);
    }
    return;
  }
  if constexpr (FWD) hop::reg_alloc<224>();
  const int wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3,
            lane = tid & 31;
  float a1[NJ][8][4], ag[NJ][8][4], adh[8][4];
#pragma unroll
  for (int h = 0; h < NJ; ++h) {
    zero(a1[h]);
    zero(ag[h]);
  }
  zero(adh);
  for (int k = 0; k < nk; ++k) {
    wait_gathered(ring, k);
    const uint32_t st = base + (k % S) * L::BYTES;
    const uint32_t xa = st + L::X + wg * kTile, ga = st + L::G + wg * kTile;
    if constexpr (!FWD) make_dy(tiles + (ga - base), gw + 64 * wg, wg, t);
    hop::wg_fence();
#pragma unroll
    for (int h = 0; h < NJ; ++h) {
      hop::wgmma_chunk<0, 1>(a1[h], xa, st + L::WI + h * kTile);
      if constexpr (GATED)
        hop::wgmma_chunk<0, 1>(ag[h], xa, st + L::WG + h * kTile);
    }
    if constexpr (!FWD) hop::wgmma_chunk<0, 0>(adh, ga, st + L::WO);
    drain_chunk(ring, k, lane);
  }
#pragma unroll
  for (int h = 0; h < NJ; ++h) {
    hop::acc_fence(a1[h]);
    hop::acc_fence(ag[h]);
  }
  hop::acc_fence(adh);
#pragma unroll
  for (int h = 0; h < NJ; ++h)
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int s = sb * kM + 64 * wg + acc_row(warp, lane, i);
      const int c = jt * BJ + 64 * h + acc_col(lane, n, i);
      if (s >= d.cpad || c >= d.H) continue;
      const int64_t o = ((int64_t)e * d.cpad + s) * d.H + c;
      float hv[2], d1[2], dg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float h1 = a1[h][n][i + j], hg = ag[h][n][i + j],
                    dh = adh[n][i + j];
        if constexpr (FWD) {   // h = act(hg) * h1, or act(h1)
          hv[j] = GATED ? act_f(d.act, hg) * h1 : act_f(d.act, h1);
          continue;
        }
        const float act = act_f(d.act, GATED ? hg : h1);
        hv[j] = GATED ? act * h1 : act;
        d1[j] = GATED ? dh * act : dh * dact_f(d.act, h1);
        dg[j] = GATED ? dh * h1 * dact_f(d.act, hg) : 0.f;
      }
      flash::store2(h_out + o, hv[0], hv[1]);
      if constexpr (!FWD) {
        flash::store2(dh1_out + o, d1[0], d1[1]);
        if constexpr (GATED) flash::store2(dhg_out + o, dg[0], dg[1]);
      }
    }
}

// ---- pass 2 of dX: dx[row] += dh1 W_in^T + dhg W_gate^T, y = h W_out
// and this D tile's share of dgw; with FWD, of the forward: y = h W_out
// alone and out[row] += gate_w y (out in dx's place; no g, no part, no
// dh1, dhg, W_in, W_gate). Block (dt, sb, e): slots sb*128.., D
// columns dt*64..; K = H. Every operand comes by TMA: the producer is one
// thread. (128 D columns a block measured no faster in the forward: its
// operands all come by TMA, PERF.md.)
template <bool GATED, bool FWD>
__global__ void __launch_bounds__(kConsumers + 32, 1) dx_out_wgmma_kernel(
    const int* __restrict__ row_id, const float* __restrict__ gate_w,
    const bf16* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ part, Dims d,
    const __grid_constant__ CUtensorMap tm_wi,
    const __grid_constant__ CUtensorMap tm_wg,
    const __grid_constant__ CUtensorMap tm_wo,
    const __grid_constant__ CUtensorMap tm_dh1,
    const __grid_constant__ CUtensorMap tm_dhg,
    const __grid_constant__ CUtensorMap tm_h) {
  using L = typename std::conditional<FWD, P2F, P2>::type;
  constexpr int S = L::STAGES;
  __shared__ Ring<S> ring;
  __shared__ int rows[kM];
  __shared__ float gw[kM];
  const int dt = blockIdx.x, sb = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  float* prow = FWD ? nullptr
                    : part + (int64_t)dt * d.E * d.cpad + (int64_t)e * d.cpad;
  if (!slot_rows<kM>(row_id, gate_w, e, sb, d, rows, gw)) {
    const int s = sb * kM + tid;
    if (!FWD && tid < kM && s < d.cpad) prow[s] = 0.f;
    return;
  }
  unsigned char* tiles = ring_tiles();
  const uint32_t base = hop::smem_u32(tiles);
  if (tid == 0) ring.init(1);
  __syncthreads();
  const int nk = (d.H + 63) / 64;
  if (tid >= kConsumers) {                             // the producer
    if (tid != kConsumers) return;
    const uint32_t bytes = (FWD ? 1 : GATED ? 3 : 2) * 3 * kTile;
    for (int k = 0; k < nk; ++k) {
      hop::mbar_wait(ring.e(k), Ring<S>::parity(k) ^ 1);
      const uint32_t st = base + (k % S) * L::BYTES, full = ring.f(k);
      hop::mbar_arrive_tx(full, bytes);
      if constexpr (!FWD) hop::tma_load3(st + L::DH1, &tm_dh1, full, k * 64, sb * kM, e);
      if constexpr (!FWD && GATED) hop::tma_load3(st + L::DHG, &tm_dhg, full, k * 64, sb * kM, e);
      hop::tma_load3(st + L::H, &tm_h, full, k * 64, sb * kM, e);
      if constexpr (!FWD) hop::tma_load3(st + L::WI, &tm_wi, full, k * 64, dt * 64, e);
      if constexpr (!FWD && GATED) hop::tma_load3(st + L::WG, &tm_wg, full, k * 64, dt * 64, e);
      hop::tma_load3(st + L::WO, &tm_wo, full, dt * 64, k * 64, e);
    }
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float adx[8][4], ay[8][4];
  zero(adx);
  zero(ay);
  for (int k = 0; k < nk; ++k) {
    hop::mbar_wait(ring.f(k), Ring<S>::parity(k));
    const uint32_t st = base + (k % S) * L::BYTES;
    hop::wg_fence();
    if constexpr (!FWD)
      hop::wgmma_chunk<0, 0>(adx, st + L::DH1 + wg * kTile, st + L::WI);
    if constexpr (!FWD && GATED) {   // dhg W_gate^T into the same accumulator
      hop::wgmma_chunk<0, 0>(adx, st + L::DHG + wg * kTile, st + L::WG);
    }
    hop::wgmma_chunk<0, 1>(ay, st + L::H + wg * kTile, st + L::WO);
    drain_chunk(ring, k, lane);
  }
  hop::acc_fence(adx);
  hop::acc_fence(ay);
  if constexpr (FWD) {   // out[row] += gate_w y, at most two adds onto 0
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int r = 64 * wg + acc_row(warp, lane, i), row = rows[r];
        if (row < 0) continue;
        const float w = gw[r];
        atomicAdd(reinterpret_cast<float2*>(
                      dx + (int64_t)row * d.D + dt * 64 + acc_col(lane, n, i)),
                  make_float2(ay[n][i] * w, ay[n][i + 1] * w));
      }
    return;
  }
  float dot[2] = {0.f, 0.f};        // rows lane / 4 and + 8 of this warp
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int row = rows[64 * wg + acc_row(warp, lane, i)];
      if (row < 0) continue;
      const int64_t o = (int64_t)row * d.D + dt * 64 + acc_col(lane, n, i);
      atomicAdd(reinterpret_cast<float2*>(dx + o),
                make_float2(adx[n][i], adx[n][i + 1]));
      const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(g + o);
      dot[i >> 1] += __bfloat162float(gv.x) * ay[n][i]
                     + __bfloat162float(gv.y) * ay[n][i + 1];
    }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float v = flash::quad_sum(dot[j]);
    const int s = sb * kM + 64 * wg + acc_row(warp, lane, 2 * j);
    if ((lane & 3) == 0 && s < d.cpad) prow[s] = v;
  }
}

// ---- dW: block (jt, dt, e) owns D columns dt*128.. and H columns jt*64..
// of expert e's dW_in, dW_gate and dW_out; K = its slots in 64-slot
// chunks. Consumer warpgroup wg takes D columns 64 wg.. of the block.
template <bool GATED>
__global__ void __launch_bounds__(kConsumers + kGatherers, 1)
    dw_wgmma_kernel(const bf16* __restrict__ x,
                    const int* __restrict__ row_id,
                    const float* __restrict__ gate_w,
                    const bf16* __restrict__ g, bf16* __restrict__ dwi,
                    bf16* __restrict__ dwg, bf16* __restrict__ dwo, Dims d,
                    const __grid_constant__ CUtensorMap tm_dh1,
                    const __grid_constant__ CUtensorMap tm_dhg,
                    const __grid_constant__ CUtensorMap tm_h) {
  constexpr int S = PW::STAGES;
  __shared__ Ring<S> ring;
  __shared__ int srow[S][64];      // each chunk's token rows,
  __shared__ float sgw[S][64];     // gate weights
  __shared__ int slive[S];         // and whether it holds a token
  __shared__ int last;
  const int jt = blockIdx.x, dt = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  unsigned char* tiles = ring_tiles();
  const uint32_t base = hop::smem_u32(tiles);
  if (tid == 0) {
    ring.init(kGatherers + 1);
    last = -1;
  }
  __syncthreads();
  {  // the chunks up to the last that holds a token (capacity past the
     // expert's tokens is skipped)
    int mine = -1;
    for (int s = tid; s < d.cpad; s += blockDim.x) {
      const int r = row_id[(int64_t)e * d.cpad + s];
      if (r >= 0 && r < d.T) mine = s;
    }
    if (mine >= 0) atomicMax(&last, mine >> 6);
  }
  __syncthreads();
  const int n_chunks = last + 1;
  if (tid >= kConsumers) {                       // the producer warpgroup
    const int t = tid - kConsumers;
    // slot t of chunk c (t < 64): its row id and gate weight, loaded a
    // chunk ahead
    const int64_t slots = (int64_t)e * d.cpad + t;
    auto fetch = [&](int c, int& r, float& w) {
      r = -1;
      w = 0.f;
      if (t < 64 && c < n_chunks && c * 64 + t < d.cpad) {
        r = row_id[slots + c * 64];
        w = gate_w[slots + c * 64];
      }
    };
    int r_next;
    float w_next;
    fetch(0, r_next, w_next);
    for (int c = 0; c < n_chunks; ++c) {
      const bool token = r_next >= 0 && r_next < d.T;
      const int row = token ? r_next : -1;
      const float w = token ? w_next : 0.f;
      fetch(c + 1, r_next, w_next);
      hop::mbar_wait(ring.e(c), Ring<S>::parity(c) ^ 1);
      const int s = c % S;
      if (t < 64) {
        srow[s][t] = row;
        sgw[s][t] = w;
      }
      const bool live = hop::bar_any(3, kGatherers, row >= 0);
      const uint32_t st = base + s * PW::BYTES, full = ring.f(c);
      if (t == 0) {
        slive[s] = live;
        if (live) {
          hop::mbar_arrive_tx(full, (GATED ? 3 : 2) * kTile);
          hop::tma_load3(st + PW::DH1, &tm_dh1, full, jt * 64, c * 64, e);
          if constexpr (GATED) hop::tma_load3(st + PW::DHG, &tm_dhg, full, jt * 64, c * 64, e);
          hop::tma_load3(st + PW::H, &tm_h, full, jt * 64, c * 64, e);
        } else {
          hop::mbar_arrive(full);
        }
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = t + kGatherers * i, r = idx >> 4, cc = idx & 15;
          const int rr = srow[s][r], col = dt * 128 + cc * 8;
          const bool ok = rr >= 0 && col < d.D;
          const int64_t o = ok ? (int64_t)rr * d.D + col : 0;
          const uint32_t at = (cc >> 3) * kTile + hop::swz(r, cc & 7);
          hop::cp16(st + PW::X + at, x + o, ok ? 16 : 0);
          hop::cp16(st + PW::G + at, g + o, ok ? 16 : 0);
        }
      }
      hop::cp_arrive(full);
    }
    return;
  }
  const int wg = tid >> 7, t = tid & 127, warp = (tid >> 5) & 3,
            lane = tid & 31;
  float a1[8][4], a2[8][4], a3[8][4];
  zero(a1);
  zero(a2);
  zero(a3);
  for (int c = 0; c < n_chunks; ++c) {
    wait_gathered(ring, c);
    const int s = c % S;
    // the same for every lane: a vote, so that the compiler sees the
    // products' branch uniform (a branch it may think divergent makes
    // ptxas serialise every wgmma of the kernel)
    if (__any_sync(0xffffffffu, slive[s] != 0)) {
      const uint32_t st = base + s * PW::BYTES;
      const uint32_t xa = st + PW::X + wg * kTile, ga = st + PW::G + wg * kTile;
      make_dy(tiles + (ga - base), sgw[s], wg, t);
      hop::wg_fence();
      hop::wgmma_chunk<1, 1>(a1, xa, st + PW::DH1);
      if constexpr (GATED) hop::wgmma_chunk<1, 1>(a2, xa, st + PW::DHG);
      hop::wgmma_chunk<1, 1>(a3, st + PW::H, ga);
    }
    drain_chunk(ring, c, lane);      // an empty group for a chunk without tokens
  }
  hop::acc_fence(a1);
  hop::acc_fence(a2);
  hop::acc_fence(a3);
  const int d0 = dt * 128 + 64 * wg;
  if (d0 >= d.D) return;
  const int64_t DH = (int64_t)d.D * d.H;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int r = acc_row(warp, lane, i), c = acc_col(lane, n, i);
      const int j = jt * 64 + c;                 // dW_in, dW_gate: [d][j]
      if (j < d.H) {
        const int64_t o = e * DH + (int64_t)(d0 + r) * d.H + j;
        flash::store2(dwi + o, a1[n][i], a1[n][i + 1]);
        if constexpr (GATED) flash::store2(dwg + o, a2[n][i], a2[n][i + 1]);
      }
      const int jo = jt * 64 + r;                // dW_out: [j][d]
      if (jo < d.H)
        flash::store2(dwo + e * DH + (int64_t)jo * d.D + d0 + c, a3[n][i],
                      a3[n][i + 1]);
    }
}

// ---- fp32 dX and dW on Hopper: TF32 wgmma fed by TMA / cp.async rings ----

// The tf32 hi and lo of a [B][R][C] fp32 tensor (split_tf32: both rounded
// to nearest), transposed into [B][C][R] at trans and, with PLAIN, as they
// are into [B][R][C] at plain; each lo array lies lo_off elements after its
// hi one, so that one tensor map over [2B][.][.] reads both. A block moves
// one 32 x 32 tile through shared memory (every access coalesced).
template <bool PLAIN>
__global__ void __launch_bounds__(256) split_hilo_kernel(
    const float* __restrict__ src, float* __restrict__ plain,
    float* __restrict__ trans, int R, int C, int64_t lo_off) {
  __shared__ float sh[32][33], sl[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.z * R * C;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    uint32_t hb = 0, lb = 0;
    if (r < R && c < C) {
      const int64_t o = base + (int64_t)r * C + c;
      flash::split_tf32(src[o], hb, lb);
      if constexpr (PLAIN) {
        plain[o] = __uint_as_float(hb);
        plain[lo_off + o] = __uint_as_float(lb);
      }
    }
    sh[i][tx] = __uint_as_float(hb);
    sl[i][tx] = __uint_as_float(lb);
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c >= C || r >= R) continue;
    const int64_t o = base + (int64_t)c * R + r;
    trans[o] = sh[tx][i];
    trans[lo_off + o] = sl[tx][i];
  }
}

// Stage layouts of the fp32 rings (byte offsets; every TMA tile 1024-byte
// aligned). A B tile is [64 n][32 k] fp32, 8 KB (kTile); an A tile of 128
// rows [128][32], 16 KB; hi and lo of each B operand. HALF: the step from
// a B tile of the block's first 64 output columns to its second (FWD).
// dX pass 1: W_in^T, W_gate^T, W_out hi and lo ([64 j][32 d], TMA); x and g
// rows [128 slots][32 d], gathered into the swizzled layout.
struct Q1 {
  enum : uint32_t { WIH = 0, WIL = kTile, WGH = 2 * kTile, WGL = 3 * kTile,
                    WOH = 4 * kTile, WOL = 5 * kTile, X = 6 * kTile,
                    G = 8 * kTile, HALF = 0, BYTES = 10 * kTile, STAGES = 2 };
};
// The forward's pass 1: W_in^T, W_gate^T hi and lo for two 64-column halves
// of H ([64 j][32 d] each, TMA); x rows [128 slots][32 d], gathered. No g,
// no W_out.
struct Q1F {
  enum : uint32_t { WIH = 0, WIL = kTile, WGH = 4 * kTile, WGL = 5 * kTile,
                    X = 8 * kTile, HALF = 2 * kTile, BYTES = 10 * kTile,
                    STAGES = 2 };
};
// dX pass 2: dh1, dhg, h [128 slots][32 j]; W_in, W_gate, W_out^T hi and
// lo [64 d][32 j]; all by TMA.
struct Q2 {
  enum : uint32_t { DH1 = 0, DHG = 2 * kTile, H = 4 * kTile, WIH = 6 * kTile,
                    WIL = 7 * kTile, WGH = 8 * kTile, WGL = 9 * kTile,
                    WOH = 10 * kTile, WOL = 11 * kTile, HALF = 0,
                    BYTES = 12 * kTile, STAGES = 2 };
};
// The forward's pass 2: h [128 slots][32 j]; W_out^T hi and lo [64 d][32 j]
// for two 64-column halves of D; all by TMA.
struct Q2F {
  enum : uint32_t { H = 0, WOH = 2 * kTile, WOL = 3 * kTile, HALF = 2 * kTile,
                    BYTES = 6 * kTile, STAGES = 4 };
};
// dW: dh1^T, dhg^T, h^T hi and lo [64 j][32 slots] (TMA); x and g rows
// [32 slots][128 d] gathered into rows of kLdW floats (136: the transposed
// fragment loads of frag_split_t then fall on 32 distinct banks).
constexpr int kLdW = 136;
struct QW {
  enum : uint32_t { D1H = 0, D1L = kTile, DGH = 2 * kTile, DGL = 3 * kTile,
                    HH = 4 * kTile, HL = 5 * kTile, X = 6 * kTile,
                    G = 6 * kTile + 32 * kLdW * 4,
                    BYTES = 6 * kTile + 2 * 32 * kLdW * 4, STAGES = 2 };
};
static_assert(QW::BYTES % 1024 == 0, "a dW stage keeps its TMA tiles aligned");

__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// The tf32 RS A fragments (hopper.cuh: a[0] row l / 4, column l % 4; a[1]
// 8 rows down; a[2], a[3] 4 columns right) of the four k-steps of one
// 32-deep chunk, rows 16 warp.. of a K-major swizzled tile at shared
// address p (64 rows of 128 bytes), each value times its row's scale (s0
// for row l / 4, s1 for 8 rows down: SCALE) and split into hi and lo.
template <bool SCALE>
__device__ __forceinline__ void frag_split(uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], uint32_t p,
                                           int warp, int lane, float s0,
                                           float s1) {
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = lds(p + hop::swz(r + (i & 1) * 8, 2 * ks + (i >> 1)) + 4 * t);
      if constexpr (SCALE) v *= (i & 1) ? s1 : s0;
      flash::split_tf32(v, hi[ks][i], lo[ks][i]);
    }
}

// The same of the transpose of a [32 k][kLdW] tile at p (rows k, A[m][k] =
// tile[k][m0 + m]), each value times its k row's scale sc[k] (SCALE).
template <bool SCALE>
__device__ __forceinline__ void frag_split_t(uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4], uint32_t p,
                                             int m0, int warp, int lane,
                                             const float* sc) {
  const int m = m0 + 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * ks + t + (i >> 1) * 4;
      float v = lds(p + 4 * (k * kLdW + m + (i & 1) * 8));
      if constexpr (SCALE) v *= sc[k];
      flash::split_tf32(v, hi[ks][i], lo[ks][i]);
    }
}

// acc += A B over one 32-deep chunk to fp32 accuracy: A's hi and lo from
// registers (frag_split), B's hi at bh and lo at bl ([64 n][32 k] K-major
// tiles), the three passes (flash_tf32::product_rs) into the fresh
// accumulator part, waited, then added on the CUDA cores. Every group this
// warpgroup committed is complete on return. TIED keeps part in one set of
// registers across products (the forward's gated pass 1 holds four
// accumulators: with a renamed part a product, ptxas spilled 284 bytes).
template <bool TIED = false>
__device__ __forceinline__ void product_add(float (&acc)[8][4],
                                            float (&part)[8][4],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t bh, uint32_t bl) {
  hop::wg_fence();
  flash_tf32::product_rs<true, TIED>(part, hi, lo, bh, bl);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::acc_fence(part);
  flash_tf32::add_to(acc, part);
}

// ---- pass 1 of fp32 dX: h, dh1, dhg, and with FWD of the forward: h.
// Block (jt, sb, e): slots sb*128.., H columns jt*BJ..; K = D in 32-deep
// chunks; consumer warpgroup wg takes slots 64 wg... tm_wi, tm_wg, tm_wo:
// W_in^T, W_gate^T, W_out hi and lo as [2E, H, D] (split_hilo_kernel). FWD
// drops the g gather, the W_out tiles and the dy W_out^T product, and takes
// 128 H columns a block (BJ), two 64-column halves, so that each split x
// fragment feeds twice the products. ----
template <bool GATED, bool FWD>
__global__ void __launch_bounds__(kConsumers + kGatherers, 1)
    dx_h_tf32_kernel(const float* __restrict__ x,
                     const int* __restrict__ row_id,
                     const float* __restrict__ gate_w,
                     const float* __restrict__ g, float* __restrict__ h_out,
                     float* __restrict__ dh1_out, float* __restrict__ dhg_out,
                     Dims d, const __grid_constant__ CUtensorMap tm_wi,
                     const __grid_constant__ CUtensorMap tm_wg,
                     const __grid_constant__ CUtensorMap tm_wo) {
  using Q = typename std::conditional<FWD, Q1F, Q1>::type;
  constexpr int S = Q::STAGES;
  constexpr int NJ = FWD ? 2 : 1, BJ = 64 * NJ;   // H columns a block
  __shared__ Ring<S> ring;
  __shared__ int rows[kM];
  __shared__ float gw[kM];
  const int jt = blockIdx.x, sb = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  // no token in the block: its inter rows stay the wrapper's zeros; the
  // forward's h rows stay unwritten, and pass 2 skips the same block
  if (!slot_rows<kM>(row_id, gate_w, e, sb, d, rows, gw)) return;
  unsigned char* tiles = ring_tiles();
  const uint32_t base = hop::smem_u32(tiles);
  if (tid == 0) ring.init(kGatherers + 1);
  __syncthreads();
  const int nk = d.D / 32;
  if (tid >= kConsumers) {                       // the producer warpgroup
    hop::reg_dealloc<24>();
    const int t = tid - kConsumers;
    constexpr uint32_t kTma = (NJ * (GATED ? 4 : 2) + (FWD ? 0 : 2)) * kTile;
    for (int k = 0; k < nk; ++k) {
      hop::mbar_wait(ring.e(k), Ring<S>::parity(k) ^ 1);
      const uint32_t st = base + (k % S) * Q::BYTES, full = ring.f(k);
      if (t == 0) {
        hop::mbar_arrive_tx(full, kTma);
        for (int h = 0; h < NJ; ++h) {
          const uint32_t o = h * Q::HALF;
          const int j0 = jt * BJ + 64 * h;
          hop::tma_load4(st + Q::WIH + o, &tm_wi, full, k * 32, j0, e, 0);
          hop::tma_load4(st + Q::WIL + o, &tm_wi, full, k * 32, j0, e + d.E,
                         0);
          if constexpr (GATED) {
            hop::tma_load4(st + Q::WGH + o, &tm_wg, full, k * 32, j0, e, 0);
            hop::tma_load4(st + Q::WGL + o, &tm_wg, full, k * 32, j0,
                           e + d.E, 0);
          }
        }
        if constexpr (!FWD) {
          hop::tma_load4(st + Q::WOH, &tm_wo, full, k * 32, jt * 64, e, 0);
          hop::tma_load4(st + Q::WOL, &tm_wo, full, k * 32, jt * 64, e + d.E,
                         0);
        }
      }
#pragma unroll 2
      for (int i = 0; i < 8; ++i) {            // 128 rows x 8 chunks of 16 B
        const int idx = t + kGatherers * i, r = idx >> 3, c = idx & 7;
        const int row = rows[r];
        const int64_t o = (int64_t)(row < 0 ? 0 : row) * d.D + k * 32 + c * 4;
        hop::cp16(st + Q::X + hop::swz(r, c), x + o, row < 0 ? 0 : 16);
        if constexpr (!FWD)
          hop::cp16(st + Q::G + hop::swz(r, c), g + o, row < 0 ? 0 : 16);
      }
      hop::cp_arrive(full);
    }
    return;
  }
  hop::reg_alloc<240>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float a1[NJ][8][4], ag[NJ][8][4], adh[8][4], part[8][4];
#pragma unroll
  for (int h = 0; h < NJ; ++h) {
    zero(a1[h]);
    zero(ag[h]);
  }
  zero(adh);
  zero(part);                 // named as read by the TIED products (FWD)
  for (int k = 0; k < nk; ++k) {
    hop::mbar_wait(ring.f(k), Ring<S>::parity(k));
    const uint32_t st = base + (k % S) * Q::BYTES;
    uint32_t hi[4][4], lo[4][4];
    frag_split<false>(hi, lo, st + Q::X + wg * kTile, warp, lane, 1.f, 1.f);
#pragma unroll
    for (int h = 0; h < NJ; ++h) {
      const uint32_t o = h * Q::HALF;
      product_add<FWD>(a1[h], part, hi, lo, st + Q::WIH + o,
                       st + Q::WIL + o);
      if constexpr (GATED)
        product_add<FWD>(ag[h], part, hi, lo, st + Q::WGH + o,
                         st + Q::WGL + o);
    }
    if constexpr (!FWD) {
      // dy = g * gate_w (fp32: rounded as the plain version rounds it);
      // this lane's two rows' gate weights read again for each chunk (held
      // across the loop, the two registers were what ptxas spilled)
      const uint32_t gwa =
          hop::smem_u32(gw + 64 * wg + 16 * warp + (lane >> 2));
      frag_split<true>(hi, lo, st + Q::G + wg * kTile, warp, lane, lds(gwa),
                       lds(gwa + 32));
      product_add(adh, part, hi, lo, st + Q::WOH, st + Q::WOL);
    }
    // release stage k: after the wg_wait<0> of the product just above,
    // the last group that read it (A came from registers)
    if (lane == 0) hop::mbar_arrive(ring.e(k));
  }
#pragma unroll
  for (int h = 0; h < NJ; ++h)
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int s = sb * kM + 64 * wg + acc_row(warp, lane, i);
      const int c = jt * BJ + 64 * h + acc_col(lane, n, i);
      if (s >= d.cpad || c >= d.H) continue;
      const int64_t o = ((int64_t)e * d.cpad + s) * d.H + c;
      float hv[2], d1[2], dg[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float h1 = a1[h][n][i + j], hg = ag[h][n][i + j],
                    dh = adh[n][i + j];
        const float act = act_f(d.act, GATED ? hg : h1);
        hv[j] = GATED ? act * h1 : act;
        d1[j] = GATED ? dh * act : dh * dact_f(d.act, h1);
        dg[j] = GATED ? dh * h1 * dact_f(d.act, hg) : 0.f;
      }
      flash::store2(h_out + o, hv[0], hv[1]);
      if constexpr (!FWD) {
        flash::store2(dh1_out + o, d1[0], d1[1]);
        if constexpr (GATED) flash::store2(dhg_out + o, dg[0], dg[1]);
      }
    }
}

// ---- pass 2 of fp32 dX: dx[row] += dh1 W_in^T + dhg W_gate^T, and y =
// h W_out for this D tile's share of dgw (dgw_reduce_kernel sums the
// shares in a fixed order); with FWD, of the forward: y = h W_out alone
// and out[row] += gate_w y (out in dx's place; no g, no part, no dh1, dhg,
// W_in, W_gate), over 128 D columns a block (BD), two 64-column halves.
// Block (dt, sb, e): slots sb*128.., D columns dt*BD..; K = H in 32-deep
// chunks. Every operand by TMA (the producer is one thread): tm_dh1,
// tm_dhg, tm_h [E, cpad, H]; tm_wi, tm_wg, tm_wo: W_in, W_gate, W_out^T hi
// and lo as [2E, D, H]. ----
template <bool GATED, bool FWD>
__global__ void __launch_bounds__(kConsumers + kGatherers, 1) dx_out_tf32_kernel(
    const int* __restrict__ row_id, const float* __restrict__ gate_w,
    const float* __restrict__ g, float* __restrict__ dx,
    float* __restrict__ part_out, Dims d,
    const __grid_constant__ CUtensorMap tm_wi,
    const __grid_constant__ CUtensorMap tm_wg,
    const __grid_constant__ CUtensorMap tm_wo,
    const __grid_constant__ CUtensorMap tm_dh1,
    const __grid_constant__ CUtensorMap tm_dhg,
    const __grid_constant__ CUtensorMap tm_h) {
  using Q = typename std::conditional<FWD, Q2F, Q2>::type;
  constexpr int S = Q::STAGES;
  constexpr int ND = FWD ? 2 : 1, BD = 64 * ND;   // D columns a block
  __shared__ Ring<S> ring;
  __shared__ int rows[kM];
  __shared__ float gw[kM];
  const int dt = blockIdx.x, sb = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  float* prow = FWD ? nullptr
                    : part_out + (int64_t)dt * d.E * d.cpad
                          + (int64_t)e * d.cpad;
  if (!slot_rows<kM>(row_id, gate_w, e, sb, d, rows, gw)) {
    const int s = sb * kM + tid;
    if (!FWD && tid < kM && s < d.cpad) prow[s] = 0.f;
    return;
  }
  unsigned char* tiles = ring_tiles();
  const uint32_t base = hop::smem_u32(tiles);
  if (tid == 0) ring.init(1);
  __syncthreads();
  const int nk = d.H / 32;
  if (tid >= kConsumers) {           // the producer warpgroup: one thread
    hop::reg_dealloc<40>();
    if (tid != kConsumers) return;
    constexpr uint32_t kBytes =
        (FWD ? 2 + 2 * ND : (GATED ? 6 : 4) * 2) * kTile;
    for (int k = 0; k < nk; ++k) {
      hop::mbar_wait(ring.e(k), Ring<S>::parity(k) ^ 1);
      const uint32_t st = base + (k % S) * Q::BYTES, full = ring.f(k);
      const int j0 = k * 32, d0 = dt * BD, s0 = sb * kM;
      hop::mbar_arrive_tx(full, kBytes);
      hop::tma_load4(st + Q::H, &tm_h, full, j0, s0, e, 0);
      if constexpr (!FWD) {
        hop::tma_load4(st + Q2::DH1, &tm_dh1, full, j0, s0, e, 0);
        hop::tma_load4(st + Q2::WIH, &tm_wi, full, j0, d0, e, 0);
        hop::tma_load4(st + Q2::WIL, &tm_wi, full, j0, d0, e + d.E, 0);
      }
      if constexpr (!FWD && GATED) {
        hop::tma_load4(st + Q2::DHG, &tm_dhg, full, j0, s0, e, 0);
        hop::tma_load4(st + Q2::WGH, &tm_wg, full, j0, d0, e, 0);
        hop::tma_load4(st + Q2::WGL, &tm_wg, full, j0, d0, e + d.E, 0);
      }
      for (int h = 0; h < ND; ++h) {
        const uint32_t o = h * Q::HALF;
        hop::tma_load4(st + Q::WOH + o, &tm_wo, full, j0, d0 + 64 * h, e, 0);
        hop::tma_load4(st + Q::WOL + o, &tm_wo, full, j0, d0 + 64 * h,
                       e + d.E, 0);
      }
    }
    return;
  }
  hop::reg_alloc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float adx[8][4], ay[ND][8][4], part[8][4];
  zero(adx);
#pragma unroll
  for (int h = 0; h < ND; ++h) zero(ay[h]);
  for (int k = 0; k < nk; ++k) {
    hop::mbar_wait(ring.f(k), Ring<S>::parity(k));
    const uint32_t st = base + (k % S) * Q::BYTES;
    uint32_t hi[4][4], lo[4][4];
    if constexpr (!FWD)
      frag_split<false>(hi, lo, st + Q2::DH1 + wg * kTile, warp, lane, 1.f,
                        1.f);
    if constexpr (!FWD && GATED) {   // dh1 W_in^T + dhg W_gate^T: one part
      uint32_t hi2[4][4], lo2[4][4];
      frag_split<false>(hi2, lo2, st + Q2::DHG + wg * kTile, warp, lane, 1.f,
                        1.f);
      hop::wg_fence();
      flash_tf32::product_rs(part, hi, lo, st + Q2::WIH, st + Q2::WIL);
      flash_tf32::product_rs<false>(part, hi2, lo2, st + Q2::WGH,
                                    st + Q2::WGL);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::acc_fence(part);
      flash_tf32::add_to(adx, part);
    } else if constexpr (!FWD) {
      product_add(adx, part, hi, lo, st + Q2::WIH, st + Q2::WIL);
    }
    frag_split<false>(hi, lo, st + Q::H + wg * kTile, warp, lane, 1.f, 1.f);
#pragma unroll
    for (int h = 0; h < ND; ++h)
      product_add(ay[h], part, hi, lo, st + Q::WOH + h * Q::HALF,
                  st + Q::WOL + h * Q::HALF);
    // release stage k: after the wg_wait<0> of the y product just above,
    // the last group that read it
    if (lane == 0) hop::mbar_arrive(ring.e(k));
  }
  if constexpr (FWD) {   // out[row] += gate_w y, at most two adds onto 0
#pragma unroll
    for (int h = 0; h < ND; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int r = 64 * wg + acc_row(warp, lane, i), row = rows[r];
        const int c = dt * BD + 64 * h + acc_col(lane, n, i);
        if (row < 0 || c >= d.D) continue;
        const float gwr = gw[r];
        atomicAdd(reinterpret_cast<float2*>(dx + (int64_t)row * d.D + c),
                  make_float2(ay[h][n][i] * gwr, ay[h][n][i + 1] * gwr));
      }
    return;
  }
  float dot[2] = {0.f, 0.f};        // rows lane / 4 and + 8 of this warp
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int row = rows[64 * wg + acc_row(warp, lane, i)];
      if (row < 0) continue;
      const int64_t o = (int64_t)row * d.D + dt * 64 + acc_col(lane, n, i);
      atomicAdd(reinterpret_cast<float2*>(dx + o),
                make_float2(adx[n][i], adx[n][i + 1]));
      const float2 gv = *reinterpret_cast<const float2*>(g + o);
      dot[i >> 1] += gv.x * ay[0][n][i] + gv.y * ay[0][n][i + 1];
    }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float v = flash::quad_sum(dot[j]);
    const int s = sb * kM + 64 * wg + acc_row(warp, lane, 2 * j);
    if ((lane & 3) == 0 && s < d.cpad) prow[s] = v;
  }
}

// ---- fp32 dW: block (jt, dt, e) owns D columns dt*128.. and H columns
// jt*64.. of expert e's dW_in, dW_gate and dW_out; K = its slots in
// 32-slot chunks up to the last that holds a token (a chunk without
// tokens before it passes through the ring with no loads and no
// products). Consumer warpgroup wg takes D columns 64 wg.. (the M side:
// x^T and dy^T from registers). tm_dh1, tm_dhg, tm_h: dh1^T, dhg^T, h^T
// hi and lo as [2E, H, cpad] (split_hilo_kernel). ----
template <bool GATED>
__global__ void __launch_bounds__(kConsumers + kGatherers, 1)
    dw_tf32_kernel(const float* __restrict__ x,
                   const int* __restrict__ row_id,
                   const float* __restrict__ gate_w,
                   const float* __restrict__ g, float* __restrict__ dwi,
                   float* __restrict__ dwg, float* __restrict__ dwo, Dims d,
                   const __grid_constant__ CUtensorMap tm_dh1,
                   const __grid_constant__ CUtensorMap tm_dhg,
                   const __grid_constant__ CUtensorMap tm_h) {
  constexpr int S = QW::STAGES;
  __shared__ Ring<S> ring;
  __shared__ int crow[S][32];      // each chunk's token rows,
  __shared__ float cgw[S][32];     // gate weights
  __shared__ int clive[S];         // and whether it holds a token
  __shared__ int clast;
  const int jt = blockIdx.x, dt = blockIdx.y, e = blockIdx.z;
  const int tid = threadIdx.x;
  unsigned char* tiles = ring_tiles();
  const uint32_t base = hop::smem_u32(tiles);
  if (tid == 0) {
    ring.init(kGatherers + 1);
    clast = -1;
  }
  __syncthreads();
  {  // the chunks up to the last that holds a token
    int mine = -1;
    for (int s = tid; s < d.cpad; s += blockDim.x) {
      const int r = row_id[(int64_t)e * d.cpad + s];
      if (r >= 0 && r < d.T) mine = s;
    }
    if (mine >= 0) atomicMax(&clast, mine >> 5);
  }
  __syncthreads();
  const int n_chunks = clast + 1;
  if (tid >= kConsumers) {                       // the producer warpgroup
    hop::reg_dealloc<40>();
    const int t = tid - kConsumers;
    // slot t of chunk c (t < 32): its row id and gate weight, loaded a
    // chunk ahead
    const int64_t slots = (int64_t)e * d.cpad + t;
    auto fetch = [&](int c, int& r, float& w) {
      r = -1;
      w = 0.f;
      if (t < 32 && c < n_chunks && c * 32 + t < d.cpad) {
        r = row_id[slots + c * 32];
        w = gate_w[slots + c * 32];
      }
    };
    int r_next;
    float w_next;
    fetch(0, r_next, w_next);
    for (int c = 0; c < n_chunks; ++c) {
      const bool token = r_next >= 0 && r_next < d.T;
      const int row = token ? r_next : -1;
      const float w = token ? w_next : 0.f;
      fetch(c + 1, r_next, w_next);
      hop::mbar_wait(ring.e(c), Ring<S>::parity(c) ^ 1);
      const int s = c % S;
      if (t < 32) {
        crow[s][t] = row;
        cgw[s][t] = w;
      }
      const bool live = hop::bar_any(3, kGatherers, row >= 0);
      const uint32_t st = base + s * QW::BYTES, full = ring.f(c);
      if (t == 0) {
        clive[s] = live;
        if (live) {
          hop::mbar_arrive_tx(full, (GATED ? 6 : 4) * kTile);
          hop::tma_load4(st + QW::D1H, &tm_dh1, full, c * 32, jt * 64, e, 0);
          hop::tma_load4(st + QW::D1L, &tm_dh1, full, c * 32, jt * 64,
                         e + d.E, 0);
          if constexpr (GATED) {
            hop::tma_load4(st + QW::DGH, &tm_dhg, full, c * 32, jt * 64, e,
                           0);
            hop::tma_load4(st + QW::DGL, &tm_dhg, full, c * 32, jt * 64,
                           e + d.E, 0);
          }
          hop::tma_load4(st + QW::HH, &tm_h, full, c * 32, jt * 64, e, 0);
          hop::tma_load4(st + QW::HL, &tm_h, full, c * 32, jt * 64, e + d.E,
                         0);
        } else {
          hop::mbar_arrive(full);
        }
      }
      if (live) {
#pragma unroll 2
        for (int i = 0; i < 8; ++i) {       // 32 rows x 32 chunks of 16 B
          const int idx = t + kGatherers * i, r = idx >> 5, cc = idx & 31;
          const int rr = crow[s][r], col = dt * 128 + cc * 4;
          const bool ok = rr >= 0 && col < d.D;
          const int64_t o = ok ? (int64_t)rr * d.D + col : 0;
          const uint32_t at = 4 * (r * kLdW + cc * 4);
          hop::cp16(st + QW::X + at, x + o, ok ? 16 : 0);
          hop::cp16(st + QW::G + at, g + o, ok ? 16 : 0);
        }
      }
      hop::cp_arrive(full);
    }
    return;
  }
  hop::reg_alloc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float a1[8][4], a2[8][4], a3[8][4], part[8][4];
  zero(a1);
  zero(a2);
  zero(a3);
  for (int c = 0; c < n_chunks; ++c) {
    hop::mbar_wait(ring.f(c), Ring<S>::parity(c));
    const int s = c % S;
    // a vote, so that ptxas sees the products' branch uniform
    if (__any_sync(0xffffffffu, clive[s] != 0)) {
      const uint32_t st = base + s * QW::BYTES;
      uint32_t hi[4][4], lo[4][4];
      frag_split_t<false>(hi, lo, st + QW::X, 64 * wg, warp, lane, nullptr);
      product_add(a1, part, hi, lo, st + QW::D1H, st + QW::D1L);
      if constexpr (GATED)
        product_add(a2, part, hi, lo, st + QW::DGH, st + QW::DGL);
      // dy^T = (g * gate_w)^T: each k row (slot) times its gate weight
      frag_split_t<true>(hi, lo, st + QW::G, 64 * wg, warp, lane, cgw[s]);
      product_add(a3, part, hi, lo, st + QW::HH, st + QW::HL);
    }
    // release stage s: after the wg_wait<0> of the last product above,
    // the last group that read it (none for a chunk without tokens)
    if (lane == 0) hop::mbar_arrive(ring.e(c));
  }
  const int d0 = dt * 128 + 64 * wg;
  if (d0 >= d.D) return;
  const int64_t DH = (int64_t)d.D * d.H;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const int dd = d0 + acc_row(warp, lane, i);
      const int j = jt * 64 + acc_col(lane, n, i);   // j + 1 < H too
      if (j >= d.H) continue;
      const int64_t o = e * DH + (int64_t)dd * d.H + j;
      flash::store2(dwi + o, a1[n][i], a1[n][i + 1]);
      if constexpr (GATED) flash::store2(dwg + o, a2[n][i], a2[n][i + 1]);
      // dW_out [j][d] from its transposed accumulator
      const int64_t oo = e * DH + (int64_t)j * d.D + dd;
      dwo[oo] = a3[n][i];
      dwo[oo + d.D] = a3[n][i + 1];
    }
}

bool dims_ok(const Dims& d) {
  return d.T > 0 && d.D > 0 && d.H > 0 && d.E > 0 && d.cpad > 0 &&
         d.D % kT == 0 && d.H % 32 == 0 && d.E <= 65535 &&
         (d.cpad + kT - 1) / kT <= 65535 && (d.act == 0 || d.act == 1);
}

// dgw from the partial sums of n_tiles D tiles, in a fixed order
cudaError_t reduce_dgw(const float* part, float* dgw, int n_tiles,
                       const Dims& d, cudaStream_t stream) {
  const int n_slots = d.E * d.cpad;
  dgw_reduce_kernel<<<(n_slots + 255) / 256, 256, 0, stream>>>(
      part, dgw, n_slots, n_tiles);
  return cudaGetLastError();
}

// a wgmma kernel: `threads` threads and the ring's dynamic shared memory
template <typename Kern, typename... Args>
cudaError_t launch_ring(Kern kern, dim3 grid, int threads, uint32_t stage,
                        int stages, cudaStream_t stream, Args... args) {
  const size_t smem = stages * stage + 1024;     // + the 1024 alignment
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// An fp32 [n2][n1][n0] tensor (n0 contiguous) read in boxes of 32 x b1
// elements, 128B-swizzled (f32_map4 with a last dimension of 1)
bool f32_map3(CUtensorMap* m, const void* base, uint64_t n0, uint64_t n1,
              uint64_t n2, uint32_t b1) {
  const uint64_t n[4] = {n0, n1, n2, 1};
  const int64_t st[3] = {(int64_t)n0, (int64_t)(n0 * n1), 0};
  return hop::f32_map4(m, base, n, st, b1);
}

// split_hilo_kernel over a [B][R][C] tensor: hi and lo transposed at
// trans and, when plain is given, as they are at plain
cudaError_t split_hilo(const void* src, float* plain, float* trans, int B,
                       int R, int C, cudaStream_t stream) {
  const dim3 grid((C + 31) / 32, (R + 31) / 32, B);
  const int64_t lo_off = (int64_t)B * R * C;
  const float* f = static_cast<const float*>(src);
  if (plain)
    split_hilo_kernel<true><<<grid, 256, 0, stream>>>(f, plain, trans, R, C,
                                                      lo_off);
  else
    split_hilo_kernel<false><<<grid, 256, 0, stream>>>(f, plain, trans, R, C,
                                                       lo_off);
  return cudaGetLastError();
}

// fp32 forward (the bf16 one is fwd_bf16): the weights' transposed hi and
// lo into scratch (W = E D H elements each: W_in^T, W_out^T, then W_gate^T,
// each hi then lo: 4 W, 6 W gated), their tensor maps (boxes 32 x 64 rows)
// and h's (32 x 128 slots), then pass 1 (h) and pass 2 (out += gate_w h
// W_out)
int fwd_f32(const void* x, const int* row_id, const float* gate_w,
            const void* w_in, const void* w_gate, const void* w_out, void* h,
            float* out, void* scratch, const Dims& d, cudaStream_t stream) {
  if (!scratch) return cudaErrorInvalidValue;
  const int64_t W = (int64_t)d.E * d.D * d.H;
  float* sc = static_cast<float*>(scratch);
  float *wit = sc, *wot = sc + 2 * W, *wgt = sc + 4 * W;
  cudaError_t err = split_hilo(w_in, nullptr, wit, d.E, d.D, d.H, stream);
  if (err == cudaSuccess && d.gated)
    err = split_hilo(w_gate, nullptr, wgt, d.E, d.D, d.H, stream);
  if (err == cudaSuccess)
    err = split_hilo(w_out, nullptr, wot, d.E, d.H, d.D, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap m_wi, m_wg = {}, m_wo, m_h, none = {};
  const uint64_t E2 = 2 * d.E;
  if (!f32_map3(&m_wi, wit, d.D, d.H, E2, 64) ||
      (d.gated && !f32_map3(&m_wg, wgt, d.D, d.H, E2, 64)) ||
      !f32_map3(&m_wo, wot, d.H, d.D, E2, 64) ||
      !f32_map3(&m_h, h, d.H, d.cpad, d.E, kM))
    return cudaErrorInvalidValue;
  using CF = const float*;
  float* const no = nullptr;
  const int n_sb = (d.cpad + kM - 1) / kM;
  err = launch_ring(
      d.gated ? dx_h_tf32_kernel<true, true> : dx_h_tf32_kernel<false, true>,
      dim3((d.H + 127) / 128, n_sb, d.E), kConsumers + kGatherers,
      Q1F::BYTES, Q1F::STAGES, stream, CF(x), row_id, gate_w, CF(no),
      static_cast<float*>(h), no, no, d, m_wi, m_wg, none);
  if (err != cudaSuccess) return err;
  // pass 2 is one kernel for both FFN kinds: its template flag GATED only
  // selects dX's dhg product, so the forward instantiates it ungated
  return launch_ring(dx_out_tf32_kernel<false, true>,
                     dim3((d.D + 127) / 128, n_sb, d.E),
                     kConsumers + kGatherers, Q2F::BYTES, Q2F::STAGES, stream,
                     row_id, gate_w, CF(no), out, no, d, none, none, m_wo,
                     none, none, m_h);
}

// fp32 dX (the bf16 one is dx_bf16): the weights' hi and lo into scratch
// (W = E D H elements each: W_in^T, W_in, W_out, W_out^T, then W_gate^T,
// W_gate, each hi then lo: 8 W, 12 W gated), their tensor maps (boxes 32
// x 64 rows) and those of h, dh1, dhg (32 x 128 slots), then the two
// passes and dgw
int dx_f32(const void* x, const int* row_id, const float* gate_w,
           const void* w_in, const void* w_gate, const void* w_out,
           const void* g, void* h, void* dh1, void* dhg, float* dxo,
           float* dgw, float* part, void* scratch, const Dims& d,
           cudaStream_t stream) {
  if (!scratch) return cudaErrorInvalidValue;
  const int64_t W = (int64_t)d.E * d.D * d.H;
  float* sc = static_cast<float*>(scratch);
  float *wit = sc, *wip = sc + 2 * W, *wop = sc + 4 * W, *wot = sc + 6 * W,
        *wgt = sc + 8 * W, *wgp = sc + 10 * W;
  cudaError_t err = split_hilo(w_in, wip, wit, d.E, d.D, d.H, stream);
  if (err == cudaSuccess && d.gated)
    err = split_hilo(w_gate, wgp, wgt, d.E, d.D, d.H, stream);
  if (err == cudaSuccess)
    err = split_hilo(w_out, wop, wot, d.E, d.H, d.D, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap m1_wi, m1_wg = {}, m1_wo, m2_wi, m2_wg = {}, m2_wo, m_dh1,
              m_dhg = {}, m_h;
  const uint64_t E2 = 2 * d.E;
  if (!f32_map3(&m1_wi, wit, d.D, d.H, E2, 64) ||
      (d.gated && !f32_map3(&m1_wg, wgt, d.D, d.H, E2, 64)) ||
      !f32_map3(&m1_wo, wop, d.D, d.H, E2, 64) ||
      !f32_map3(&m2_wi, wip, d.H, d.D, E2, 64) ||
      (d.gated && !f32_map3(&m2_wg, wgp, d.H, d.D, E2, 64)) ||
      !f32_map3(&m2_wo, wot, d.H, d.D, E2, 64) ||
      !f32_map3(&m_dh1, dh1, d.H, d.cpad, d.E, kM) ||
      (d.gated && !f32_map3(&m_dhg, dhg, d.H, d.cpad, d.E, kM)) ||
      !f32_map3(&m_h, h, d.H, d.cpad, d.E, kM))
    return cudaErrorInvalidValue;
  using CF = const float*;
  const int n_sb = (d.cpad + kM - 1) / kM;
  err = launch_ring(
      d.gated ? dx_h_tf32_kernel<true, false>
              : dx_h_tf32_kernel<false, false>,
      dim3((d.H + 63) / 64, n_sb, d.E), kConsumers + kGatherers, Q1::BYTES,
      Q1::STAGES, stream, CF(x), row_id, gate_w, CF(g),
      static_cast<float*>(h), static_cast<float*>(dh1),
      static_cast<float*>(dhg), d, m1_wi, m1_wg, m1_wo);
  if (err != cudaSuccess) return err;
  err = launch_ring(
      d.gated ? dx_out_tf32_kernel<true, false>
              : dx_out_tf32_kernel<false, false>,
      dim3(d.D / 64, n_sb, d.E), kConsumers + kGatherers, Q2::BYTES,
      Q2::STAGES, stream, row_id, gate_w, CF(g), dxo, part, d, m2_wi, m2_wg,
      m2_wo, m_dh1,
      m_dhg, m_h);
  if (err != cudaSuccess) return err;
  return reduce_dgw(part, dgw, d.D / 64, d, stream);
}

// fp32 dW (the bf16 one is dw_bf16): the transposed hi and lo of h, dh1,
// dhg into scratch (I = E cpad H elements each, hi then lo: 4 I, 6 I
// gated), their tensor maps (boxes 32 slots x 64 rows), one launch
int dw_f32(const void* x, const int* row_id, const float* gate_w,
           const void* g, const void* h, const void* dh1, const void* dhg,
           void* dwi, void* dwg, void* dwo, void* scratch, const Dims& d,
           cudaStream_t stream) {
  if (!scratch) return cudaErrorInvalidValue;
  const int64_t I = (int64_t)d.E * d.cpad * d.H;
  float* sc = static_cast<float*>(scratch);
  float *ht = sc, *d1t = sc + 2 * I, *dgt = sc + 4 * I;
  cudaError_t err = split_hilo(h, nullptr, ht, d.E, d.cpad, d.H, stream);
  if (err == cudaSuccess)
    err = split_hilo(dh1, nullptr, d1t, d.E, d.cpad, d.H, stream);
  if (err == cudaSuccess && d.gated)
    err = split_hilo(dhg, nullptr, dgt, d.E, d.cpad, d.H, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap m_dh1, m_dhg = {}, m_h;
  const uint64_t E2 = 2 * d.E;
  if (!f32_map3(&m_dh1, d1t, d.cpad, d.H, E2, 64) ||
      (d.gated && !f32_map3(&m_dhg, dgt, d.cpad, d.H, E2, 64)) ||
      !f32_map3(&m_h, ht, d.cpad, d.H, E2, 64))
    return cudaErrorInvalidValue;
  using CF = const float*;
  return launch_ring(
      d.gated ? dw_tf32_kernel<true> : dw_tf32_kernel<false>,
      dim3((d.H + 63) / 64, (d.D + 127) / 128, d.E), kConsumers + kGatherers,
      QW::BYTES, QW::STAGES, stream, CF(x), row_id, gate_w, CF(g),
      static_cast<float*>(dwi), static_cast<float*>(dwg),
      static_cast<float*>(dwo), d, m_dh1, m_dhg, m_h);
}

// bf16 dX: the tensor maps of the weights (boxes 64 x 64) and of h, dh1,
// dhg (boxes 64 x 128 slots), then the two passes and dgw
int dx_bf16(const void* x, const int* row_id, const float* gate_w,
            const void* w_in, const void* w_gate, const void* w_out,
            const void* g, void* h, void* dh1, void* dhg, float* dxo,
            float* dgw, float* part, const Dims& d, cudaStream_t stream) {
  CUtensorMap m_wi, m_wg = {}, m_wo, m_dh1, m_dhg = {}, m_h;
  const uint64_t E = d.E;
  if (!hop::bf16_map3(&m_wi, w_in, d.H, d.D, E, 64) ||
      (d.gated && !hop::bf16_map3(&m_wg, w_gate, d.H, d.D, E, 64)) ||
      !hop::bf16_map3(&m_wo, w_out, d.D, d.H, E, 64) ||
      !hop::bf16_map3(&m_dh1, dh1, d.H, d.cpad, E, kM) ||
      (d.gated && !hop::bf16_map3(&m_dhg, dhg, d.H, d.cpad, E, kM)) ||
      !hop::bf16_map3(&m_h, h, d.H, d.cpad, E, kM))
    return cudaErrorInvalidValue;
  const int n_sb = (d.cpad + kM - 1) / kM;
  cudaError_t err = launch_ring(
      d.gated ? dx_h_wgmma_kernel<true, false>
              : dx_h_wgmma_kernel<false, false>,
      dim3((d.H + 63) / 64, n_sb, d.E),
      kConsumers + kGatherers, P1::BYTES, P1::STAGES, stream,
      static_cast<const bf16*>(x), row_id, gate_w,
      static_cast<const bf16*>(g), static_cast<bf16*>(h),
      static_cast<bf16*>(dh1), static_cast<bf16*>(dhg), d, m_wi, m_wg, m_wo);
  if (err != cudaSuccess) return err;
  err = launch_ring(d.gated ? dx_out_wgmma_kernel<true, false>
                            : dx_out_wgmma_kernel<false, false>,
                    dim3(d.D / 64, n_sb, d.E),
                    kConsumers + 32, P2::BYTES, P2::STAGES, stream, row_id, gate_w,
                    static_cast<const bf16*>(g), dxo, part, d, m_wi, m_wg,
                    m_wo, m_dh1, m_dhg, m_h);
  if (err != cudaSuccess) return err;
  return reduce_dgw(part, dgw, d.D / 64, d, stream);
}

// bf16 forward: the tensor maps of the weights (boxes 64 x 64) and of h
// (64 x 128 slots), then pass 1 (h) and pass 2 (out += gate_w h W_out)
int fwd_bf16(const void* x, const int* row_id, const float* gate_w,
             const void* w_in, const void* w_gate, const void* w_out,
             void* h, float* out, const Dims& d, cudaStream_t stream) {
  CUtensorMap m_wi, m_wg = {}, m_wo, m_h, none = {};
  const uint64_t E = d.E;
  if (!hop::bf16_map3(&m_wi, w_in, d.H, d.D, E, 64) ||
      (d.gated && !hop::bf16_map3(&m_wg, w_gate, d.H, d.D, E, 64)) ||
      !hop::bf16_map3(&m_wo, w_out, d.D, d.H, E, 64) ||
      !hop::bf16_map3(&m_h, h, d.H, d.cpad, E, kM))
    return cudaErrorInvalidValue;
  const int n_sb = (d.cpad + kM - 1) / kM;
  cudaError_t err = launch_ring(
      d.gated ? dx_h_wgmma_kernel<true, true>
              : dx_h_wgmma_kernel<false, true>,
      dim3((d.H + 127) / 128, n_sb, d.E), kConsumers + kGatherers,
      P1F::BYTES, P1F::STAGES, stream, static_cast<const bf16*>(x), row_id,
      gate_w,
      static_cast<const bf16*>(nullptr), static_cast<bf16*>(h),
      static_cast<bf16*>(nullptr), static_cast<bf16*>(nullptr), d, m_wi,
      m_wg, none);
  if (err != cudaSuccess) return err;
  // pass 2 is one kernel for both FFN kinds: its template flag GATED only
  // selects dX's dhg product, so the forward instantiates it ungated
  return launch_ring(dx_out_wgmma_kernel<false, true>,
                     dim3(d.D / 64, n_sb, d.E), kConsumers + 32, P2F::BYTES,
                     P2F::STAGES, stream, row_id, gate_w,
                     static_cast<const bf16*>(nullptr), out,
                     static_cast<float*>(nullptr), d, none, none, m_wo, none,
                     none, m_h);
}

// bf16 dW: the tensor maps of h, dh1, dhg (boxes 64 x 64 slots), one launch
int dw_bf16(const void* x, const int* row_id, const float* gate_w,
            const void* g, const void* h, const void* dh1, const void* dhg,
            void* dwi, void* dwg, void* dwo, const Dims& d,
            cudaStream_t stream) {
  CUtensorMap m_dh1, m_dhg = {}, m_h;
  const uint64_t E = d.E;
  if (!hop::bf16_map3(&m_dh1, dh1, d.H, d.cpad, E, 64) ||
      (d.gated && !hop::bf16_map3(&m_dhg, dhg, d.H, d.cpad, E, 64)) ||
      !hop::bf16_map3(&m_h, h, d.H, d.cpad, E, 64))
    return cudaErrorInvalidValue;
  return launch_ring(
      d.gated ? dw_wgmma_kernel<true> : dw_wgmma_kernel<false>,
      dim3((d.H + 63) / 64, (d.D + 127) / 128, d.E),
      kConsumers + kGatherers, PW::BYTES, PW::STAGES, stream,
      static_cast<const bf16*>(x), row_id, gate_w,
      static_cast<const bf16*>(g), static_cast<bf16*>(dwi),
      static_cast<bf16*>(dwg), static_cast<bf16*>(dwo), d, m_dh1, m_dhg, m_h);
}

}  // namespace

// x, g, the expert weights, h, dh1, dhg and the dW outputs are one dtype:
// dtype 1 bfloat16, 0 float32 (the flash kernels' codes). row_id is int32
// and gate_w, out, dx, dgw and part are float32. scratch: the fp32
// forward's 6 E D H floats (4 ungated), fp32 dX's 12 E D H (8 ungated),
// fp32 dW's 6 E cpad H (4 ungated); bf16 takes none.
extern "C" int moe_fwd_launch(const void* x, const int* row_id,
                              const float* gate_w, const void* w_in,
                              const void* w_gate, const void* w_out, void* h,
                              float* out, void* scratch, int T, int D, int H,
                              int E, int cpad, int act, int gated, int dtype,
                              cudaStream_t stream) {
  const Dims d{T, D, H, E, cpad, act, gated};
  if (!dims_ok(d) || (gated && !w_gate)) return cudaErrorInvalidValue;
  if (dtype == 1)
    return fwd_bf16(x, row_id, gate_w, w_in, w_gate, w_out, h, out, d,
                    stream);
  if (dtype == 0)
    return fwd_f32(x, row_id, gate_w, w_in, w_gate, w_out, h, out, scratch,
                   d, stream);
  return cudaErrorInvalidValue;
}

extern "C" int moe_dx_launch(const void* x, const int* row_id,
                             const float* gate_w, const void* w_in,
                             const void* w_gate, const void* w_out,
                             const void* g, void* h, void* dh1, void* dhg,
                             float* dxo, float* dgw, float* part,
                             void* scratch, int T,
                             int D, int H, int E, int cpad, int act,
                             int gated, int dtype, cudaStream_t stream) {
  const Dims d{T, D, H, E, cpad, act, gated};
  if (!dims_ok(d) || (gated && (!w_gate || !dhg)))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return dx_bf16(x, row_id, gate_w, w_in, w_gate, w_out, g, h, dh1, dhg,
                   dxo, dgw, part, d, stream);
  if (dtype == 0)
    return dx_f32(x, row_id, gate_w, w_in, w_gate, w_out, g, h, dh1, dhg,
                  dxo, dgw, part, scratch, d, stream);
  return cudaErrorInvalidValue;
}

extern "C" int moe_dw_launch(const void* x, const int* row_id,
                             const float* gate_w, const void* g,
                             const void* h, const void* dh1, const void* dhg,
                             void* dwi, void* dwg, void* dwo, void* scratch,
                             int T, int D,
                             int H, int E, int cpad, int dtype,
                             cudaStream_t stream) {
  const int gated = dhg != nullptr;
  const Dims d{T, D, H, E, cpad, 0, gated};
  if (!dims_ok(d) || (gated && !dwg)) return cudaErrorInvalidValue;
  if (dtype == 1)
    return dw_bf16(x, row_id, gate_w, g, h, dh1, dhg, dwi, dwg, dwo, d,
                   stream);
  if (dtype == 0)
    return dw_f32(x, row_id, gate_w, g, h, dh1, dhg, dwi, dwg, dwo, scratch,
                  d, stream);
  return cudaErrorInvalidValue;
}
