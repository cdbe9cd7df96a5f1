// Flash attention backward for Hopper: dQ, and dK with dV, from (q, k, v,
// dO, lse, delta) over [b, s, h, d] tensors, causal or not.
//
// Replaces the two pallas_calls of
// paddle_tpu/ops/pallas/flash_attention.py::flash_block_grads: the dQ pass
// (_bwd_dq_kernel, :329-389, called at :558) and the dK/dV pass
// (_bwd_dkv_kernel, :392-463, called at :590), with their additive bias
// mode (has_bias), their in-kernel dropout (dropout_p), their segment-id
// mode (has_seg, flash_attn_unpadded :765) and bf16 and fp32 inputs.
//
// Bound on the H100: operations. At the training path's shape (b 4, s 2048,
// h 16, d 128, causal, bf16) dQ is 3 products (103 GFLOP, 104 us at the
// 989 TFLOP/s bf16 peak) and dK/dV 4 products (137 GFLOP, 139 us), against
// ~0.2 GB of inputs and outputs (~60 us at 3.35 TB/s). fp32 products run
// at 3xTF32's fp32-accurate 494.7 / 3 TFLOP/s at best.
//
// Which modes live where, by mode and shape alone (launch_dq, launch_dkv):
// every bf16 mode without segment ids (plain, bias, dropout, bias with
// dropout) runs the wgmma / TMA kernels of flash_bwd_wgmma.cuh; every fp32
// mode at d 64 without segment ids (the same four) the TF32 wgmma kernels
// of flash_bwd_tf32.cuh. The mma.sync kernels below keep the bf16 segment
// mode, every fp32 mode at d 128 and the fp32 segment mode; the design
// below is theirs.
//
// Design. As in the JAX package, two kernels, each with one accumulator
// that a block owns, so neither needs atomics and both are deterministic
// run to run. The TPU kernels carry their accumulators across a sequential
// grid axis; here the loop over that axis runs inside the block.
//   dQ:   one block of 4 warps per (64-row q tile, batch*head); each warp owns
//         16 q rows and loops over the k tiles up to the diagonal:
//         S = Q K^T, P = exp(scale * S - lse), dP = dO V^T,
//         dS = P * (dP - delta) * scale, dQ += dS K.
//   dK/dV: one block of 4 warps per (64-row k tile, batch*head); each warp
//         owns 16 key rows and loops over the q tiles from the diagonal to
//         the end, in the transposed frame: S^T = K Q^T, P^T, dV += P^T dO,
//         dP^T = V dO^T, dS^T, dK += dS^T Q. Its q tiles are 32 rows at
//         d = 128 so that the fp32 dK and dV accumulators (128 registers a
//         lane) and the two score tiles fit the register file.
// Tiles go global -> shared in 16-byte vectors (with cp.async, two shared
// stages, so the next k tile (dQ) or q tile (dK/dV) streams in
// while the block computes the current one) and into tensor-core
// fragments with ldmatrix; the operands that a product needs transposed
// (K in dS K, dO in P^T dO, Q in dS^T Q) come from ldmatrix.trans on the
// same row-major tiles, so nothing is transposed in memory. lse and delta
// are read once per row.
// Bias mode (HAS_BIAS, a template flag; fp32 at d 128 only here, the rest
// in flash_bwd_wgmma.cuh and flash_bwd_tf32.cuh): as in the forward, an
// fp32 bias read through four element strides and added to the fp32 score
// before P is recomputed, at the point where _bwd_dq_kernel (:373) and
// _bwd_dkv_kernel (:437) add it to (q k) * scale. dK/dV reads it in its
// transposed frame, bias[q, key] for its (key row, q column) elements.
// fp32 mode (T = float; at d 64 with segment ids only, see above): the
// same loops on 3xTF32 products
// (flash_common.cuh) over fp32 tiles with LD = D + 4; dP = dO V^T takes
// a fourth pass, lo*lo (mma4): a row that sees one key has dS = P (dP -
// delta) = 0 in exact arithmetic, so its dq and its key's dk are dP's
// rounding alone, and with three passes they missed the fp32 rule at d
// 128 (PERF.md, ROADMAP C6). The tile sizes and
// stages are the bf16 ones (shared memory: dQ 198 KB at d 128, dK/dV 133
// KB, within the 227 KB a block may use).
// Dropout mode (DROP, a template flag; here fp32 at d 128): each lane
// draws
// the keep bits of the elements it holds (philox.cuh; dK/dV in its
// transposed frame, element (query, key) for its (key row, q column)),
// one Philox block for each (dK/dV) or every second (dQ) element, as
// _bwd_dq_kernel (:376-385) and _bwd_dkv_kernel (:440-458) regenerate the
// forward's mask: dP takes
// keep ? dP / (1 - p_drop) : 0 before dS = P * (dP - delta) * scale, and
// dV takes the dropped, rescaled P. delta = rowsum(dO * out) of the
// dropped output, as the wrapper's caller computes it.
// Segment mode (SEG, a template flag, instantiated without bias and
// dropout): as in the forward, each loop runs only over the tiles of the
// other side that the grain summaries allow ([first, end) of its own
// tile, flash_common.cuh) and skips a tile whose id range does not meet
// its own: dQ over k tiles for its q tile, dK/dV over q tiles (of BQ rows)
// for its k tile; the range of the tile after next is loaded while the
// current one is computed. Inside a live tile that holds more than one
// id an element takes P = 0 where its ids differ, after the causal test
// (:366-369, :430-433): each lane reads the other side's ids of its
// columns once for the tile into a bitmask (same_ids), dK/dV in its
// transposed frame (its key rows' ids against the q columns'). Stages
// alternate by the count of live tiles. A key that no query sees gets
// dk = dv = 0, a query that sees no key dq = 0.
//
// Arithmetic against the Pallas kernels (and flash_block_grads_plain):
// S = Q K^T and dP = dO V^T are bf16 products, exact in fp32, in another
// order of sums; P and dS are computed in fp32 and rounded to bf16 as the
// A operand of dV += P^T dO, dQ += dS K and dK += dS^T Q (the TPU's MXU
// rounds its fp32 operands the same way at default precision). The plain
// version keeps them in fp32, so dq, dk and dv differ by about 2^-9 of the
// size of their terms, averaged over the sum. fp32 inputs: every product to
// fp32 accuracy (3xTF32), P and dS too.
//
// C interface (bound with ctypes): flash_bwd_dq_launch and
// flash_bwd_dkv_launch return the CUDA launch error (0 on success); they
// never synchronise.

#include "flash_common.cuh"
#include "flash_bwd_wgmma.cuh"
#include "flash_bwd_tf32.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kBQ = 64;         // dQ: q rows per block
constexpr int kBK = 64;         // keys per tile (both kernels)

template <typename T, int D, bool HAS_BIAS, bool DROP, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int sq, int sk, int64_t q_sb, int64_t q_ss,
                    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                    int64_t o_ss, int64_t o_sh, float scale, bool causal,
                    const float* __restrict__ bias, int64_t b_sb,
                    int64_t b_sh, int64_t b_sq, int64_t b_sk,
                    const int64_t* __restrict__ seed, uint32_t thresh,
                    float inv_keep, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k,
                    const int4* __restrict__ q_info,
                    const int4* __restrict__ k_info) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = Pitch<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + kBQ * LD;    // dO
  T* sK[2] = {sO + kBQ * LD, sO + kBQ * LD + 2 * kBK * LD};   // 2 stages
  T* sV[2] = {sK[0] + kBK * LD, sK[1] + kBK * LD};

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // heaviest tile first
  const int bh = blockIdx.y, bi = bh / H, hi = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;
  uint32_t key0 = 0, key1 = 0;
  if constexpr (DROP) {
    key0 = (uint32_t)seed[0];
    key1 = (uint32_t)seed[1];
  }

  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;
  const int kend = causal ? min(sk, q0 + kBQ + off) : sk;
  int j_end = kend > 0 ? (kend + kBK - 1) / kBK : 0;   // k tiles < j_end
  int jt = 0;                                          // the first one
  // SEG: the k tiles whose ids can meet this q tile's, and the ranges of
  // tiles jt and jn (the next one)
  constexpr int kG = kBK / kSegGrain;   // grains a k tile
  SegWalk<kG> walk{k_info, (sk + kSegGrain - 1) / kSegGrain, 0, 0, 0};
  SegRange rcur{}, rnext{};
  if constexpr (SEG) {
    const SegRange r = seg_range<kBQ / kSegGrain>(
        q_info, q0 / kSegGrain, (sq + kSegGrain - 1) / kSegGrain);
    j_end = min(j_end, (r.end + kG - 1) / kG);
    walk.end = j_end;
    walk.lo = r.lo;
    walk.hi = r.hi;
    jt = walk.next(r.first / kG, rcur);
  }
  auto issue = [&](int j, int st) {   // tile j of K and V into stage st
    const int k0 = j * kBK;
    load_tile_async<kBK, D, LD, kThreads>(sK[st], kb + k0 * k_ss,
                                          k_ss, sk - k0);
    load_tile_async<kBK, D, LD, kThreads>(sV[st], vb + k0 * v_ss,
                                          v_ss, sk - k0);
    cp_async_commit();
  };
  load_tile_async<kBQ, D, LD, kThreads>(
      sQ, q + bi * q_sb + hi * q_sh + q0 * q_ss, q_ss, sq - q0);
  load_tile_async<kBQ, D, LD, kThreads>(
      sO, dout + bi * o_sb + hi * o_sh + q0 * o_ss, o_ss, sq - q0);
  cp_async_commit();
  if (jt < j_end) issue(jt, 0);
  int jn = 0;   // SEG: the next live k tile
  if constexpr (SEG) jn = walk.next(jt + 1, rnext);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* brow[2] = {nullptr, nullptr};   // this lane's bias rows
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias + bi * b_sb + hi * b_sh + (int64_t)row[r] * b_sq;
  }
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < sq;
    lse2[r] = ok ? fmaxf(lse[(int64_t)bh * sq + row[r]], kClamp) * kLog2e
                 : 0.f;
    dlt[r] = ok ? delta[(int64_t)bh * sq + row[r]] : 0.f;
  }
  int srow[2] = {0, 0};   // SEG: this lane's rows' ids
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) srow[r] = row[r] < sq ? seg_q[row[r]] : -1;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; jt < j_end; ++it) {
    if constexpr (!SEG) jn = jt + 1;
    const int k0 = jt * kBK, st = (SEG ? it : jt) & 1;
    const T* cK = sK[st];
    const T* cV = sV[st];
    __syncthreads();   // stage st ^ 1 (the previous tile) is consumed
    if (jn < j_end) {
      issue(jn, st ^ 1);   // streams in while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // Q, dO and tile jt are visible to every warp
    SegRange rpre{};      // SEG: tile jn + 1's range, loaded during this tile
    uint32_t same = ~0u;  // SEG: the elements whose ids are equal
    if constexpr (SEG) {
      if (jn + 1 < j_end) rpre = walk.range(jn + 1);
      if (!walk.uniform(rcur)) same = same_ids<kBK / 8>(seg_k, k0, sk, srow, t);
    }

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    if constexpr (kF32) {
      nt_product_f32<kBK / 8, D, LD>(s, sQ, warp * 16, cK, lane);
      nt_product_f32<kBK / 8, D, LD, mma4>(dp, sO, warp * 16, cV, lane);
    } else {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t aq[4], ao[4];
        ldsm_x4(aq, a_addr<LD>(sQ, warp * 16, ks * 16, lane));
        ldsm_x4(ao, a_addr<LD>(sO, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b_addr<LD>(cK, np * 16, ks * 16, lane));
          mma(s[2 * np], aq, b[0], b[1]);
          mma(s[2 * np + 1], aq, b[2], b[3]);
          ldsm_x4(b, b_addr<LD>(cV, np * 16, ks * 16, lane));
          mma(dp[2 * np], ao, b[0], b[1]);
          mma(dp[2 * np + 1], ao, b[2], b[3]);
        }
      }
    }
    if constexpr (DROP) {   // dP of the dropped P: keep ? dP / (1 - p) : 0
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool keep0, keep1;
          drop_keep2(bh, row[r], k0 + nt * 8 + 2 * t, key0, key1, thresh,
                     keep0, keep1);
          dp[nt][2 * r] = keep0 ? dp[nt][2 * r] * inv_keep : 0.f;
          dp[nt][2 * r + 1] = keep1 ? dp[nt][2 * r + 1] * inv_keep : 0.f;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        float p;
        if constexpr (HAS_BIAS) {
          p = visible(row[r], col, sq, sk, off, causal)
                  ? exp2f(fmaf(s[nt][i], scale_log2,
                               __ldg(brow[r] + col * b_sk) * kLog2e)
                          - lse2[r])
                  : 0.f;
        } else {
          bool vis = visible(row[r], col, sq, sk, off, causal);
          if constexpr (SEG) vis = vis && same_bit(same, nt, i);
          p = vis ? exp2f(s[nt][i] * scale_log2 - lse2[r]) : 0.f;
        }
        s[nt][i] = p * (dp[nt][i] - dlt[r]) * scale;   // dS
      }
    }
    if constexpr (kF32) {
      nn_product_f32<kBK, D, LD>(acc, s, cK, lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t b[4];
          ldsm_x4_t(b, a_addr<LD>(cK, kk * 16, dd * 16, lane));
          mma(acc[2 * dd], a, b[0], b[1]);
          mma(acc[2 * dd + 1], a, b[2], b[3]);
        }
      }
    }
    if constexpr (SEG) {   // the live tile after jn
      int jnn = jn + 1;
      if (jnn < j_end && !walk.live(rpre)) jnn = walk.next(jnn + 1, rpre);
      rcur = rnext;
      rnext = rpre;
      jt = jn;
      jn = jnn;
    } else {
      ++jt;
    }
  }

  cp_async_wait<0>();   // nothing in flight at exit (no live k tile)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    T* drow = dq + (((int64_t)bi * sq + row[r]) * H + hi) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(drow + i * 8 + 2 * t, acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <typename T, int D, int BQ, bool HAS_BIAS, bool DROP, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int sq, int sk,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                     bool causal, const float* __restrict__ bias,
                     int64_t b_sb, int64_t b_sh, int64_t b_sq, int64_t b_sk,
                     const int64_t* __restrict__ seed, uint32_t thresh,
                     float inv_keep, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k,
                     const int4* __restrict__ q_info,
                     const int4* __restrict__ k_info) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = Pitch<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K, V, then two stages of (Q, dO, lse in base 2, delta)
  constexpr int kStage = 2 * BQ * LD * sizeof(T) + 2 * BQ * sizeof(float);
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBK * LD;
  unsigned char* stages = reinterpret_cast<unsigned char*>(sV + kBK * LD);
  T* sQ[2] = {reinterpret_cast<T*>(stages),
              reinterpret_cast<T*>(stages + kStage)};
  T* sO[2] = {sQ[0] + BQ * LD, sQ[1] + BQ * LD};
  float* sL[2] = {reinterpret_cast<float*>(sO[0] + BQ * LD),
                  reinterpret_cast<float*>(sO[1] + BQ * LD)};
  float* sD[2] = {sL[0] + BQ, sL[1] + BQ};

  const int k0 = blockIdx.x * kBK;   // early keys see the most rows: first
  const int bh = blockIdx.y, bi = bh / H, hi = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;
  uint32_t key0 = 0, key1 = 0;
  if constexpr (DROP) {
    key0 = (uint32_t)seed[0];
    key1 = (uint32_t)seed[1];
  }

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* ob = dout + bi * o_sb + hi * o_sh;
  load_tile_async<kBK, D, LD, kThreads>(
      sK, k + bi * k_sb + hi * k_sh + k0 * k_ss, k_ss, sk - k0);
  load_tile_async<kBK, D, LD, kThreads>(
      sV, v + bi * v_sb + hi * v_sh + k0 * v_ss, v_ss, sk - k0);
  cp_async_commit();

  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* bkey[2] = {nullptr, nullptr};   // this lane's bias columns
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bkey[r] = bias + bi * b_sb + hi * b_sh + (int64_t)krow[r] * b_sk;
  }
  int skey[2] = {0, 0};   // SEG: this lane's key rows' ids
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) skey[r] = krow[r] < sk ? seg_k[krow[r]] : -1;
  }
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  // causal: query row r sees key k0 when r >= k0 - off
  const int first = causal ? max(0, k0 - off) : 0;
  const int i0 = first / BQ, n_qt = (sq + BQ - 1) / BQ;
  int i_end = n_qt;       // q tiles < i_end
  int it = i0;            // the first one
  // SEG: the q tiles whose ids can meet this k tile's, and the ranges of
  // tiles it and in (the next one)
  constexpr int kG = BQ / kSegGrain;   // grains a q tile
  SegWalk<kG> walk{q_info, (sq + kSegGrain - 1) / kSegGrain, 0, 0, 0};
  SegRange rcur{}, rnext{};
  if constexpr (SEG) {
    const SegRange r = seg_range<kBK / kSegGrain>(
        k_info, k0 / kSegGrain, (sk + kSegGrain - 1) / kSegGrain);
    i_end = min(i_end, (r.end + kG - 1) / kG);
    walk.end = i_end;
    walk.lo = r.lo;
    walk.hi = r.hi;
    it = walk.next(max(it, r.first / kG), rcur);
  }
  auto issue = [&](int iq, int st) {   // q tile iq into stage st
    const int qs0 = iq * BQ;
    load_tile_async<BQ, D, LD, kThreads>(sQ[st], qb + qs0 * q_ss, q_ss,
                                         sq - qs0);
    load_tile_async<BQ, D, LD, kThreads>(sO[st], ob + qs0 * o_ss, o_ss,
                                         sq - qs0);
    cp_async_commit();
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool ok = qs0 + i < sq;
      sL[st][i] = ok ? fmaxf(lse[(int64_t)bh * sq + qs0 + i], kClamp) * kLog2e
                     : 0.f;
      sD[st][i] = ok ? delta[(int64_t)bh * sq + qs0 + i] : 0.f;
    }
  };
  if (it < i_end) issue(it, (SEG ? 0 : it) & 1);
  int in = 0;   // SEG: the next live q tile
  if constexpr (SEG) in = walk.next(it + 1, rnext);
  for (int n = 0; it < i_end; ++n) {
    if constexpr (!SEG) in = it + 1;
    const int qs0 = it * BQ, st = (SEG ? n : it) & 1;
    const T* cQ = sQ[st];
    const T* cO = sO[st];
    const float* cL = sL[st];
    const float* cD = sD[st];
    __syncthreads();   // stage st ^ 1 (the previous q tile) is consumed
    if (in < i_end) {
      issue(in, st ^ 1);   // streams in while this q tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // K, V and q tile it are visible to every warp
    SegRange rpre{};      // SEG: tile in + 1's range, loaded during this tile
    uint32_t same = ~0u;  // SEG: the elements whose ids are equal
    if constexpr (SEG) {
      if (in + 1 < i_end) rpre = walk.range(in + 1);
      if (!walk.uniform(rcur)) same = same_ids<BQ / 8>(seg_q, qs0, sq, skey, t);
    }

    float s[BQ / 8][4], dp[BQ / 8][4];   // S^T and dP^T: key rows x q cols
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    if constexpr (kF32) {
      nt_product_f32<BQ / 8, D, LD>(s, sK, warp * 16, cQ, lane);
      nt_product_f32<BQ / 8, D, LD, mma4>(dp, sV, warp * 16, cO, lane);
    } else {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, a_addr<LD>(sK, warp * 16, ks * 16, lane));
        ldsm_x4(av, a_addr<LD>(sV, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b_addr<LD>(cQ, np * 16, ks * 16, lane));
          mma(s[2 * np], ak, b[0], b[1]);
          mma(s[2 * np + 1], ak, b[2], b[3]);
          ldsm_x4(b, b_addr<LD>(cO, np * 16, ks * 16, lane));
          mma(dp[2 * np], av, b[0], b[1]);
          mma(dp[2 * np + 1], av, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + 2 * t + (i & 1);   // q row within the tile
        float p;
        if constexpr (HAS_BIAS) {
          p = visible(qs0 + c, krow[i >> 1], sq, sk, off, causal)
                  ? exp2f(fmaf(s[nt][i], scale_log2,
                               __ldg(bkey[i >> 1] + (int64_t)(qs0 + c) * b_sq)
                                   * kLog2e)
                          - cL[c])
                  : 0.f;
        } else {
          bool vis = visible(qs0 + c, krow[i >> 1], sq, sk, off, causal);
          if constexpr (SEG) vis = vis && same_bit(same, nt, i);
          p = vis ? exp2f(s[nt][i] * scale_log2 - cL[c]) : 0.f;
        }
        float dpv = dp[nt][i];
        if constexpr (DROP) {   // element (query qs0 + c, key krow)
          const bool keep = drop_keep(bh, qs0 + c, krow[i >> 1], key0, key1,
                                      thresh);
          s[nt][i] = keep ? p * inv_keep : 0.f;         // dropped P^T
          dpv = keep ? dpv * inv_keep : 0.f;
        } else {
          s[nt][i] = p;                                   // P^T
        }
        dp[nt][i] = p * (dpv - cD[c]) * scale;          // dS^T
      }
    }
    if constexpr (kF32) {
      nn_product_f32<BQ, D, LD>(dva, s, cO, lane);
      nn_product_f32<BQ, D, LD>(dka, dp, cQ, lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t as[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t b[4];
          ldsm_x4_t(b, a_addr<LD>(cO, kk * 16, dd * 16, lane));
          mma(dva[2 * dd], ap, b[0], b[1]);
          mma(dva[2 * dd + 1], ap, b[2], b[3]);
          ldsm_x4_t(b, a_addr<LD>(cQ, kk * 16, dd * 16, lane));
          mma(dka[2 * dd], as, b[0], b[1]);
          mma(dka[2 * dd + 1], as, b[2], b[3]);
        }
      }
    }
    if constexpr (SEG) {   // the live tile after in
      int inn = in + 1;
      if (inn < i_end && !walk.live(rpre)) inn = walk.next(inn + 1, rpre);
      rcur = rnext;
      rnext = rpre;
      it = in;
      in = inn;
    } else {
      ++it;
    }
  }

  cp_async_wait<0>();   // nothing in flight at exit (no live q tile)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    const int64_t base = (((int64_t)bi * sk + krow[r]) * H + hi) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      store2(dk + base + i * 8 + 2 * t, dka[i][2 * r], dka[i][2 * r + 1]);
      store2(dv + base + i * 8 + 2 * t, dva[i][2 * r], dva[i][2 * r + 1]);
    }
  }
}

// d = 128 takes 32-row q tiles in dK/dV (registers), d = 64 takes 64
template <int D> struct DkvTile { static constexpr int BQ = D == 128 ? 32 : 64; };

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* delta, void* dq, const void* bias,
              const void* seed, const void* const* seg, int b, int h, int sq,
              int sk, const int64_t* st, float scale, int causal,
              uint32_t thresh, float inv_keep, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const flash_wg::Mode md = {static_cast<const float*>(bias), st[12],
                             st[13], st[14], st[15],
                             static_cast<const int64_t*>(seed), thresh,
                             inv_keep};
  if constexpr (kBf16) {   // every bf16 mode but the segment one
    if (!seg[0])
      return flash_wg::dq_launch<D>(q, k, v, o, lse, delta, dq, b, h, sq, sk,
                                    st, scale, causal, md, stream);
  } else if constexpr (D == 64) {   // every fp32 mode at d 64 but segments
    if (!seg[0])
      return flash_tf32::dq_launch(q, k, v, o, lse, delta, dq, b, h, sq, sk,
                                   st, scale, causal, md, stream);
  }
  const size_t smem = sizeof(T) * (2 * kBQ + 4 * kBK) * Pitch<T, D>::LD;
  auto kern = flash_bwd_dq_kernel<T, D, false, false, true>;   // segment ids
  if constexpr (!kBf16 && D == 128) {   // fp32 at d 128, every mode
    if (!seg[0])
      kern = bias ? (seed ? flash_bwd_dq_kernel<T, D, true, true, false>
                          : flash_bwd_dq_kernel<T, D, true, false, false>)
                  : (seed ? flash_bwd_dq_kernel<T, D, false, true, false>
                          : flash_bwd_dq_kernel<T, D, false, false, false>);
  }
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), h, sq, sk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal != 0,
      static_cast<const float*>(bias), st[12], st[13], st[14], st[15],
      static_cast<const int64_t*>(seed), thresh, inv_keep,
      static_cast<const int*>(seg[0]), static_cast<const int*>(seg[1]),
      static_cast<const int4*>(seg[2]), static_cast<const int4*>(seg[3]));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* bias, const void* seed, const void* const* seg,
               int b, int h, int sq, int sk, const int64_t* st, float scale,
               int causal, uint32_t thresh, float inv_keep,
               cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const flash_wg::Mode md = {static_cast<const float*>(bias), st[12],
                             st[13], st[14], st[15],
                             static_cast<const int64_t*>(seed), thresh,
                             inv_keep};
  if constexpr (kBf16) {   // every bf16 mode but the segment one
    if (!seg[0])
      return flash_wg::dkv_launch<D>(q, k, v, o, lse, delta, dk, dv, b, h, sq,
                                     sk, st, scale, causal, md, stream);
  } else if constexpr (D == 64) {   // every fp32 mode at d 64 but segments
    if (!seg[0])
      return flash_tf32::dkv_launch(q, k, v, o, lse, delta, dk, dv, b, h, sq,
                                    sk, st, scale, causal, md, stream);
  }
  constexpr int BQ = DkvTile<D>::BQ;
  const size_t smem = sizeof(T) * (4 * BQ + 2 * kBK) * Pitch<T, D>::LD
                      + sizeof(float) * 4 * BQ;
  auto kern = flash_bwd_dkv_kernel<T, D, BQ, false, false, true>;   // seg
  if constexpr (!kBf16 && D == 128) {   // fp32 at d 128, every mode
    if (!seg[0])
      kern = bias
          ? (seed ? flash_bwd_dkv_kernel<T, D, BQ, true, true, false>
                  : flash_bwd_dkv_kernel<T, D, BQ, true, false, false>)
          : (seed ? flash_bwd_dkv_kernel<T, D, BQ, false, true, false>
                  : flash_bwd_dkv_kernel<T, D, BQ, false, false, false>);
  }
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + kBK - 1) / kBK, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, sq, sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal != 0, static_cast<const float*>(bias), st[12],
      st[13], st[14], st[15], static_cast<const int64_t*>(seed), thresh,
      inv_keep, static_cast<const int*>(seg[0]),
      static_cast<const int*>(seg[1]), static_cast<const int4*>(seg[2]),
      static_cast<const int4*>(seg[3]));
  return (int)cudaGetLastError();
}

bool shape_ok(int64_t b, int64_t h, int64_t sq, int64_t sk) {
  return b * h <= 65535 && sq <= (1 << 30) && sk <= (1 << 30);
}

// segment ids take neither a bias nor dropout
bool seg_ok(const void* const* seg, const void* bias, const void* seed) {
  return !seg[0] || (!bias && !seed);
}

}  // namespace

// q, k, v, dO and the gradients are one dtype: dtype 1 bfloat16, 0
// float32. Strides are in elements, (batch, seq, head) for each of q, k, v
// and dO; head_dim is contiguous. lse and delta are fp32 [b, h, sq]; dq is
// contiguous [b, sq, h, d]. bias is null (no bias) or fp32, element (b, h,
// q, k) at bias_sb * b + bias_sh * h + bias_sq * q + bias_sk * k (a
// broadcast dimension: stride 0). seed is null (no dropout) or the
// forward's device int64 [2] (seed, offset), with its thresh and inv_keep.
// seg_q, seg_k, q_info and k_info are null (no segment ids) or as in
// flash_fwd_launch.
extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* bias,
    const void* seed, const void* seg_q, const void* seg_k,
    const void* q_info, const void* k_info, int64_t b, int64_t h,
    int64_t sq, int64_t sk,
    int64_t d, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t bias_sb,
    int64_t bias_sh, int64_t bias_sq, int64_t bias_sk, float scale,
    int causal, int dtype, uint32_t thresh, float inv_keep, void* stream) {
  if (b * h <= 0 || sq <= 0 || sk <= 0) return 0;
  const void* const seg[4] = {seg_q, seg_k, q_info, k_info};
  if (!shape_ok(b, h, sq, sk) || !seg_ok(seg, bias, seed))
    return (int)cudaErrorInvalidValue;
  const int64_t st[16] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                          bias_sb, bias_sh, bias_sq, bias_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_DQ_LAUNCH(T, D)                                                \
  return launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bias, seed, seg,    \
                         (int)b, (int)h, (int)sq, (int)sk, st, scale,       \
                         causal, thresh, inv_keep, s)
  if (dtype == 1 && d == 64) FLASH_DQ_LAUNCH(bf16, 64);
  if (dtype == 1 && d == 128) FLASH_DQ_LAUNCH(bf16, 128);
  if (dtype == 0 && d == 64) FLASH_DQ_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) FLASH_DQ_LAUNCH(float, 128);
#undef FLASH_DQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_launch; dk and dv are contiguous [b, sk, h, d].
extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* bias,
    const void* seed, const void* seg_q, const void* seg_k,
    const void* q_info, const void* k_info, int64_t b, int64_t h,
    int64_t sq, int64_t sk,
    int64_t d, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t bias_sb,
    int64_t bias_sh, int64_t bias_sq, int64_t bias_sk, float scale,
    int causal, int dtype, uint32_t thresh, float inv_keep, void* stream) {
  if (b * h <= 0 || sq <= 0 || sk <= 0) return 0;
  const void* const seg[4] = {seg_q, seg_k, q_info, k_info};
  if (!shape_ok(b, h, sq, sk) || !seg_ok(seg, bias, seed))
    return (int)cudaErrorInvalidValue;
  const int64_t st[16] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                          bias_sb, bias_sh, bias_sq, bias_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_DKV_LAUNCH(T, D)                                               \
  return launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bias, seed,    \
                          seg, (int)b, (int)h, (int)sq, (int)sk, st, scale, \
                          causal, thresh, inv_keep, s)
  if (dtype == 1 && d == 64) FLASH_DKV_LAUNCH(bf16, 64);
  if (dtype == 1 && d == 128) FLASH_DKV_LAUNCH(bf16, 128);
  if (dtype == 0 && d == 64) FLASH_DKV_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) FLASH_DKV_LAUNCH(float, 128);
#undef FLASH_DKV_LAUNCH
  return (int)cudaErrorInvalidValue;
}
