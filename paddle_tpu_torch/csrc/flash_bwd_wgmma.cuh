// The bf16 flash backward on Hopper (sm_90a): dQ and dK/dV on wgmma, with
// every tile fed by TMA through an mbarrier ring.
//
// Replaces, for bf16 inputs without segment ids (causal or not, d 64 or
// 128, with or without an additive bias and in-kernel dropout: the modes
// that Llama, Qwen2-MoE, BERT and GPT-2 train with in bf16), the two
// pallas_calls of paddle_tpu/ops/pallas/flash_attention.py::
// flash_block_grads: the dQ pass (_bwd_dq_kernel, :329-389, called at
// :558) and the dK/dV pass (_bwd_dkv_kernel, :392-463, called at :590).
// flash_attention_bwd.cu's launchers route these modes here; the segment
// mode and every fp32 mode keep the mma.sync kernels there. With P
// recomputed from lse:
//   dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q, dV = P^T dO.
//
// Bound on the H100: operations. At the training path's shape (b 4, s 2048,
// h 16, d 128, causal) dQ is 3 products (103 GFLOP, 104 us at the 989
// TFLOP/s bf16 peak) and dK/dV 4 (137 GFLOP, 139 us), against ~60 us of
// bytes.
//
// Design. A block is three warpgroups: warpgroups 0 and 1 consume, each
// owning 64 rows of the block's 128-row tile; in warpgroup 2 one thread
// issues every TMA load and the rest idle, so setmaxnreg hands its
// registers to the consumers (24 a thread against 240). Each tile is
// 128B-swizzled 64-column atoms (hopper.cuh), a d-128 row two of them.
//   dQ: a block per (128-row q tile, batch*head), heaviest causal tile
//       first. Q and dO are loaded once; K and V tiles of 64 keys come
//       through a 3-stage ring up to the diagonal. Per k tile each
//       consumer runs S = Q K^T and dP = dO V^T (wgmma with both operands
//       in shared memory, K-major), makes P = exp(S scale - lse) and dS in
//       registers, and accumulates dQ += dS K with dS as the A operand
//       from registers (the RS form; its accumulator layout is that A
//       fragment) and K as an MN-major B: no transpose through memory.
//   dK/dV: a block per (128-key tile, batch*head), first keys first. K
//       and V are loaded once; Q and dO tiles of 64 rows come through the
//       ring from the diagonal on, each stage with its rows' lse and delta
//       (read by the producer warp's lanes and stored beside the tiles).
//       Each consumer works in the transposed frame: S^T = K Q^T and dP^T
//       = V dO^T (both operands in shared memory), then dV += P^T dO and
//       dK += dS^T Q with P^T and dS^T from registers and dO, Q MN-major.
//       Its fp32 dK and dV (64 keys x d, 128 registers a thread at d 128)
//       and the two score tiles fit in the 240 registers setmaxnreg gives.
// Within a tile the products go in separate commit groups, so a consumer
// makes P while dP runs (and in dK/dV dS while dV += P^T dO runs); the
// other consumer fills the tensor cores while this one works on its
// registers. Every operand that stays for the whole loop (Q and dO, or K
// and V) is read from shared memory: held in registers as A fragments it
// saved 2-5% more, but ptxas then gave a later product's A fragment the
// same registers at d 64, so every tile after the first read garbage
// (PERF.md §6).
// A consumer skips the products of a tile that none of its rows can see
// (causal), and tests each element only on the tiles that cross the
// diagonal or the ragged end (P = 0 for an element a query cannot see, or
// past sq or sk); a row past the end reads TMA's zeros and is not stored.
// A query that sees no key gets dq = 0, a key that no query sees dk = dv =
// 0. A stage goes back to the producer only after the wgmma.wait_group
// that covers every group that read it (the release rule: each release
// below names its wait). No atomics: each output row belongs to one
// block, and the sums run in one fixed order, so results repeat bitwise.
//
// Bias mode (HAS_BIAS) and dropout mode (DROP): template flags, never
// run-time branches (ptxas serialises every wgmma of a kernel around a
// branch it cannot see through; PERF.md §6). Both act where
// _bwd_dq_kernel (:373-385) and _bwd_dkv_kernel (:437-458) act.
// - The bias is fp32, read through four element strides, any of them 0
//   (BERT's key padding is [b, 1, 1, sk] expanded), so TMA cannot load it
//   (bf16_map4 refuses a broadcast stride): each consumer lane reads its
//   own elements with __ldg, dK/dV as bias[q, key] in its transposed
//   frame, and issues a tile's loads right after the S and dP groups are
//   committed, so their latency hides under the products. P = exp2(S
//   scale log2e + bias log2e - lse log2e); a bias of -inf or -1e30, and a
//   row that sees no key (lse clamped at -1e25), give P = 0 and no NaN.
//   At d 128 a dK/dV consumer holds dK and dV in 128 registers, so it
//   loads the bias one 8-column chunk ahead of the chunk it makes.
// - Dropout: the keep bits of a tile are drawn in the same place, as
//   integer work under the products, one Philox block per four elements
//   (philox.cuh's lane exchanges), and packed in one register (bit 4 n +
//   i for accumulator element [n][i]). dQ: dP takes keep ? dP / (1 - p) :
//   0 before dS = P (dP - delta) scale. dK/dV: dV += (keep ? P^T / (1 -
//   p) : 0) dO, dP^T is masked the same way, and dS^T takes the undropped
//   P^T. delta = rowsum(dO * out) of the dropped output, as the wrapper's
//   caller computes it.
//
// Arithmetic: as flash_attention_bwd.cu's bf16 mode: the products in fp32
// from bf16 operands, P and dS rounded to bf16 as A operands.

#pragma once

#include "flash_wg_common.cuh"

namespace flash_wg {

constexpr int kStages = 3;

// ---- dQ: block (batch*head, q tile); q rows q0.., 64 wg.. a consumer ----
template <int D, bool HAS_BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int H, int sq, int sk, float scale, int causal, const Mode md,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o) {
  constexpr int NC = D / 64;                 // 64-column atoms a row
  constexpr uint32_t kQ = NC * 2 * kAtom;    // Q or dO: NC atoms of 128 rows
  constexpr uint32_t kKV = NC * kAtom;       // a K or V tile: 64 keys
  constexpr uint32_t kStage = 2 * kKV;       // K, then V
  __shared__ uint64_t full[kStages], empty[kStages], qbar;
  const uint32_t base = hop::smem_u32(tiles());
  const uint32_t sQ = base, sO = base + kQ, ring = base + 2 * kQ;

  const int bh = blockIdx.x, bi = bh / H, hi = bh % H;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kRows;
  const int off = sk - sq;
  const int kend = causal ? min(sk, q0 + kRows + off) : sk;
  const int n_kt = kend > 0 ? (kend + 63) / 64 : 0;   // k tiles to visit
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(hop::smem_u32(&full[s]), 1);
      hop::mbar_init(hop::smem_u32(&empty[s]), kConsumerWarps);
    }
    hop::mbar_init(hop::smem_u32(&qbar), 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {                                     // the producer
    hop::reg_dealloc<24>();
    if (tid != 256 || n_kt == 0) return;
    const uint32_t qb = hop::smem_u32(&qbar);
    hop::mbar_arrive_tx(qb, 2 * kQ);
    for (int c = 0; c < NC; ++c) {
      hop::tma_load4(sQ + c * 2 * kAtom, &tm_q, qb, c * 64, q0, hi, bi);
      hop::tma_load4(sO + c * 2 * kAtom, &tm_o, qb, c * 64, q0, hi, bi);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages;
      const uint32_t f = hop::smem_u32(&full[s]), st = ring + s * kStage;
      hop::mbar_wait(hop::smem_u32(&empty[s]), ((j / kStages) & 1) ^ 1);
      hop::mbar_arrive_tx(f, kStage);
      for (int c = 0; c < NC; ++c) {
        hop::tma_load4(st + c * kAtom, &tm_k, f, c * 64, j * 64, hi, bi);
        hop::tma_load4(st + kKV + c * kAtom, &tm_v, f, c * 64, j * 64, hi,
                       bi);
      }
    }
    return;
  }
  hop::reg_alloc<240>();

  const int warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int r0 = q0 + 64 * wg;                       // this consumer's rows
  const int row[2] = {r0 + 16 * warp + (lane >> 2),
                      r0 + 16 * warp + (lane >> 2) + 8};
  const float scale_log2 = scale * flash::kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < sq;
    lse2[r] = ok ? fmaxf(lse[(int64_t)bh * sq + row[r]], flash::kClamp)
                       * flash::kLog2e
                 : 0.f;
    dlt[r] = ok ? delta[(int64_t)bh * sq + row[r]] : 0.f;
  }
  // HAS_BIAS: this lane's bias rows at its first column (a row past sq
  // reads row sq - 1: it is never stored)
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = md.bias + bi * md.b_sb + hi * md.b_sh
                + (int64_t)min(row[r], sq - 1) * md.b_sq
                + (int64_t)(2 * t) * md.b_sk;
  }
  uint32_t key0 = 0, key1 = 0;                       // DROP: the Philox key
  if constexpr (DROP) {
    key0 = (uint32_t)md.seed[0];
    key1 = (uint32_t)md.seed[1];
  }
  // the keys this consumer's rows can see lie below wkend
  const int wkend = causal ? min(sk, r0 + 64 + off) : sk;
  float acc[NC][8][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  if (n_kt > 0) hop::mbar_wait(hop::smem_u32(&qbar), 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages, k0 = j * 64;
    const uint32_t st = ring + s * kStage;
    hop::mbar_wait(hop::smem_u32(&full[s]), (j / kStages) & 1);
    // a vote, so that ptxas sees the products' branch uniform (one it may
    // think divergent makes it serialise every wgmma of the kernel)
    if (__any_sync(0xffffffffu, k0 < wkend)) {
      float sc[8][4], dp[8][4];
      zero(sc);
      zero(dp);
      hop::wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)              // S = Q K^T
        hop::wgmma_chunk<0, 0>(sc, sQ + c * 2 * kAtom + wg * kAtom,
                               st + c * kAtom);
      hop::wg_commit();
#pragma unroll
      for (int c = 0; c < NC; ++c)              // dP = dO V^T
        hop::wgmma_chunk<0, 0>(dp, sO + c * 2 * kAtom + wg * kAtom,
                               st + kKV + c * kAtom);
      hop::wg_commit();
      // under the products: the tile's bias loads and keep bits
      float bb[8][4];
      if constexpr (HAS_BIAS) {
        const float* bp[2] = {brow[0] + (int64_t)k0 * md.b_sk,
                              brow[1] + (int64_t)k0 * md.b_sk};
#pragma unroll
        for (int n = 0; n < 8; ++n)
          bias_chunk(bb[n], bp, md.b_sk, n, k0 + 2 * t, sk);
      }
      uint32_t keep = 0;
      if constexpr (DROP)
        keep = flash::keep_bits_qk(bh, row[0], row[1], k0 + 2 * t, key0,
                                   key1, md.thresh, lane);
      hop::wg_wait<1>();                        // S is done, dP runs on
      hop::acc_fence(sc);
      // the diagonal (causal) or the ragged end crosses this tile
      const bool edge = (causal && k0 + 63 > r0 + off) || k0 + 64 > sk;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int col = k0 + 8 * n + 2 * t + (i & 1);
          const bool vis = !edge
                           || flash::visible(row[r], col, sq, sk, off,
                                             causal != 0);
          float lb = -lse2[r];                  // (bias - lse) log2e
          if constexpr (HAS_BIAS) lb = fmaf(bb[n][i], flash::kLog2e, lb);
          sc[n][i] = vis ? ex2(fmaf(sc[n][i], scale_log2, lb)) : 0.f;
        }
      hop::wg_wait<0>();                        // dP is done
      hop::acc_fence(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float dpk = dp[n][i];                 // dP of the dropped P
          if constexpr (DROP) dpk = kept(dpk, keep, 4 * n + i, md.inv_keep);
          sc[n][i] = sc[n][i] * (dpk - dlt[i >> 1]) * scale;   // dS
        }
      uint32_t a[4][4];
      hop::acc_to_a(a, sc);
      hop::wg_fence();
      hop::wgmma_rs_chunk<1, NC>(acc, a, st, kAtom);  // dQ += dS K
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    // release stage s: after the wg_wait<0> just above, which covers the
    // S, dP and dQ += dS K groups, every group that read the stage
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) hop::acc_fence(acc[c]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    bf16* drow = dq + (((int64_t)bi * sq + row[r]) * H + hi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        flash::store2(drow + c * 64 + 8 * n + 2 * t,
                      acc[c][n][2 * r], acc[c][n][2 * r + 1]);
  }
}

// ---- dK/dV: block (batch*head, key tile); keys k0.., 64 wg.. a consumer,
// in the transposed frame (key rows x q columns) ----
template <int D, bool HAS_BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
dkv_wgmma_kernel(const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int H, int sq, int sk, float scale,
                 int causal, const Mode md,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o) {
  constexpr int NC = D / 64;
  constexpr uint32_t kKV = NC * 2 * kAtom;   // K or V: NC atoms of 128 keys
  constexpr uint32_t kQO = NC * kAtom;       // a Q or dO tile: 64 rows
  // Q, dO, then the rows' lse (base 2) and delta: 512 bytes, padded so
  // that the next stage's tiles stay 1024-byte aligned
  constexpr uint32_t kStage = 2 * kQO + 1024;
  // HAS_BIAS: the chunks whose bias loads go before the wait on S^T; at d
  // 128, where dK and dV hold 128 registers, one, and chunk n + 1's loads
  // go out while chunk n is made (more spilled: ptxas, PERF.md §6)
  constexpr int kPre = D == 64 ? 8 : 1;
  __shared__ uint64_t full[kStages], empty[kStages], kvbar;
  unsigned char* smem = tiles();
  const uint32_t base = hop::smem_u32(smem);
  const uint32_t sK = base, sV = base + kKV, ring = base + 2 * kKV;

  const int bh = blockIdx.x, bi = bh / H, hi = bh % H;
  const int k0 = blockIdx.y * kRows;   // early keys see the most rows: first
  const int off = sk - sq;
  // causal: query row r sees key k0 when r >= k0 - off
  const int i0 = (causal ? max(0, k0 - off) : 0) / 64;
  const int n_qt = max(0, (sq + 63) / 64 - i0);     // q tiles to visit
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(hop::smem_u32(&full[s]), 32);  // the producer's lanes
      hop::mbar_init(hop::smem_u32(&empty[s]), kConsumerWarps);
    }
    hop::mbar_init(hop::smem_u32(&kvbar), 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {                                     // the producer
    hop::reg_dealloc<24>();
    if (tid >= 288 || n_qt == 0) return;             // its first warp
    if (lane == 0) {
      const uint32_t kb = hop::smem_u32(&kvbar);
      hop::mbar_arrive_tx(kb, 2 * kKV);
      for (int c = 0; c < NC; ++c) {
        hop::tma_load4(sK + c * 2 * kAtom, &tm_k, kb, c * 64, k0, hi, bi);
        hop::tma_load4(sV + c * 2 * kAtom, &tm_v, kb, c * 64, k0, hi, bi);
      }
    }
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages, qs0 = (i0 + j) * 64;
      const uint32_t f = hop::smem_u32(&full[s]), st = ring + s * kStage;
      float* stat = reinterpret_cast<float*>(smem + (st - base) + 2 * kQO);
      float l2[2], dl[2];                            // rows lane, lane + 32
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qs0 + lane + 32 * r;
        const bool ok = q < sq;
        l2[r] = ok ? fmaxf(lse[(int64_t)bh * sq + q], flash::kClamp)
                         * flash::kLog2e
                   : 0.f;
        dl[r] = ok ? delta[(int64_t)bh * sq + q] : 0.f;
      }
      hop::mbar_wait(hop::smem_u32(&empty[s]), ((j / kStages) & 1) ^ 1);
      stat[lane] = l2[0];
      stat[lane + 32] = l2[1];
      stat[64 + lane] = dl[0];
      stat[96 + lane] = dl[1];
      if (lane == 0) {
        hop::mbar_arrive_tx(f, 2 * kQO);
        for (int c = 0; c < NC; ++c) {
          hop::tma_load4(st + c * kAtom, &tm_q, f, c * 64, qs0, hi, bi);
          hop::tma_load4(st + kQO + c * kAtom, &tm_o, f, c * 64, qs0, hi,
                         bi);
        }
      } else {
        hop::mbar_arrive(f);
      }
    }
    return;
  }
  hop::reg_alloc<240>();

  const int warp = (tid >> 5) & 3, t = lane & 3;
  const int kr0 = k0 + 64 * wg;                      // this consumer's keys
  const int krow[2] = {kr0 + 16 * warp + (lane >> 2),
                       kr0 + 16 * warp + (lane >> 2) + 8};
  const float scale_log2 = scale * flash::kLog2e;
  // HAS_BIAS: this lane's bias columns bias[., key] at its first query (a
  // key past sk reads key sk - 1: it is never stored)
  const float* bkey[2] = {nullptr, nullptr};
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bkey[r] = md.bias + bi * md.b_sb + hi * md.b_sh
                + (int64_t)min(krow[r], sk - 1) * md.b_sk
                + (int64_t)(2 * t) * md.b_sq;
  }
  uint32_t key0 = 0, key1 = 0;                       // DROP: the Philox key
  if constexpr (DROP) {
    key0 = (uint32_t)md.seed[0];
    key1 = (uint32_t)md.seed[1];
  }
  float dka[NC][8][4], dva[NC][8][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    zero(dka[c]);
    zero(dva[c]);
  }
  if (n_qt > 0) hop::mbar_wait(hop::smem_u32(&kvbar), 0);

  for (int j = 0; j < n_qt; ++j) {
    const int s = j % kStages, qs0 = (i0 + j) * 64;
    const uint32_t st = ring + s * kStage;
    const float* stat =
        reinterpret_cast<const float*>(smem + (st - base) + 2 * kQO);
    hop::mbar_wait(hop::smem_u32(&full[s]), (j / kStages) & 1);
    // some row of the tile sees a key of this consumer (a vote: see dQ)
    if (__any_sync(0xffffffffu, !causal || qs0 + 63 >= kr0 - off)) {
      float sc[8][4], dp[8][4];                      // S^T, dP^T
      zero(sc);
      zero(dp);
      hop::wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)              // S^T = K Q^T
        hop::wgmma_chunk<0, 0>(sc, sK + c * 2 * kAtom + wg * kAtom,
                               st + c * kAtom);
      hop::wg_commit();
#pragma unroll
      for (int c = 0; c < NC; ++c)              // dP^T = V dO^T
        hop::wgmma_chunk<0, 0>(dp, sV + c * 2 * kAtom + wg * kAtom,
                               st + kQO + c * kAtom);
      hop::wg_commit();
      // under the products: the tile's bias loads and keep bits
      float bt[8][4];                                // bias^T
      const float* bq[2] = {nullptr, nullptr};
      if constexpr (HAS_BIAS) {
        bq[0] = bkey[0] + (int64_t)qs0 * md.b_sq;
        bq[1] = bkey[1] + (int64_t)qs0 * md.b_sq;
#pragma unroll
        for (int n = 0; n < kPre; ++n)
          bias_chunk(bt[n], bq, md.b_sq, n, qs0 + 2 * t, sq);
      }
      uint32_t keep = 0;
      if constexpr (DROP)
        keep = flash::keep_bits_kq(bh, krow[0], krow[1], qs0 + 2 * t, key0,
                                   key1, md.thresh, lane);
      hop::wg_wait<1>();                        // S^T is done, dP^T runs on
      hop::acc_fence(sc);
      const bool edge = (causal && qs0 < kr0 + 63 - off) || kr0 + 64 > sk
                        || qs0 + 64 > sq;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if constexpr (HAS_BIAS && kPre < 8) {
          if (n + kPre < 8)
            bias_chunk(bt[n + kPre], bq, md.b_sq, n + kPre, qs0 + 2 * t, sq);
        }
        const int c2 = 8 * n + 2 * t;                // q rows c2, c2 + 1
        const float2 l2 = *reinterpret_cast<const float2*>(stat + c2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool odd = i & 1;
          const bool vis = !edge
                           || flash::visible(qs0 + c2 + odd, krow[i >> 1], sq,
                                             sk, off, causal != 0);
          float lbt = -(odd ? l2.y : l2.x);     // (bias^T - lse) log2e
          if constexpr (HAS_BIAS) lbt = fmaf(bt[n][i], flash::kLog2e, lbt);
          sc[n][i] = vis ? ex2(fmaf(sc[n][i], scale_log2, lbt)) : 0.f;  // P^T
        }
      }
      uint32_t ap[4][4], as[4][4];
      if constexpr (DROP)
        acc_to_a_kept(ap, sc, keep, md.inv_keep);   // the dropped P^T
      else
        hop::acc_to_a(ap, sc);
      hop::wg_fence();
      hop::wgmma_rs_chunk<1, NC>(dva, ap, st + kQO, kAtom);  // dV += P^T dO
      hop::wg_commit();
      hop::wg_wait<1>();                        // dP^T is done, dV runs on
      hop::acc_fence(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c2 = 8 * n + 2 * t;
        const float2 dl = *reinterpret_cast<const float2*>(stat + 64 + c2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float dpt = dp[n][i];                 // dP^T of the dropped P^T
          if constexpr (DROP) dpt = kept(dpt, keep, 4 * n + i, md.inv_keep);
          dp[n][i] = sc[n][i] * (dpt - ((i & 1) ? dl.y : dl.x))
                     * scale;                                        // dS^T
        }
      }
      hop::acc_to_a(as, dp);
      hop::wg_fence();
      hop::wgmma_rs_chunk<1, NC>(dka, as, st, kAtom);        // dK += dS^T Q
      hop::wg_commit();
      hop::wg_wait<0>();
    }
    // release stage s: after the wg_wait<0> just above, which covers the
    // S^T, dP^T, dV and dK groups, every group that read the stage (its
    // lse and delta were read before them)
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    hop::acc_fence(dka[c]);
    hop::acc_fence(dva[c]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    const int64_t o = (((int64_t)bi * sk + krow[r]) * H + hi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = c * 64 + 8 * n + 2 * t;
        flash::store2(dk + o + col, dka[c][n][2 * r], dka[c][n][2 * r + 1]);
        flash::store2(dv + o + col, dva[c][n][2 * r], dva[c][n][2 * r + 1]);
      }
  }
}

// ---- host side ----

// the maps of q, k, v and dO (st: their (batch, seq, head) strides in
// order), q and dO in boxes of qrows rows, k and v of krows
template <int D>
bool maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
          const void* o, int b, int h, int sq, int sk, const int64_t* st,
          uint32_t qrows, uint32_t krows) {
  return map_bshd<D>(&m[0], q, b, sq, h, st[0], st[1], st[2], qrows)
         && map_bshd<D>(&m[1], k, b, sk, h, st[3], st[4], st[5], krows)
         && map_bshd<D>(&m[2], v, b, sk, h, st[6], st[7], st[8], krows)
         && map_bshd<D>(&m[3], o, b, sq, h, st[9], st[10], st[11], qrows);
}

template <int D>
int dq_launch(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* delta, void* dq, int b, int h,
              int sq, int sk, const int64_t* st, float scale, int causal,
              const Mode& md, cudaStream_t stream) {
  constexpr int NC = D / 64;
  const int tiles_y = (sq + kRows - 1) / kRows;
  CUtensorMap m[4];
  if (tiles_y > 65535 || !maps<D>(m, q, k, v, o, b, h, sq, sk, st, kRows, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * NC * 2 * kAtom + kStages * 2 * NC * kAtom + 1024;
  auto kern = md.bias ? (md.seed ? dq_wgmma_kernel<D, true, true>
                                 : dq_wgmma_kernel<D, true, false>)
                      : (md.seed ? dq_wgmma_kernel<D, false, true>
                                 : dq_wgmma_kernel<D, false, false>);
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(b * h, tiles_y), kThreads, smem, stream>>>(
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), h, sq, sk, scale, causal, md, m[0], m[1], m[2],
      m[3]);
  return (int)cudaGetLastError();
}

template <int D>
int dkv_launch(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* delta, void* dk, void* dv, int b,
               int h, int sq, int sk, const int64_t* st, float scale,
               int causal, const Mode& md, cudaStream_t stream) {
  constexpr int NC = D / 64;
  const int tiles_y = (sk + kRows - 1) / kRows;
  CUtensorMap m[4];
  if (tiles_y > 65535 || !maps<D>(m, q, k, v, o, b, h, sq, sk, st, 64, kRows))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      2 * NC * 2 * kAtom + kStages * (2 * NC * kAtom + 1024) + 1024;
  auto kern = md.bias ? (md.seed ? dkv_wgmma_kernel<D, true, true>
                                 : dkv_wgmma_kernel<D, true, false>)
                      : (md.seed ? dkv_wgmma_kernel<D, false, true>
                                 : dkv_wgmma_kernel<D, false, false>);
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(b * h, tiles_y), kThreads, smem, stream>>>(
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, sq, sk, scale,
      causal, md, m[0], m[1], m[2], m[3]);
  return (int)cudaGetLastError();
}

}  // namespace flash_wg
