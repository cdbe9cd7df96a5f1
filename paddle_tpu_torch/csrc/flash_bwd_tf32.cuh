// The fp32 flash backward on Hopper (sm_90a) at head_dim 64: dQ and dK/dV
// on TF32 wgmma with the 3xTF32 split, every tile fed by TMA through an
// mbarrier ring.
//
// Replaces, for fp32 inputs at d 64 without segment ids (causal or not,
// with or without an additive bias and in-kernel dropout: the modes that
// GPT-2, entry()'s Llama, the fp32 Qwen2-MoE and BERT at its defaults
// train with), the two pallas_calls of
// paddle_tpu/ops/pallas/flash_attention.py::flash_block_grads: the dQ pass
// (_bwd_dq_kernel, :329-389, called at :558) and the dK/dV pass
// (_bwd_dkv_kernel, :392-463, called at :590). flash_attention_bwd.cu's
// launchers route these modes here; fp32 at d 128 and the segment mode
// keep the mma.sync kernels there. With P recomputed from lse:
//   dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q, dV = P^T dO;
// with dropout, dP and dV's P take keep ? x / (1 - p) : 0 and dS takes the
// undropped P (flash_attention_bwd.cu's dropout mode).
//
// Bound on the H100: operations. Each product is three TF32 passes (dP
// four) at 494.7 TFLOP/s: at GPT-2 small's shape ([8, 1024, 12, 64]
// causal) dQ 19.3 GFLOP of fp32 work (0.117 ms at 3xTF32's 164.9 TFLOP/s),
// dK/dV 25.8 (0.156 ms), against ~0.13 GB of inputs and outputs.
//
// 3xTF32 on wgmma. x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest (flash_common.cuh split_tf32), and a product
// sums lo*hi + hi*lo + hi*hi (dP also lo*lo: a row that sees one key takes
// its dq and its key's dk from dP's rounding alone, ROADMAP C6). The
// tensor cores align a sum to its largest term and truncate, so the long
// chains, dQ over keys and dK, dV over queries, take each tile's passes in
// a fresh accumulator that the CUDA cores add to the running one. S and
// dP are one tile deep (d 64: 8 k-steps); S takes one accumulator, and
// dP's hi*hi k-steps each start from zero (in batches: 2 of 4 in dQ, 4 of
// 2 in dK/dV, whose dK and dV take 64 registers; products_s_dp,
// products_dp_rest) and are added on the CUDA cores, as the mma.sync
// kernels add each k-step's.
// TF32 wgmma has no transpose bit (hopper.cuh): both operands K-major. The
// products over d (S = Q K^T, dP = dO V^T) read the tiles as TMA lands
// them; the products over the sequence (dQ += dS K, dV += P^T dO, dK +=
// dS^T Q) need K, dO and Q with the sequence index contiguous, and take
// dS, P^T, dS^T from registers (the RS form, its keys renamed as
// hopper.cuh says). So each landed ring tile is swept once by the
// producer warpgroup's 128 threads (split_tile): hi in place, lo beside
// it, and for K, Q and dO the transposed hi and lo, their columns in the
// renamed k order; then fence.proxy.async, and the stage is handed to the
// consumers. The resident tiles (Q and dO, or K and V) are split the same
// way once.
//
// Design. A block is three warpgroups: two consumers and the producer (one
// thread issues every TMA load; all 128 split). setmaxnreg gives the
// producer 40 registers a thread and the consumers 232. Ring tiles are 32
// rows (keys in dQ, queries in dK/dV): the split quadruples an operand's
// shared memory, and at 64 rows a stage would not fit beside the resident
// tiles.
//   dQ: a block per (128-row q tile, batch*head), heaviest causal tile
//       first; each consumer owns 64 rows. Resident: Q and dO, hi and lo
//       (128 KB). Ring: 2 stages of 48 KB: K hi/lo, V hi/lo, K^T hi/lo (64
//       rows of d, 32 keys). 224 KB in all. Per k tile each consumer runs
//       S = Q K^T and dP = dO V^T (m64n32k8, both operands in shared
//       memory), makes P and dS in registers, and dQ += dS K (m64n64k8,
//       dS from registers, K^T from shared memory).
//   dK/dV: a block per (64-key tile, batch*head), first keys first.
//       Resident: K and V, hi and lo (64 KB). Both consumers own the 64
//       keys and take the q tiles in turn (consumer c the tiles j = c mod
//       2), each in its own stage of 65 KB: Q hi/lo, dO hi/lo, Q^T and
//       dO^T hi/lo, and the rows' lse (base 2) and delta, which the
//       producer's first warp reads. 194 KB in all; 128 keys would leave
//       room for one stage. In the transposed frame: S^T = K Q^T, dP^T = V
//       dO^T (m64n32k8), then dV += P^T dO and dK += dS^T Q (m64n64k8, P^T
//       and dS^T from registers). At the end consumer 1 hands its dK and
//       dV through shared memory to consumer 0, which adds them to its own
//       in that fixed order and stores.
// Masking as flash_bwd_wgmma.cuh: an element is tested only on the tiles
// that cross the diagonal or the ragged end (P = 0 where a query cannot
// see a key, or past sq or sk); rows past the end read TMA's zeros and are
// not stored. A query that sees no key gets dq = 0, a key that no query
// sees dk = dv = 0. A stage, and the split and transposed copies made in
// it, goes back to the producer only after the wgmma.wait_group that
// covers every group that read it (the release rule: each release names
// its wait). No atomics: each output row belongs to one block and every
// sum runs in one fixed order, so results repeat bitwise.
// Dropout (DROP): a template flag, never a run-time branch. Each consumer
// draws its tile's keep bits (philox.cuh keep_bits_qk / keep_bits_kq, 4
// chunks of 8 columns): dQ's under its S and dP products, dK/dV's just
// before its own (under the other consumer's); dQ's are the bits the TF32
// forward (flash_fwd_tf32.cuh) draws, in the same frame and at the same
// point, and dK/dV's the same bits in the transposed frame. dK/dV masks dV's P^T
// fragments by them and applies 1 / (1 - p) to dV once, at the end.
// Bias (HAS_BIAS): a template flag too, acting where _bwd_dq_kernel
// (:373) and _bwd_dkv_kernel (:437) add it. The bias is fp32 with four
// element strides, any of them 0 (BERT's key padding is [b, 1, 1, sk]
// expanded), so TMA cannot load it, and dQ's 224 KB leave no room to stage
// it: each consumer lane reads its 16 elements of a tile with __ldg right
// after the S and dP groups are committed (flash_wg::bias_chunk), so the
// loads' latency hides under the products; dK/dV reads bias[q, key] for
// its (key row, q column) elements. P = exp2(S scale log2e + bias log2e -
// lse log2e), (bias - lse) log2e one fma; a bias of -inf or -1e30, and a
// row that sees no key (lse clamped at -1e25), give P = 0 and no NaN.

#pragma once

#include "flash_tf32_common.cuh"

namespace flash_tf32 {

constexpr int kStages = 2;

// dP's hi*hi k-steps x0..x0 + NB - 1 (of 8: atom x / 4, step x % 4), each
// alone into its accumulator hh[x - x0] (its old values not read), so
// that no truncating sum of large terms spans two k-steps (a row that sees
// one key takes its dq and its key's dk from dP's rounding alone, ROADMAP
// C6)
template <int NB>
__device__ __forceinline__ void pass_hh_fresh(float (&hh)[NB][4][4],
                                              uint32_t a, uint32_t a_atom,
                                              uint32_t b, int x0) {
#pragma unroll
  for (int x = 0; x < NB; ++x) {
    const int c = (x0 + x) >> 2, ks = (x0 + x) & 3;
    hop::wgmma32_tf32<false>(hh[x], hop::desc(a + c * a_atom + ks * 32),
                             hop::desc(b + c * kAtomT + ks * 32));
  }
}

// d += the fresh k-steps of hh (after their wait), in one fixed order
template <int NB>
__device__ __forceinline__ void fold_hh(float (&d)[4][4],
                                        float (&hh)[NB][4][4]) {
#pragma unroll
  for (int h = 0; h < NB; ++h) hop::acc_fence(hh[h]);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = hh[0][n][i];
#pragma unroll
      for (int h = 1; h < NB; ++h) x += hh[h][n][i];
      d[n][i] += x;
    }
}

// S (one accumulator, committed), then dP's small passes and its first NB
// hi*hi k-steps, each fresh (committed)
template <int NB>
__device__ __forceinline__ void products_s_dp(
    float (&sc)[4][4], float (&dp)[4][4], float (&hh)[NB][4][4],
    uint32_t s_a, uint32_t s_b, uint32_t p_a, uint32_t p_b, uint32_t a_atom,
    uint32_t lo_a, uint32_t lo_b) {
  hop::wg_fence();
  passes_small<false>(sc, s_a, s_a + lo_a, a_atom, s_b, s_b + lo_b);
  pass_hh(sc, s_a, a_atom, s_b, 0);
  pass_hh(sc, s_a, a_atom, s_b, 1);
  hop::wg_commit();                              // S
  passes_small<true>(dp, p_a, p_a + lo_a, a_atom, p_b, p_b + lo_b);
  pass_hh_fresh(hh, p_a, a_atom, p_b, 0);
  hop::wg_commit();                              // dP, first batch
}

// dP's other hi*hi batches (after the first's wait), each fresh, folded
// into dp in order; returns after the last batch's wait
template <int NB>
__device__ __forceinline__ void products_dp_rest(float (&dp)[4][4],
                                                 float (&hh)[NB][4][4],
                                                 uint32_t p_a, uint32_t p_b,
                                                 uint32_t a_atom) {
  hop::acc_fence(dp);
#pragma unroll
  for (int x0 = NB; x0 < 8; x0 += NB) {
    fold_hh(dp, hh);
    hop::wg_fence();
    pass_hh_fresh(hh, p_a, a_atom, p_b, x0);
    hop::wg_commit();
    hop::wg_wait<0>();
  }
  fold_hh(dp, hh);
}

// ---- dQ: block (batch*head, q tile); q rows q0.., 64 wg.. a consumer ----
template <bool HAS_BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
dq_tf32_kernel(const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq,
               int H, int sq, int sk, float scale, int causal, const Mode md,
               const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o) {
  constexpr uint32_t kQ = 128 * 256;         // Q or dO: 128 rows, 2 atoms
  constexpr uint32_t kAtomQ = 128 * 128;
  // a stage: K hi, K lo, V hi, V lo, K^T hi, K^T lo
  constexpr uint32_t kStage = 4 * kTile + 2 * kTrans;
  __shared__ uint64_t qland, qready, land[kStages], full[kStages],
      empty[kStages];
  const uint32_t base = hop::smem_u32(flash_wg::tiles());
  // Q hi, Q lo, dO hi, dO lo, then the ring
  const uint32_t sQ = base, sO = base + 2 * kQ, ring = base + 4 * kQ;

  const int bh = blockIdx.x, bi = bh / H, hi = bh % H;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * 128;
  const int off = sk - sq;
  const int kend = causal ? min(sk, q0 + 128 + off) : sk;
  const int n_kt = kend > 0 ? (kend + kT - 1) / kT : 0;   // k tiles to visit
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&qland), 1);
    hop::mbar_init(hop::smem_u32(&qready), kSplitThreads);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(hop::smem_u32(&land[s]), 1);
      hop::mbar_init(hop::smem_u32(&full[s]), kSplitThreads);
      hop::mbar_init(hop::smem_u32(&empty[s]), 8);   // the consumer warps
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {                                     // the producer
    hop::reg_dealloc<40>();
    if (n_kt == 0) return;
    const int p = tid - 256, pw = p >> 5;
    const int kcol = renamed(lane);   // K^T's column of its key
    if (p == 0) {
      const uint32_t qb = hop::smem_u32(&qland);
      hop::mbar_arrive_tx(qb, 2 * kQ);
      for (int c = 0; c < 2; ++c) {
        hop::tma_load4(sQ + c * kAtomQ, &tm_q, qb, c * 32, q0, hi, bi);
        hop::tma_load4(sO + c * kAtomQ, &tm_o, qb, c * 32, q0, hi, bi);
      }
    }
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kStages, ph = (j / kStages) & 1;
      const uint32_t st = ring + s * kStage;
      if (p == 0) {
        const uint32_t lb = hop::smem_u32(&land[s]);
        hop::mbar_wait(hop::smem_u32(&empty[s]), ph ^ 1);
        hop::mbar_arrive_tx(lb, 2 * kTile);
        for (int c = 0; c < 2; ++c) {
          hop::tma_load4(st + c * kAtomT, &tm_k, lb, c * 32, j * kT, hi, bi);
          hop::tma_load4(st + 2 * kTile + c * kAtomT, &tm_v, lb, c * 32,
                         j * kT, hi, bi);
        }
      }
      if (j == 0) {               // Q and dO, while the first K, V land
        hop::mbar_wait(hop::smem_u32(&qland), 0);
        split_plain(sQ, sQ + kQ, kQ, p);
        split_plain(sO, sO + kQ, kQ, p);
        hop::proxy_fence();         // each splitter, before its arrival
        hop::mbar_arrive(hop::smem_u32(&qready));
      }
      hop::mbar_wait(hop::smem_u32(&land[s]), ph);
      split_tile<true>(st, st + kTile, st + 4 * kTile,
                       st + 4 * kTile + kTrans, pw, lane, kcol);   // K
      split_tile<false>(st + 2 * kTile, st + 3 * kTile, 0, 0, pw, lane,
                        0);                                        // V
      hop::proxy_fence();           // each splitter, before its arrival
      hop::mbar_arrive(hop::smem_u32(&full[s]));
    }
    return;
  }
  hop::reg_alloc<232>();

  const int warp = (tid >> 5) & 3, t = lane & 3;
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
  const uint32_t aQ = sQ + wg * 64 * 128, aO = sO + wg * 64 * 128;
  float acc[8][4];
  zero(acc);
  if (n_kt > 0) hop::mbar_wait(hop::smem_u32(&qready), 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages, k0 = j * kT;
    const uint32_t st = ring + s * kStage;
    hop::mbar_wait(hop::smem_u32(&full[s]), (j / kStages) & 1);
    // a vote, so that ptxas sees the products' branch uniform
    if (__any_sync(0xffffffffu, k0 < wkend)) {
      float sc[4][4], dp[4][4], dph[4][4][4];   // S, dP (2 batches of 4)
      // S = Q K^T, dP = dO V^T (its first half)
      products_s_dp(sc, dp, dph, aQ, st, aO, st + 2 * kTile, kAtomQ, kQ,
                    kTile);
      // under the products: the tile's bias loads and keep bits
      float bb[4][4];
      if constexpr (HAS_BIAS) {
        const float* bp[2] = {brow[0] + (int64_t)k0 * md.b_sk,
                              brow[1] + (int64_t)k0 * md.b_sk};
#pragma unroll
        for (int n = 0; n < 4; ++n)
          flash_wg::bias_chunk(bb[n], bp, md.b_sk, n, k0 + 2 * t, sk);
      }
      uint32_t keep = 0;
      if constexpr (DROP)
        keep = flash::keep_bits_qk<4>(bh, row[0], row[1], k0 + 2 * t, key0,
                                      key1, md.thresh, lane);
      hop::wg_wait<1>();                         // S is done, dP runs on
      hop::acc_fence(sc);
      // the diagonal (causal) or the ragged end crosses this tile
      const bool edge = (causal && k0 + kT - 1 > r0 + off) || k0 + kT > sk;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int col = k0 + 8 * n + 2 * t + (i & 1);
          const bool vis = !edge
                           || flash::visible(row[r], col, sq, sk, off,
                                             causal != 0);
          float lb = -lse2[r];                   // (bias - lse) log2e
          if constexpr (HAS_BIAS) lb = fmaf(bb[n][i], flash::kLog2e, lb);
          sc[n][i] = vis ? exp2f(fmaf(sc[n][i], scale_log2, lb)) : 0.f;
        }
      hop::wg_wait<0>();                       // dP's first batch is done
      products_dp_rest(dp, dph, aO, st + 2 * kTile, kAtomQ);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float dpk = dp[n][i];                  // dP of the dropped P
          if constexpr (DROP) dpk = kept(dpk, keep, 4 * n + i, md.inv_keep);
          sc[n][i] = sc[n][i] * (dpk - dlt[i >> 1]) * scale;   // dS
        }
      uint32_t ahi[4][4], alo[4][4];
      acc_to_a_tf32(ahi, alo, sc);
      float part[8][4];
      hop::wg_fence();
      product_rs(part, ahi, alo, st + 4 * kTile, st + 4 * kTile + kTrans);
      hop::wg_commit();                          // dQ's part = dS K
      hop::wg_wait<0>();
      hop::acc_fence(part);
      add_to(acc, part);
    }
    // release stage s (K, V and their split and transposed copies): after
    // the wg_wait<0> just above, which covers the S, dP and dS K groups,
    // every group that read the stage
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    float* drow = dq + (((int64_t)bi * sq + row[r]) * H + hi) * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      flash::store2(drow + 8 * n + 2 * t, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ---- dK/dV: block (batch*head, key tile); keys k0..k0 + 63, in the
// transposed frame (key rows x q columns); consumer c takes the q tiles
// j = c mod 2 ----
template <bool HAS_BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
dkv_tf32_kernel(const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int sq, int sk, float scale,
                int causal, const Mode md,
                const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o) {
  constexpr uint32_t kKV = 64 * 256;         // K or V: 64 keys, 2 atoms
  constexpr uint32_t kAtomK = 64 * 128;
  // a stage: Q hi, Q lo, dO hi, dO lo, Q^T hi, Q^T lo, dO^T hi, dO^T lo,
  // then the rows' lse (base 2) and delta, padded to 1024 bytes
  constexpr uint32_t kStat = 4 * kTile + 4 * kTrans;
  constexpr uint32_t kStage = kStat + 1024;
  __shared__ uint64_t kvland, kvready, land[kStages], full[kStages],
      empty[kStages];
  unsigned char* smem = flash_wg::tiles();
  const uint32_t base = hop::smem_u32(smem);
  // K hi, K lo, V hi, V lo, then the ring
  const uint32_t sK = base, sV = base + 2 * kKV, ring = base + 4 * kKV;

  const int bh = blockIdx.x, bi = bh / H, hi = bh % H;
  const int k0 = blockIdx.y * 64;      // early keys see the most rows: first
  const int off = sk - sq;
  // causal: query row r sees key k0 when r >= k0 - off
  const int i0 = (causal ? max(0, k0 - off) : 0) / kT;
  const int n_qt = max(0, (sq + kT - 1) / kT - i0);  // q tiles to visit
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&kvland), 1);
    hop::mbar_init(hop::smem_u32(&kvready), kSplitThreads);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(hop::smem_u32(&land[s]), 1);
      hop::mbar_init(hop::smem_u32(&full[s]), kSplitThreads);
      hop::mbar_init(hop::smem_u32(&empty[s]), 4);   // its consumer's warps
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {                                     // the producer
    hop::reg_dealloc<40>();
    if (n_qt == 0) return;
    const int p = tid - 256, pw = p >> 5;
    const int qcol = renamed(lane);   // Q^T's, dO^T's column of its query
    if (p == 0) {
      const uint32_t kb = hop::smem_u32(&kvland);
      hop::mbar_arrive_tx(kb, 2 * kKV);
      for (int c = 0; c < 2; ++c) {
        hop::tma_load4(sK + c * kAtomK, &tm_k, kb, c * 32, k0, hi, bi);
        hop::tma_load4(sV + c * kAtomK, &tm_v, kb, c * 32, k0, hi, bi);
      }
    }
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % kStages, ph = (j / kStages) & 1;
      const int qs0 = (i0 + j) * kT;
      const uint32_t st = ring + s * kStage;
      if (p == 0) {
        const uint32_t lb = hop::smem_u32(&land[s]);
        hop::mbar_wait(hop::smem_u32(&empty[s]), ph ^ 1);
        hop::mbar_arrive_tx(lb, 2 * kTile);
        for (int c = 0; c < 2; ++c) {
          hop::tma_load4(st + c * kAtomT, &tm_q, lb, c * 32, qs0, hi, bi);
          hop::tma_load4(st + 2 * kTile + c * kAtomT, &tm_o, lb, c * 32,
                         qs0, hi, bi);
        }
      }
      if (j == 0) {               // K and V, while the first Q, dO land
        hop::mbar_wait(hop::smem_u32(&kvland), 0);
        split_plain(sK, sK + kKV, kKV, p);
        split_plain(sV, sV + kKV, kKV, p);
        hop::proxy_fence();         // each splitter, before its arrival
        hop::mbar_arrive(hop::smem_u32(&kvready));
      }
      float l2 = 0.f, dl = 0.f;                      // warp 0: row lane
      if (pw == 0) {
        const int q = qs0 + lane;
        if (q < sq) {
          l2 = fmaxf(lse[(int64_t)bh * sq + q], flash::kClamp)
               * flash::kLog2e;
          dl = delta[(int64_t)bh * sq + q];
        }
      }
      // the stage is free once it has landed (land follows empty)
      hop::mbar_wait(hop::smem_u32(&land[s]), ph);
      if (pw == 0) {
        sts(st + kStat + 4 * lane, l2);
        sts(st + kStat + 128 + 4 * lane, dl);
      }
      split_tile<true>(st, st + kTile, st + 4 * kTile,
                       st + 4 * kTile + kTrans, pw, lane, qcol);   // Q
      split_tile<true>(st + 2 * kTile, st + 3 * kTile,
                       st + 4 * kTile + 2 * kTrans,
                       st + 4 * kTile + 3 * kTrans, pw, lane, qcol);   // dO
      hop::proxy_fence();           // each splitter, before its arrival
      hop::mbar_arrive(hop::smem_u32(&full[s]));
    }
    return;
  }
  hop::reg_alloc<232>();

  const int warp = (tid >> 5) & 3, t = lane & 3;
  const int krow[2] = {k0 + 16 * warp + (lane >> 2),
                       k0 + 16 * warp + (lane >> 2) + 8};
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
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  if (n_qt > 0) hop::mbar_wait(hop::smem_u32(&kvready), 0);

  const int s = wg;                                  // this consumer's stage
  const uint32_t st = ring + s * kStage;
  const float* stat = reinterpret_cast<const float*>(smem + (st - base)
                                                     + kStat);
  for (int j = wg; j < n_qt; j += 2) {
    const int qs0 = (i0 + j) * kT;
    hop::mbar_wait(hop::smem_u32(&full[s]), (j / kStages) & 1);
    // every visited tile holds a row that sees key k0 (i0 above). The
    // keep bits first, under the other consumer's products
    uint32_t keep = 0;
    if constexpr (DROP)
      keep = flash::keep_bits_kq<4>(bh, krow[0], krow[1], qs0 + 2 * t, key0,
                                    key1, md.thresh, lane);
    // S^T, dP^T (4 batches of 2: dK and dV hold 64 registers)
    float sc[4][4], dp[4][4], dph[2][4][4];
    // S^T = K Q^T, dP^T = V dO^T (its first half)
    products_s_dp(sc, dp, dph, sK, st, sV, st + 2 * kTile, kAtomK, kKV,
                  kTile);
    // under the products: the tile's bias^T loads, all 16 before the wait
    // (one chunk ahead of the chunk being made was 4% slower: PERF.md §6)
    float bt[4][4];
    if constexpr (HAS_BIAS) {
      const float* bq[2] = {bkey[0] + (int64_t)qs0 * md.b_sq,
                            bkey[1] + (int64_t)qs0 * md.b_sq};
#pragma unroll
      for (int n = 0; n < 4; ++n)
        flash_wg::bias_chunk(bt[n], bq, md.b_sq, n, qs0 + 2 * t, sq);
    }
    hop::wg_wait<1>();                           // S^T is done, dP^T runs on
    hop::acc_fence(sc);
    const bool edge = (causal && qs0 < k0 + 63 - off) || k0 + 64 > sk
                      || qs0 + kT > sq;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c2 = 8 * n + 2 * t;              // q rows c2, c2 + 1
      const float2 l2 = *reinterpret_cast<const float2*>(stat + c2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool odd = i & 1;
        const bool vis = !edge
                         || flash::visible(qs0 + c2 + odd, krow[i >> 1], sq,
                                           sk, off, causal != 0);
        float lbt = -(odd ? l2.y : l2.x);        // (bias^T - lse) log2e
        if constexpr (HAS_BIAS) lbt = fmaf(bt[n][i], flash::kLog2e, lbt);
        sc[n][i] = vis ? exp2f(fmaf(sc[n][i], scale_log2, lbt)) : 0.f;  // P^T
      }
    }
    // P^T's tf32 split, dV's A operand; its fp32 value is hi + lo from
    // here on (within 2^-24 of P^T), so P^T itself is not kept beside dP^T
    uint32_t ahi[4][4], alo[4][4];
    acc_to_a_tf32(ahi, alo, sc);
    hop::wg_wait<0>();                       // dP^T's first batch is done
    products_dp_rest(dp, dph, sV, st + 2 * kTile, kAtomK);
    // dS^T into dp, from the undropped P^T; then (DROP) P^T masked by the
    // keep bits for dV, whose 1 / (1 - p) is applied once at the end:
    // (keep ? P^T / (1 - p) : 0) dO summed = (sum of (keep ? P^T : 0) dO)
    // / (1 - p). Fragment entry j of chunk n is element [n][kPerm[j]].
    constexpr int kPerm[4] = {0, 2, 1, 3};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c2 = 8 * n + 2 * t;
      const float2 dl = *reinterpret_cast<const float2*>(stat + 32 + c2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = kPerm[i];
        const float pt = __uint_as_float(ahi[n][j])
                         + __uint_as_float(alo[n][j]);
        float dpt = dp[n][i];                    // dP^T of the dropped P^T
        if constexpr (DROP) dpt = kept(dpt, keep, 4 * n + i, md.inv_keep);
        dp[n][i] = pt * (dpt - ((i & 1) ? dl.y : dl.x)) * scale;   // dS^T
      }
      if constexpr (DROP) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!((keep >> (4 * n + kPerm[j])) & 1u)) ahi[n][j] = alo[n][j] = 0u;
      }
    }
    float part[8][4];
    hop::wg_fence();
    product_rs(part, ahi, alo, st + 4 * kTile + 2 * kTrans,
               st + 4 * kTile + 3 * kTrans);
    hop::wg_commit();                            // dV's part = P^T dO
    hop::wg_wait<0>();
    hop::acc_fence(part);
    add_to(dva, part);
    acc_to_a_tf32(ahi, alo, dp);
    hop::wg_fence();
    product_rs(part, ahi, alo, st + 4 * kTile, st + 4 * kTile + kTrans);
    hop::wg_commit();                            // dK's part = dS^T Q
    hop::wg_wait<0>();
    hop::acc_fence(part);
    add_to(dka, part);
    // release the stage (Q, dO, their split and transposed copies, lse
    // and delta): after the wg_wait<0> just above, which covers the S^T,
    // dP^T, dV and dK groups, every group that read it
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[s]));
  }

  // consumer 1's dK and dV to consumer 0 through its own stage (the
  // producer writes it no more: every tile of consumer 1 has been taken),
  // each thread's registers in place, then one fixed-order add
  float* red = reinterpret_cast<float*>(smem + (ring - base) + kStage);
  const int ti = tid & 127;
  if (wg == 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        red[(4 * n + i) * 128 + ti] = dka[n][i];
        red[(32 + 4 * n + i) * 128 + ti] = dva[n][i];
      }
  }
  hop::bar_sync(2, 256);
  if (wg == 1) return;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dka[n][i] += red[(4 * n + i) * 128 + ti];
      dva[n][i] += red[(32 + 4 * n + i) * 128 + ti];
      if constexpr (DROP) dva[n][i] *= md.inv_keep;   // dV's 1 / (1 - p)
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= sk) continue;
    const int64_t o = (((int64_t)bi * sk + krow[r]) * H + hi) * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      flash::store2(dk + o + col, dka[n][2 * r], dka[n][2 * r + 1]);
      flash::store2(dv + o + col, dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---- host side ----

// the maps of q, k, v and dO (st: their (batch, seq, head) strides in
// order) as fp32 [b, s, h, 64], q and dO in boxes of qrows rows, k and v
// of krows
inline bool maps(CUtensorMap (&m)[4], const void* q, const void* k,
                 const void* v, const void* o, int b, int h, int sq, int sk,
                 const int64_t* st, uint32_t qrows, uint32_t krows) {
  const void* const ptr[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int s = (i == 1 || i == 2) ? sk : sq;
    const uint64_t n[4] = {64, (uint64_t)s, (uint64_t)h, (uint64_t)b};
    const int64_t str[3] = {st[3 * i + 1], st[3 * i + 2], st[3 * i]};
    if (!hop::f32_map4(&m[i], ptr[i], n, str,
                       (i == 1 || i == 2) ? krows : qrows))
      return false;
  }
  return true;
}

inline int dq_launch(const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* delta,
                     void* dq, int b, int h, int sq, int sk,
                     const int64_t* st, float scale, int causal,
                     const Mode& md, cudaStream_t stream) {
  const int tiles_y = (sq + 127) / 128;
  CUtensorMap m[4];
  if (tiles_y > 65535 || !maps(m, q, k, v, o, b, h, sq, sk, st, 128, kT))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * 128 * 256 + kStages * (4 * kTile + 2 * kTrans)
                      + 1024;
  auto kern = md.bias ? (md.seed ? dq_tf32_kernel<true, true>
                                 : dq_tf32_kernel<true, false>)
                      : (md.seed ? dq_tf32_kernel<false, true>
                                 : dq_tf32_kernel<false, false>);
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(b * h, tiles_y), kThreads, smem, stream>>>(
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, sq, sk, scale, causal, md, m[0], m[1], m[2],
      m[3]);
  return (int)cudaGetLastError();
}

inline int dkv_launch(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* delta,
                      void* dk, void* dv, int b, int h, int sq, int sk,
                      const int64_t* st, float scale, int causal,
                      const Mode& md, cudaStream_t stream) {
  const int tiles_y = (sk + 63) / 64;
  CUtensorMap m[4];
  if (tiles_y > 65535 || !maps(m, q, k, v, o, b, h, sq, sk, st, kT, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      4 * 64 * 256 + kStages * (4 * kTile + 4 * kTrans + 1024) + 1024;
  auto kern = md.bias ? (md.seed ? dkv_tf32_kernel<true, true>
                                 : dkv_tf32_kernel<true, false>)
                      : (md.seed ? dkv_tf32_kernel<false, true>
                                 : dkv_tf32_kernel<false, false>);
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(b * h, tiles_y), kThreads, smem, stream>>>(
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, sq, sk, scale,
      causal, md, m[0], m[1], m[2], m[3]);
  return (int)cudaGetLastError();
}

}  // namespace flash_tf32
