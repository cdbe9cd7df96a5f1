// The fp32 flash forward on Hopper (sm_90a) at head_dim 64: out =
// softmax(Q K^T scale + bias, masked) V and lse on TF32 wgmma with the
// 3xTF32 split, K and V fed by TMA through an mbarrier ring.
//
// Replaces, for fp32 inputs at d 64 without segment ids (causal or not,
// with or without an additive bias and in-kernel dropout: the modes that
// GPT-2, entry()'s Llama, the fp32 Qwen2-MoE and BERT at its defaults
// train with), paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (:96)
// and _fwd (:174, its pallas_call at :242). flash_attention_fwd.cu's
// launcher routes these modes here; fp32 at d 128 and the segment mode
// keep the mma.sync kernel there.
//
// Bound on the H100: operations. At GPT-2 small's shape ([8, 1024, 12,
// 64] causal) the two products are 12.9 GFLOP of fp32 work, 78 us at
// 3xTF32's 494.7 / 3 TFLOP/s, against ~0.1 GB of q, k, v, out and lse
// (~30 us at 3.35 TB/s).
//
// Design: flash_bwd_tf32.cuh's dQ block with fwd_wgmma_kernel's loop
// (flash_fwd_wgmma.cuh). A block is three warpgroups and owns a 128-row q
// tile of one (batch, head): warpgroups 0 and 1 consume, 64 rows each; the
// producer warpgroup issues the TMA loads from one thread and splits each
// landed tile with all 128 (setmaxnreg: 40 registers a producer thread,
// 232 a consumer's). Blocks run in groups of heads whose K and V fit in a
// third of the L2, each group's q tiles heaviest first, as the bf16
// forward's. Shared memory: Q's hi and lo (64 KB), split once, resident;
// then kFwdStages ring stages of 40 KB, each a 32-key tile: K split in
// place to hi with lo beside it, V as it landed, and V^T's hi and lo (64
// rows of d, 32 keys in the renamed k order of the RS A fragment: TF32
// wgmma has no transpose bit, hopper.cuh). Per k tile j a consumer runs
//   S = Q K^T            (m64n32k8, both operands in shared memory; lo*hi,
//                         hi*lo, hi*hi into one accumulator, one tile deep)
//   m' = max(m, rowmax S), alpha = 2^(m - m'), P = 2^(S scale log2e - m')
//   l = l alpha + rowsum P, part = P V, O = O alpha + part
// with P split into its tf32 hi and lo as the A operand from registers
// (acc_to_a_tf32) and part an m64n64k8 RS product (lo*hi, hi*lo, hi*hi)
// into a fresh accumulator: O is never a sum on the tensor cores, which
// align a sum to its largest term and truncate, so that a long causal row
// (long_chain_check: 8192 keys, 256 tiles) does not drift. The products
// overlap the softmax: S of tile j and P V of tile j - 1 are issued
// together, tile j's softmax (and, under S, its bias loads and keep bits)
// runs while P V runs, and the CUDA cores then add P V of tile j - 1 to O
// with that tile's alpha (one fma). Only the tiles that cross the diagonal
// or the ragged end test each element (P = 0 for a key a query cannot see
// or past sk; causal aligns bottom-right, off = sk - sq); a consumer does
// not visit the block's last tiles that hold none of its keys (causal:
// warpgroup 0 skips up to two), a count voted so that the loop stays
// warp-uniform. Rows past sq read TMA's zeros and are not stored. Masked
// scores take -1e30 and the subtracted max is clamped at -1e25, so a row
// that sees no key gets out = 0 and lse = -1e30, as _fwd_kernel
// (:209-216). A stage goes back to the producer only after the
// wgmma.wait_group that covers every group that read it (the release rule:
// each release below names its wait). No atomics; every sum runs in one
// fixed order, so results repeat bitwise.
// Ring depth: a stage is 40 KB, so 3 or 4 fit beside Q. On an H100 the two
// took the same time in every fp32 row, within 2% either way
// (tools/flash_ab.py, parent / 4 / 3 / 4 / 3 / parent in one call; PERF.md
// §6): the loop waits on its own product chain, not on loads. So three
// (184 KB in all), which leaves 40 KB free.
//
// Bias (HAS_BIAS, a template flag, never a run-time branch): fp32 with
// four element strides, any of them 0 (BERT's key padding is [b, 1, 1, sk]
// expanded), so TMA cannot load it. As in dQ (flash_bwd_tf32.cuh), each
// consumer lane reads its 16 elements of a tile with __ldg right after the
// S group is committed (flash_wg::bias_chunk), so the loads' latency hides
// under the products (a TF32 tile takes ~3x a bf16 one). S scale + bias,
// as _fwd_kernel adds the bias after (q * scale) k (:146-148), its row max
// taken in natural units and log2e folded into the exponent's fma; a bias
// of -inf or -1e30 gives P = 0 and no NaN.
//
// Dropout (DROP, a template flag too), as _fwd_kernel (:149-163, _drop_mask
// :50): the running max, l and lse take the undropped P, and P V takes
// keep ? P / (1 - p) : 0 before the split. A tile's keep bits are drawn
// with philox.cuh keep_bits_qk<4> in the m64n32 frame of its S, right after
// the S group is committed, exactly as dq_tf32_kernel draws them, so the
// forward's mask is the TF32 backward's for every (query, key) by
// construction; one Philox block per four elements (the mma.sync kernel
// drew each twice). The key (seed, offset) is read from a device int64 [2],
// so no draw waits for the host.

#pragma once

#include <algorithm>
#include <climits>

#include "flash_tf32_common.cuh"

namespace flash_tf32 {

using flash_wg::frag_fence;

constexpr int kFwdStages = 3;
constexpr uint32_t kFwdQ = 128 * 256;      // Q hi or lo: 128 rows, 2 atoms
constexpr uint32_t kAtomFwdQ = 128 * 128;
// a stage: K hi, K lo, V as it landed, V^T hi, V^T lo
constexpr uint32_t kFwdStage = 3 * kTile + 2 * kTrans;

// A landed ring tile at p (32 rows x 64 columns: two atoms), its transpose
// alone split into hi at th and lo at tl (split_tile's TRANS part: V is
// read by P V alone, so its own hi and lo are not written)
__device__ __forceinline__ void split_trans(uint32_t p, uint32_t th,
                                            uint32_t tl, int warp, int lane,
                                            int col) {
  const int r = lane;
#pragma unroll 1                 // the producer's 40 registers: no hoisting
  for (int i = 0; i < 4; ++i) {
    const int cc = 4 * warp + i, atom = cc >> 3, c = cc & 7;
    float4 x = lds4(p + atom * kAtomT + hop::swz(r, c));
    const float4 l = split4(x);
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

// o = o alpha + part, row by row (the CUDA cores' add of a tile's P V)
__device__ __forceinline__ void rescale_add(float (&o)[8][4],
                                            const float (&alpha)[2],
                                            const float (&part)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[n][i] = fmaf(o[n][i], alpha[i >> 1], part[n][i]);
}

// ---- forward: block (batch*head, q tile); q rows q0.., 64 wg.. a
// consumer ----
template <bool HAS_BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_tf32_kernel(float* __restrict__ out, float* __restrict__ lse, int H,
                int sq, int sk, float scale, int causal, int group,
                const Mode md, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  constexpr int S = kFwdStages;
  __shared__ uint64_t qland, qready, land[S], full[S], empty[S];
  const uint32_t base = hop::smem_u32(flash_wg::tiles());
  // Q hi, Q lo, then the ring
  const uint32_t sQ = base, ring = base + 2 * kFwdQ;

  // block -> (batch*head, q tile): the heads in groups of `group`, and in
  // a group each q tile of its heads, heaviest (last) first
  const int n_qt = (sq + 127) / 128;
  const int g = blockIdx.x / (group * n_qt);
  const int gi = blockIdx.x - g * group * n_qt;
  const int gs = min(group, (int)gridDim.x / n_qt - g * group);
  const int bh = g * group + gi % gs, bi = bh / H, hi = bh % H;
  const int q0 = (n_qt - 1 - gi / gs) * 128;
  const int off = sk - sq;
  const int kend = causal ? min(sk, q0 + 128 + off) : sk;
  const int n_kt = kend > 0 ? (kend + kT - 1) / kT : 0;   // k tiles to load
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&qland), 1);
    hop::mbar_init(hop::smem_u32(&qready), kSplitThreads);
    for (int s = 0; s < S; ++s) {
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
    const int vcol = renamed(lane);   // V^T's column of its key
    if (p == 0) {
      const uint32_t qb = hop::smem_u32(&qland);
      hop::mbar_arrive_tx(qb, kFwdQ);
      for (int c = 0; c < 2; ++c)
        hop::tma_load4(sQ + c * kAtomFwdQ, &tm_q, qb, c * 32, q0, hi, bi);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % S, ph = (j / S) & 1;
      const uint32_t st = ring + s * kFwdStage;
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
      if (j == 0) {               // Q, while the first K, V land
        hop::mbar_wait(hop::smem_u32(&qland), 0);
        split_plain(sQ, sQ + kFwdQ, kFwdQ, p);
        hop::proxy_fence();         // each splitter, before its arrival
        hop::mbar_arrive(hop::smem_u32(&qready));
      }
      // the stage is free once it has landed (land follows empty)
      hop::mbar_wait(hop::smem_u32(&land[s]), ph);
      split_tile<false>(st, st + kTile, 0, 0, pw, lane, 0);            // K
      split_trans(st + 2 * kTile, st + 3 * kTile, st + 3 * kTile + kTrans,
                  pw, lane, vcol);                                     // V^T
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
  // the keys this consumer's rows can see lie below wkend; it does not
  // visit the block's last tiles that hold none of them (at most two: a
  // vote, so that ptxas sees the loop's bound uniform)
  const int wkend = causal ? min(sk, r0 + 64 + off) : sk;
  int n_mine = n_kt;
  while (n_mine > 0 && __any_sync(0xffffffffu, (n_mine - 1) * kT >= wkend))
    --n_mine;
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
  const uint32_t aQ = sQ + wg * 64 * 128;

  float o[8][4];
  zero(o);
  float m_r[2] = {flash::kNeg, flash::kNeg};   // running max, base 2
  float l_r[2] = {0.f, 0.f};                   // this lane's row sums
  float sc[4][4], bb[4][4];                    // S (then P), its bias
  uint32_t keep = 0;                           // DROP: the keep bits of S's
                                               // tile (bit 4 n + i: [n][i])

  // S = Q K^T of the tile in stage st, one accumulator (not committed)
  auto s_product = [&](uint32_t st) {
    passes_small<false>(sc, aQ, aQ + kFwdQ, kAtomFwdQ, st, st + kTile);
    pass_hh(sc, aQ, kAtomFwdQ, st, 0);
    pass_hh(sc, aQ, kAtomFwdQ, st, 1);
  };
  // under S's products: tile k0's bias loads and keep bits
  auto under = [&](int k0) {
    if constexpr (HAS_BIAS) {
      const float* bp[2] = {brow[0] + (int64_t)k0 * md.b_sk,
                            brow[1] + (int64_t)k0 * md.b_sk};
#pragma unroll
      for (int n = 0; n < 4; ++n)
        flash_wg::bias_chunk(bb[n], bp, md.b_sk, n, k0 + 2 * t, sk);
    }
    if constexpr (DROP)
      keep = flash::keep_bits_qk<4>(bh, row[0], row[1], k0 + 2 * t, key0,
                                    key1, md.thresh, lane);
  };
  // tile k0's scores in sc -> P (fp32, undropped), the running max and
  // sums updated; alpha: the factor of the O so far
  auto softmax = [&](int k0, float (&alpha)[2]) {
    // the diagonal (causal) or the ragged end crosses this tile
    const bool edge = (causal && k0 + kT - 1 > r0 + off) || k0 + kT > sk;
    // HAS_BIAS: S scale + bias, kept in natural units (its max times
    // log2e is the max in base 2, so log2e goes into the exponent's fma);
    // else S scale log2e
    float unit = 1.f;
    if constexpr (HAS_BIAS) {
      unit = flash::kLog2e;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = fmaf(sc[n][i], scale, bb[n][i]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] *= scale_log2;
    }
    if (edge) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!flash::visible(row[i >> 1], k0 + 8 * n + 2 * t + (i & 1), sq,
                              sk, off, causal != 0))
            sc[n][i] = flash::kNeg;
    }
    float mx[2] = {HAS_BIAS ? flash::kNeg : m_r[0],
                   HAS_BIAS ? flash::kNeg : m_r[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
    float msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = flash::quad_max(mx[r]);
      if constexpr (HAS_BIAS) mx[r] = fmaxf(m_r[r], mx[r] * unit);
      alpha[r] = exp2f(m_r[r] - mx[r]);
      msub[r] = fmaxf(mx[r], flash::kClamp);
      m_r[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(sc[n][i], unit, -msub[i >> 1]));
        sc[n][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
  };

  if (n_mine > 0) {
    uint32_t ahi[4][4], alo[4][4];             // P of the tile before, split
    float part[8][4], alpha[2];
    // P (in sc) as P V's A operand; DROP: keep ? P / (1 - p) : 0
    auto p_to_a = [&]() {
      if constexpr (DROP) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sc[n][i] = kept(sc[n][i], keep, 4 * n + i, md.inv_keep);
      }
      acc_to_a_tf32(ahi, alo, sc);
    };
    hop::mbar_wait(hop::smem_u32(&qready), 0);
    hop::mbar_wait(hop::smem_u32(&full[0]), 0);
    hop::wg_fence();
    s_product(ring);                          // S, tile 0
    hop::wg_commit();
    under(0);                                 // S in flight
    hop::wg_wait<0>();
    hop::acc_fence(sc);
    softmax(0, alpha);                        // O is 0: nothing to rescale
    p_to_a();
    for (int j = 1; j < n_mine; ++j) {
      const int s = j % S, sp = (j - 1) % S, k0 = j * kT;
      const uint32_t st = ring + s * kFwdStage, stp = ring + sp * kFwdStage;
      hop::mbar_wait(hop::smem_u32(&full[s]), (j / S) & 1);
      hop::wg_fence();
      s_product(st);                          // S, tile j
      hop::wg_commit();
      product_rs(part, ahi, alo, stp + 3 * kTile,
                 stp + 3 * kTile + kTrans);   // part = P V, tile j - 1
      hop::wg_commit();
      under(k0);                              // S and P V in flight
      const float a_prev[2] = {alpha[0], alpha[1]};   // tile j - 1's
      hop::wg_wait<1>();                      // S is done, P V runs on
      hop::acc_fence(sc);
      softmax(k0, alpha);
      hop::wg_wait<0>();                      // P V of tile j - 1 is done
      hop::acc_fence(part);
      frag_fence(ahi);
      frag_fence(alo);
      // release stage sp (tile j - 1): after the wg_wait<0> just above,
      // which covers its P V, the last group that read it (its S was
      // waited for in the iteration before)
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sp]));
      rescale_add(o, a_prev, part);
      p_to_a();
    }
    const int sl = (n_mine - 1) % S;
    const uint32_t stl = ring + sl * kFwdStage;
    hop::wg_fence();
    product_rs(part, ahi, alo, stl + 3 * kTile, stl + 3 * kTile + kTrans);
    hop::wg_commit();                         // part = P V, the last tile
    hop::wg_wait<0>();
    hop::acc_fence(part);
    frag_fence(ahi);
    frag_fence(alo);
    // release stage sl (the last tile): after the wg_wait<0> just above,
    // which covers its P V, the last group that read it
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sl]));
    rescale_add(o, alpha, part);
  }
  // the block's tiles that this consumer does not visit still pass
  // through its hands, in ring order
  for (int j = n_mine; j < n_kt; ++j) {
    hop::mbar_wait(hop::smem_u32(&full[j % S]), (j / S) & 1);
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[j % S]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = flash::quad_sum(l_r[r]);
    const float l_safe = l == 0.f ? 1.f : l;
    if (row[r] >= sq) continue;
    float* orow = out + (((int64_t)bi * sq + row[r]) * H + hi) * 64;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      flash::store2(orow + 8 * n + 2 * t, o[n][2 * r] / l_safe,
                    o[n][2 * r + 1] / l_safe);
    if (t == 0)
      lse[(int64_t)bh * sq + row[r]] =
          l == 0.f ? flash::kNeg : (m_r[r] + log2f(l)) * flash::kLn2;
  }
}

// ---- host side ----

// q, k, v [b, s, h, 64] fp32 through their (batch, seq, head) strides
// st[0..8]; out contiguous [b, sq, h, 64], lse fp32 [b, h, sq]. md: the
// bias (null: none) and its strides, the dropout key (null: none) and its
// threshold and 1 / (1 - p). A map that cannot be built (a stride or base
// TMA refuses) returns cudaErrorInvalidValue.
inline int fwd_launch(const void* q, const void* k, const void* v, void* out,
                      void* lse, int b, int h, int sq, int sk,
                      const int64_t* st, float scale, int causal,
                      const Mode& md, cudaStream_t stream) {
  const int64_t n_qt = (sq + 127) / 128, bh = (int64_t)b * h;
  const int64_t kv_bytes = (int64_t)sk * 64 * 4 * 2;   // a head's K and V
  const int group = (int)std::max<int64_t>(
      1, std::min<int64_t>(bh, kv_bytes ? flash_wg::kGroupBytes / kv_bytes
                                        : bh));
  CUtensorMap m[3] = {};
  const void* const ptr[3] = {q, k, v};
  // sk 0: no k tile is ever loaded, so k and v need no map
  for (int i = 0; i < (sk > 0 ? 3 : 1); ++i) {
    const uint64_t n[4] = {64, (uint64_t)(i ? sk : sq), (uint64_t)h,
                           (uint64_t)b};
    const int64_t str[3] = {st[3 * i + 1], st[3 * i + 2], st[3 * i]};
    if (!hop::f32_map4(&m[i], ptr[i], n, str, i ? kT : 128))
      return (int)cudaErrorInvalidValue;
  }
  if (bh * n_qt > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * kFwdQ + kFwdStages * kFwdStage + 1024;
  auto kern = md.bias ? (md.seed ? fwd_tf32_kernel<true, true>
                                 : fwd_tf32_kernel<true, false>)
                      : (md.seed ? fwd_tf32_kernel<false, true>
                                 : fwd_tf32_kernel<false, false>);
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(bh * n_qt), kThreads, smem, stream>>>(
      static_cast<float*>(out), static_cast<float*>(lse), h, sq, sk, scale,
      causal, group, md, m[0], m[1], m[2]);
  return (int)cudaGetLastError();
}

}  // namespace flash_tf32
