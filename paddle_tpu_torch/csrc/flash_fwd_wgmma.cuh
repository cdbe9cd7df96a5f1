// The bf16 flash forward on Hopper (sm_90a): O = softmax(Q K^T scale +
// bias, masked) V and lse on wgmma, K and V fed by TMA through an
// mbarrier ring.
//
// Replaces, for bf16 inputs without segment ids (causal or not, d 64 or
// 128, with or without an additive fp32 bias and in-kernel dropout: the
// modes that Llama, Qwen2-MoE, BERT and GPT-2 train with in bf16),
// paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (:96) and _fwd
// (:174, its pallas_call at :242). flash_attention_fwd.cu's launcher
// routes these modes here; segment ids and every fp32 mode keep the
// mma.sync kernel there.
//
// Bound on the H100: operations. At the training path's shape (b 4, s 2048,
// h 16, d 128, causal) the two products are 68.7 GFLOP, 69 us at the 989
// TFLOP/s bf16 peak, against ~40 us of bytes.
//
// Design (flash_bwd_wgmma.cuh's dQ loop, Q-stationary). A block is three
// warpgroups and owns a 128-row q tile of one (batch, head): warpgroups 0
// and 1 consume, 64 rows each; in warpgroup 2 one thread issues every TMA
// load and setmaxnreg hands the rest of its registers to the consumers.
// Q is loaded once (a 4-D map through q's strides); K and V tiles of 64
// keys come through a kFwdStages ring up to the causal diagonal. Blocks run
// in groups of heads whose K and V fit in a third of the L2, each group's
// q tiles heaviest first: blocks that share K and V run together (ordered
// by head first, every K and V tile was read from memory once per q tile
// and the kernel was bound by those bytes). Per k tile j a consumer runs
//   S = Q K^T            (wgmma, both operands in shared memory, K-major)
//   m' = max(m, rowmax S), alpha = 2^(m - m'), P = 2^(S scale log2e - m')
//   l = l alpha + rowsum P (the fp32 P), O = O alpha + P V
// with P rounded to bf16 as the A operand from registers (acc_to_a) and V
// an MN-major B; at d 128 O is two n64 halves. The products overlap the
// softmax: S of tile j and P V of tile j - 1 are issued together, then
// tile j's softmax runs while P V runs, and O is rescaled once that
// product is waited for. Only the tiles that cross the diagonal or the
// ragged end test each element (P = 0 for a key a query cannot see or past
// sk); a consumer whose rows see no key of the block's last tile (causal:
// warpgroup 0) does not visit it. Rows past sq read TMA's zeros and are
// not stored. A row that sees no key gets out = 0 and lse = -1e30, as
// _fwd_kernel (:209-216) and the mma.sync kernel. A stage goes back to the
// producer only after the wgmma.wait_group that covers every group that
// read it (the release rule: each release below names its wait). No
// atomics; the sums run in one fixed order, so results repeat bitwise.
//
// Bias mode (HAS_BIAS, a template flag, never a run-time branch): the fp32
// bias is read through four element strides, any of them 0 (BERT's key
// padding is [b, 1, 1, sk] expanded), so TMA cannot load it. The producer
// warpgroup's 128 threads copy each tile's bias [128 rows][64 keys] into
// the tile's stage with cp.async (16-byte copies where the key stride is 1
// and rows are aligned, else 4-byte ones; one row alone when the bias does
// not vary over queries), zero past sk, and the copies arrive on the
// stage's full barrier; the consumers read it from shared memory (a
// swizzled layout, so a warp's 8-byte reads do not conflict), off their
// critical path. Loaded by the consumers themselves with __ldg, a tile
// ahead, the bias mode took 1.46x the no-bias one (PERF.md §6). S scale +
// bias, as _fwd_kernel adds the bias after (q * scale) k (:146-148), its
// row max taken in natural units and log2e folded into the exponent's
// fma; a bias of -inf or -1e30 gives P = 0 and no NaN.
//
// Dropout mode (DROP, a template flag too), as _fwd_kernel (:149-163,
// _drop_mask :50): the running max and the row sums l take the undropped
// P, P V takes keep ? P / (1 - p) : 0, rounded to bf16 as the A operand
// (acc_to_a_kept), and lse is unchanged. A tile's keep bits are drawn
// where and as dq_wgmma_kernel draws them, in the same m64n64 frame:
// once S of the tile (and P V of the tile before) is committed, one
// Philox block per four elements (philox.cuh keep_bits_qk's lane
// exchange), so the forward's mask is the backward's for every (query,
// key) by construction. The mma.sync kernel drew each block twice (lanes
// t and t ^ 1). ptxas issues the draw's integer work before the products
// (the SASS), and pinned behind S's wait it took the same time on an
// H100: it costs its issue slots wherever it runs (PERF.md §6). The key
// (seed, offset) is read from a device int64 [2], so no draw waits for
// the host.
//
// Arithmetic: the mma.sync kernel's (flash_attention_fwd.cu): the fp32
// product is scaled, P is rounded to bf16 for P V and the row sums take
// the fp32 P; masked scores take -1e30 and the subtracted max is clamped
// at -1e25; lse = (m + log2 l) ln 2, out = O / l.

#pragma once

#include <algorithm>

#include "flash_wg_common.cuh"

namespace flash_wg {

constexpr int kFwdStages = 3;
constexpr uint32_t kBiasTile = kRows * 64 * 4;   // fp32 [128 rows][64 keys]

// 4 bytes global -> shared, zero-filled past src_bytes (0 or 4)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// ---- forward: block (batch*head, q tile); q rows q0.., 64 wg.. a
// consumer ----
template <int D, bool HAS_BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_wgmma_kernel(bf16* __restrict__ out, float* __restrict__ lse, int H,
                 int sq, int sk, float scale, int causal, int group,
                 const Mode md,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v) {
  constexpr int NC = D / 64;                 // 64-column atoms a row
  constexpr int S = kFwdStages;
  constexpr uint32_t kQ = NC * 2 * kAtom;    // Q: NC atoms of 128 rows
  constexpr uint32_t kKV = NC * kAtom;       // a K or V tile: 64 keys
  // K, V, then HAS_BIAS the tile's fp32 bias [128 rows][64 keys]
  constexpr uint32_t kStage = 2 * kKV + (HAS_BIAS ? kBiasTile : 0);
  __shared__ uint64_t full[S], empty[S], qbar;
  unsigned char* smem = tiles();
  const uint32_t base = hop::smem_u32(smem);
  const uint32_t sQ = base, ring = base + kQ;

  // block -> (batch*head, q tile): the heads in groups of `group`, and in
  // a group each q tile of its heads, heaviest (last) first, so that the
  // blocks that run together read the same K and V tiles from L2
  const int n_qt = (sq + kRows - 1) / kRows;
  const int g = blockIdx.x / (group * n_qt);
  const int gi = blockIdx.x - g * group * n_qt;
  const int gs = min(group, (int)gridDim.x / n_qt - g * group);
  const int bh = g * group + gi % gs, bi = bh / H, hi = bh % H;
  const int q0 = (n_qt - 1 - gi / gs) * kRows;
  const int off = sk - sq;
  const int kend = causal ? min(sk, q0 + kRows + off) : sk;
  const int n_kt = kend > 0 ? (kend + 63) / 64 : 0;   // k tiles to load
  const int tid = threadIdx.x, wg = tid >> 7;
  // HAS_BIAS: one bias row serves every query when it does not vary over
  // queries (BERT's key padding)
  const bool one_row = HAS_BIAS && md.b_sq == 0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {   // HAS_BIAS: the producers' copies too
      hop::mbar_init(hop::smem_u32(&full[s]), HAS_BIAS ? 1 + 128 : 1);
      hop::mbar_init(hop::smem_u32(&empty[s]), kConsumerWarps);
    }
    hop::mbar_init(hop::smem_u32(&qbar), 1);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {                                     // the producer
    hop::reg_dealloc<HAS_BIAS ? 56 : 24>();
    if (n_kt == 0 || (!HAS_BIAS && tid != 256)) return;
    const int pt = tid - 256;
    if (pt == 0) {
      const uint32_t qb = hop::smem_u32(&qbar);
      hop::mbar_arrive_tx(qb, kQ);
      for (int c = 0; c < NC; ++c)
        hop::tma_load4(sQ + c * 2 * kAtom, &tm_q, qb, c * 64, q0, hi, bi);
    }
    // HAS_BIAS: the block's bias rows (row r at bias row min(q0 + r, sq -
    // 1): a row past sq is never stored), and whether a row's 64 keys go
    // as 16-byte copies (unit key stride, 16-byte aligned rows)
    const float* bblk = HAS_BIAS ? md.bias + bi * md.b_sb + hi * md.b_sh
                                 : nullptr;
    const bool vec = HAS_BIAS && md.b_sk == 1 && md.b_sq % 4 == 0
                     && reinterpret_cast<uintptr_t>(bblk) % 16 == 0;
    const int n_brows = one_row ? 1 : kRows;
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % S, k0 = j * 64;
      const uint32_t f = hop::smem_u32(&full[s]), st = ring + s * kStage;
      hop::mbar_wait(hop::smem_u32(&empty[s]), ((j / S) & 1) ^ 1);
      if (pt == 0) {
        hop::mbar_arrive_tx(f, 2 * kKV);
        for (int c = 0; c < NC; ++c) {
          hop::tma_load4(st + c * kAtom, &tm_k, f, c * 64, k0, hi, bi);
          hop::tma_load4(st + kKV + c * kAtom, &tm_v, f, c * 64, k0, hi,
                         bi);
        }
      }
      if constexpr (HAS_BIAS) {
        // element (r, c) at r * 64 + (c ^ 8 (r & 7)) floats: a consumer
        // warp's 8-byte reads of 8 rows then fall in distinct banks
        const uint32_t sb = st + 2 * kKV;
        if (vec) {
          for (int i = pt; i < n_brows * 16; i += 128) {
            const int r = i >> 4, c = (i & 15) * 4, key = k0 + c;
            const int valid = max(0, min(4, sk - key));
            const float* src = bblk + (int64_t)min(q0 + r, sq - 1) * md.b_sq
                               + (valid ? key : 0);
            hop::cp16(sb + 4 * (r * 64 + (c ^ ((r & 7) << 3))), src,
                      4 * valid);
          }
        } else {
          for (int i = pt; i < n_brows * 64; i += 128) {
            const int r = i >> 6, c = i & 63, key = k0 + c;
            const bool ok = key < sk;
            const float* src = bblk + (int64_t)min(q0 + r, sq - 1) * md.b_sq
                               + (ok ? (int64_t)key * md.b_sk : 0);
            cp4(sb + 4 * (r * 64 + (c ^ ((r & 7) << 3))), src, ok ? 4 : 0);
          }
        }
        hop::cp_arrive(f);
      }
    }
    return;
  }
  hop::reg_alloc<HAS_BIAS ? 224 : 240>();

  const int warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3;
  const int r0 = q0 + 64 * wg;                       // this consumer's rows
  const int row[2] = {r0 + 16 * warp + (lane >> 2),
                      r0 + 16 * warp + (lane >> 2) + 8};
  const float scale_log2 = scale * flash::kLog2e;
  // the keys this consumer's rows can see lie below wkend; it skips the
  // block's last tile when that tile holds none of them (a vote, so that
  // ptxas sees the loop's bound uniform)
  const int wkend = causal ? min(sk, r0 + 64 + off) : sk;
  const bool past = __any_sync(0xffffffffu, (n_kt - 1) * 64 >= wkend);
  const int n_mine = n_kt > 0 && past ? n_kt - 1 : n_kt;
  // HAS_BIAS: this lane's elements in a stage's bias tile: rows at boff[r]
  // (row 0 for both with one_row), chunk n at (8 n) ^ bx
  int boff[2] = {0, 0}, bx = 0;
  if constexpr (HAS_BIAS) {
    const int lr = row[0] - q0;                      // lr & 7 == lane >> 2
    boff[0] = one_row ? 2 * t : lr * 64 + 2 * t;
    boff[1] = one_row ? 2 * t : (lr + 8) * 64 + 2 * t;
    bx = one_row ? 0 : (lr & 7) << 3;
  }
  uint32_t key0 = 0, key1 = 0;                       // DROP: the Philox key
  if constexpr (DROP) {
    key0 = (uint32_t)md.seed[0];
    key1 = (uint32_t)md.seed[1];
  }

  float o[NC][8][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(o[c]);
  float m_r[2] = {flash::kNeg, flash::kNeg};   // running max, base 2
  float l_r[2] = {0.f, 0.f};                   // this lane's row sums
  uint32_t keep = 0;                           // DROP: the keep bits of S's
                                               // tile (bit 4 n + i: [n][i])

  // tile k0's scores in s -> P (fp32), the running max and sums updated,
  // with the bias of stage st; alpha: the factor of the O so far
  auto softmax = [&](float (&s)[8][4], int k0, uint32_t st,
                     float (&alpha)[2]) {
    // the diagonal (causal) or the ragged end crosses this tile
    const bool edge = (causal && k0 + 63 > r0 + off) || k0 + 64 > sk;
    // HAS_BIAS: S scale + bias, kept in natural units (its max times
    // log2e is the max in base 2, so log2e goes into the exponent's fma);
    // else S scale log2e
    float unit = 1.f;
    if constexpr (HAS_BIAS) {
      unit = flash::kLog2e;
      const float* bt =
          reinterpret_cast<const float*>(smem + (st - base) + 2 * kKV);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 b0 = *reinterpret_cast<const float2*>(
            bt + boff[0] + ((8 * n) ^ bx));
        const float2 b1 = one_row ? b0 : *reinterpret_cast<const float2*>(
            bt + boff[1] + ((8 * n) ^ bx));
        s[n][0] = fmaf(s[n][0], scale, b0.x);
        s[n][1] = fmaf(s[n][1], scale, b0.y);
        s[n][2] = fmaf(s[n][2], scale, b1.x);
        s[n][3] = fmaf(s[n][3], scale, b1.y);
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] *= scale_log2;
    }
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!flash::visible(row[i >> 1], k0 + 8 * n + 2 * t + (i & 1), sq,
                              sk, off, causal != 0))
            s[n][i] = flash::kNeg;
    }
    float mx[2] = {HAS_BIAS ? flash::kNeg : m_r[0],
                   HAS_BIAS ? flash::kNeg : m_r[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
    float msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = flash::quad_max(mx[r]);
      if constexpr (HAS_BIAS) mx[r] = fmaxf(m_r[r], mx[r] * unit);
      alpha[r] = ex2(m_r[r] - mx[r]);
      msub[r] = fmaxf(mx[r], flash::kClamp);
      m_r[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(fmaf(s[n][i], unit, -msub[i >> 1]));
        s[n][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
  };

  // DROP: tile k0's keep bits
  auto draw = [&](int k0) {
    if constexpr (DROP)
      keep = flash::keep_bits_qk<8>(bh, row[0], row[1], k0 + 2 * t, key0,
                                    key1, md.thresh, lane);
  };

  if (n_mine > 0) {
    uint32_t a[4][4];                          // P of the tile before
    float sc[8][4], alpha[2];
    // P (in sc) as P V's A operand; DROP: keep ? P / (1 - p) : 0
    auto p_to_a = [&]() {
      if constexpr (DROP)
        acc_to_a_kept(a, sc, keep, md.inv_keep);
      else
        hop::acc_to_a(a, sc);
    };
    hop::mbar_wait(hop::smem_u32(&qbar), 0);
    hop::mbar_wait(hop::smem_u32(&full[0]), 0);
    zero(sc);
    hop::wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)              // S = Q K^T, tile 0
      hop::wgmma_chunk<0, 0>(sc, sQ + c * 2 * kAtom + wg * kAtom,
                             ring + c * kAtom);
    hop::wg_commit();
    draw(0);                                  // S in flight
    hop::wg_wait<0>();
    hop::acc_fence(sc);
    softmax(sc, 0, ring, alpha);              // O is 0: nothing to rescale
    p_to_a();
    for (int j = 1; j < n_mine; ++j) {
      const int s = j % S, sp = (j - 1) % S, k0 = j * 64;
      const uint32_t st = ring + s * kStage, stp = ring + sp * kStage;
      hop::mbar_wait(hop::smem_u32(&full[s]), (j / S) & 1);
      zero(sc);
      hop::wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)            // S = Q K^T, tile j
        hop::wgmma_chunk<0, 0>(sc, sQ + c * 2 * kAtom + wg * kAtom,
                               st + c * kAtom);
      hop::wg_commit();
      hop::wgmma_rs_chunk<1, NC>(o, a, stp + kKV, kAtom);  // O += P V, j - 1
      hop::wg_commit();
      draw(k0);                               // S and P V in flight
      hop::wg_wait<1>();                      // S is done, P V runs on
      hop::acc_fence(sc);
      softmax(sc, k0, st, alpha);
      hop::wg_wait<0>();                      // P V of tile j - 1 is done
#pragma unroll
      for (int c = 0; c < NC; ++c) hop::acc_fence(o[c]);
      frag_fence(a);
      // release stage sp (tile j - 1): after the wg_wait<0> just above,
      // which covers its P V, the last group that read it (its S was
      // waited for, and its bias read, in the iteration before)
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sp]));
#pragma unroll
      for (int c = 0; c < NC; ++c)            // O *= alpha
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[c][n][0] *= alpha[0];
          o[c][n][1] *= alpha[0];
          o[c][n][2] *= alpha[1];
          o[c][n][3] *= alpha[1];
        }
      p_to_a();
    }
    const int sl = (n_mine - 1) % S;
    hop::wg_fence();
    hop::wgmma_rs_chunk<1, NC>(o, a, ring + sl * kStage + kKV, kAtom);
    hop::wg_commit();
    hop::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) hop::acc_fence(o[c]);
    frag_fence(a);
    // release stage sl (the last tile): after the wg_wait<0> just above,
    // which covers its P V, the last group that read it
    if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[sl]));
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
    bf16* orow = out + (((int64_t)bi * sq + row[r]) * H + hi) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        flash::store2(orow + c * 64 + 8 * n + 2 * t,
                      o[c][n][2 * r] / l_safe, o[c][n][2 * r + 1] / l_safe);
    if (t == 0)
      lse[(int64_t)bh * sq + row[r]] =
          l == 0.f ? flash::kNeg : (m_r[r] + log2f(l)) * flash::kLn2;
  }
}

// ---- host side ----

// q, k, v [b, s, h, D] bf16 through their (batch, seq, head) strides st[0..8];
// out contiguous [b, sq, h, D], lse fp32 [b, h, sq]. md: the bias (null:
// none) and its strides, the dropout key (null: none) and its threshold
// and 1 / (1 - p).
template <int D>
int fwd_launch(const void* q, const void* k, const void* v, void* out,
               void* lse, int b, int h, int sq, int sk, const int64_t* st,
               float scale, int causal, const Mode& md, cudaStream_t stream) {
  constexpr int NC = D / 64;
  const int64_t n_qt = (sq + kRows - 1) / kRows, bh = (int64_t)b * h;
  const int64_t kv_bytes = (int64_t)sk * D * 2 * 2;   // a head's K and V
  const int group = (int)std::max<int64_t>(
      1, std::min<int64_t>(bh, kv_bytes ? kGroupBytes / kv_bytes : bh));
  CUtensorMap m[3] = {};
  // sk 0: no k tile is ever loaded, so k and v need no map
  if (bh * n_qt > INT_MAX
      || !map_bshd<D>(&m[0], q, b, sq, h, st[0], st[1], st[2], kRows)
      || (sk > 0
          && !(map_bshd<D>(&m[1], k, b, sk, h, st[3], st[4], st[5], 64)
               && map_bshd<D>(&m[2], v, b, sk, h, st[6], st[7], st[8], 64))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = NC * 2 * kAtom
                      + kFwdStages * (2 * NC * kAtom + (md.bias ? kBiasTile : 0))
                      + 1024;
  auto kern = md.bias ? (md.seed ? fwd_wgmma_kernel<D, true, true>
                                 : fwd_wgmma_kernel<D, true, false>)
                      : (md.seed ? fwd_wgmma_kernel<D, false, true>
                                 : fwd_wgmma_kernel<D, false, false>);
  cudaError_t err = flash::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(bh * n_qt), kThreads, smem, stream>>>(
      static_cast<bf16*>(out), static_cast<float*>(lse), h, sq, sk, scale,
      causal, group, md, m[0], m[1], m[2]);
  return (int)cudaGetLastError();
}

}  // namespace flash_wg
