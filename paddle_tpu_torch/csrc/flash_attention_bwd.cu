// Flash attention backward for Hopper: dQ, and dK with dV, from (q, k, v,
// dO, lse, delta) over [b, s, h, d] tensors, causal or not.
//
// Replaces the two pallas_calls of
// paddle_tpu/ops/pallas/flash_attention.py::flash_block_grads: the dQ pass
// (_bwd_dq_kernel, :329-389, called at :558) and the dK/dV pass
// (_bwd_dkv_kernel, :392-463, called at :590), without the bias,
// segment-id and dropout modes.
//
// Bound on the H100: operations. At the training path's shape (b 4, s 2048,
// h 16, d 128, causal, bf16) dQ is 3 products (103 GFLOP, 104 us at the
// 989 TFLOP/s bf16 peak) and dK/dV 4 products (137 GFLOP, 139 us), against
// ~0.2 GB of inputs and outputs (~60 us at 3.35 TB/s).
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
//
// Arithmetic against the Pallas kernels (and flash_block_grads_plain):
// S = Q K^T and dP = dO V^T are bf16 products, exact in fp32, in another
// order of sums; P and dS are computed in fp32 and rounded to bf16 as the
// A operand of dV += P^T dO, dQ += dS K and dK += dS^T Q (the TPU's MXU
// rounds its fp32 operands the same way at default precision). The plain
// version keeps them in fp32, so dq, dk and dv differ by about 2^-9 of the
// size of their terms, averaged over the sum. Inputs are bf16 only (the
// wrapper raises on others).
//
// C interface (bound with ctypes): flash_bwd_dq_launch and
// flash_bwd_dkv_launch return the CUDA launch error (0 on success); they
// never synchronise.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;   // 4 warps x 16 rows
constexpr int kBQ = 64;         // dQ: q rows per block
constexpr int kBK = 64;         // keys per tile (both kernels)

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int sq, int sk, int64_t q_sb, int64_t q_ss,
                    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
                    int64_t o_ss, int64_t o_sh, float scale, bool causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kBQ * LD;    // dO
  bf16* sK[2] = {sO + kBQ * LD, sO + kBQ * LD + 2 * kBK * LD};   // 2 stages
  bf16* sV[2] = {sK[0] + kBK * LD, sK[1] + kBK * LD};

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // heaviest tile first
  const int bh = blockIdx.y, bi = bh / H, hi = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;

  const bf16* kb = k + bi * k_sb + hi * k_sh;
  const bf16* vb = v + bi * v_sb + hi * v_sh;
  const int kend = causal ? min(sk, q0 + kBQ + off) : sk;
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;
  auto issue = [&](int jt) {   // tile jt of K and V into stage jt & 1
    const int k0 = jt * kBK;
    load_tile_async<kBK, D, LD, kThreads>(sK[jt & 1], kb + k0 * k_ss,
                                          k_ss, sk - k0);
    load_tile_async<kBK, D, LD, kThreads>(sV[jt & 1], vb + k0 * v_ss,
                                          v_ss, sk - k0);
    cp_async_commit();
  };
  load_tile_async<kBQ, D, LD, kThreads>(
      sQ, q + bi * q_sb + hi * q_sh + q0 * q_ss, q_ss, sq - q0);
  load_tile_async<kBQ, D, LD, kThreads>(
      sO, dout + bi * o_sb + hi * o_sh + q0 * o_ss, o_ss, sq - q0);
  cp_async_commit();
  if (n_tiles > 0) issue(0);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < sq;
    lse2[r] = ok ? fmaxf(lse[(int64_t)bh * sq + row[r]], kClamp) * kLog2e
                 : 0.f;
    dlt[r] = ok ? delta[(int64_t)bh * sq + row[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kBK;
    const bf16* cK = sK[jt & 1];
    const bf16* cV = sV[jt & 1];
    __syncthreads();   // stage (jt + 1) & 1 (tile jt - 1) is consumed
    if (jt + 1 < n_tiles) {
      issue(jt + 1);   // streams in while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // Q, dO and tile jt are visible to every warp

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
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
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        const float p = visible(row[r], col, sq, sk, off, causal)
                            ? exp2f(s[nt][i] * scale_log2 - lse2[r]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - dlt[r]) * scale;   // dS
      }
    }
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

  cp_async_wait<0>();   // nothing in flight at exit (n_tiles == 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    bf16* drow = dq + (((int64_t)bi * sq + row[r]) * H + hi) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(drow + i * 8 + 2 * t, acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int sq, int sk,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale,
                     bool causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K, V, then two stages of (Q, dO, lse in base 2, delta)
  constexpr int kStage = 2 * BQ * LD * sizeof(bf16) + 2 * BQ * sizeof(float);
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBK * LD;
  unsigned char* stages = reinterpret_cast<unsigned char*>(sV + kBK * LD);
  bf16* sQ[2] = {reinterpret_cast<bf16*>(stages),
                 reinterpret_cast<bf16*>(stages + kStage)};
  bf16* sO[2] = {sQ[0] + BQ * LD, sQ[1] + BQ * LD};
  float* sL[2] = {reinterpret_cast<float*>(sO[0] + BQ * LD),
                  reinterpret_cast<float*>(sO[1] + BQ * LD)};
  float* sD[2] = {sL[0] + BQ, sL[1] + BQ};

  const int k0 = blockIdx.x * kBK;   // early keys see the most rows: first
  const int bh = blockIdx.y, bi = bh / H, hi = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;

  const bf16* qb = q + bi * q_sb + hi * q_sh;
  const bf16* ob = dout + bi * o_sb + hi * o_sh;
  load_tile_async<kBK, D, LD, kThreads>(
      sK, k + bi * k_sb + hi * k_sh + k0 * k_ss, k_ss, sk - k0);
  load_tile_async<kBK, D, LD, kThreads>(
      sV, v + bi * v_sb + hi * v_sh + k0 * v_ss, v_ss, sk - k0);
  cp_async_commit();

  const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  // causal: query row r sees key k0 when r >= k0 - off
  const int first = causal ? max(0, k0 - off) : 0;
  const int i0 = first / BQ, n_qt = (sq + BQ - 1) / BQ;
  auto issue = [&](int it) {   // q tile it into stage it & 1
    const int qs0 = it * BQ, st = it & 1;
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
  if (i0 < n_qt) issue(i0);
  for (int it = i0; it < n_qt; ++it) {
    const int qs0 = it * BQ, st = it & 1;
    const bf16* cQ = sQ[st];
    const bf16* cO = sO[st];
    const float* cL = sL[st];
    const float* cD = sD[st];
    __syncthreads();   // stage (it + 1) & 1 (q tile it - 1) is consumed
    if (it + 1 < n_qt) {
      issue(it + 1);   // streams in while this q tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // K, V and q tile it are visible to every warp

    float s[BQ / 8][4], dp[BQ / 8][4];   // S^T and dP^T: key rows x q cols
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
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
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + 2 * t + (i & 1);   // q row within the tile
        const float p = visible(qs0 + c, krow[i >> 1], sq, sk, off, causal)
                            ? exp2f(s[nt][i] * scale_log2 - cL[c]) : 0.f;
        s[nt][i] = p;                                   // P^T
        dp[nt][i] = p * (dp[nt][i] - cD[c]) * scale;    // dS^T
      }
    }
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

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* delta, void* dq, int b, int h,
              int sq, int sk, const int64_t* st, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kBQ + 4 * kBK) * (D + 8);
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), h, sq, sk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale, causal != 0);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* delta, void* dk, void* dv, int b,
               int h, int sq, int sk, const int64_t* st, float scale,
               int causal, cudaStream_t stream) {
  constexpr int BQ = DkvTile<D>::BQ;
  const size_t smem = sizeof(bf16) * (4 * BQ + 2 * kBK) * (D + 8)
                      + sizeof(float) * 4 * BQ;
  auto kern = flash_bwd_dkv_kernel<D, BQ>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + kBK - 1) / kBK, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, sq, sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal != 0);
  return (int)cudaGetLastError();
}

bool shape_ok(int64_t b, int64_t h, int64_t sq, int64_t sk) {
  return b * h <= 65535 && sq <= (1 << 30) && sk <= (1 << 30);
}

}  // namespace

// q, k, v, dO and the gradients are bfloat16. Strides are in elements,
// (batch, seq, head) for each of q, k, v and dO; head_dim is contiguous.
// lse and delta are fp32 [b, h, sq]; dq is contiguous [b, sq, h, d].
extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int64_t b, int64_t h,
    int64_t sq, int64_t sk, int64_t d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float scale, int causal, void* stream) {
  if (b * h <= 0 || sq <= 0 || sk <= 0) return 0;
  if (!shape_ok(b, h, sq, sk)) return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, (int)b, (int)h,
                         (int)sq, (int)sk, st, scale, causal, s);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, (int)b, (int)h,
                          (int)sq, (int)sk, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_launch; dk and dv are contiguous [b, sk, h, d].
extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int64_t b,
    int64_t h, int64_t sq, int64_t sk, int64_t d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float scale, int causal, void* stream) {
  if (b * h <= 0 || sq <= 0 || sk <= 0) return 0;
  if (!shape_ok(b, h, sq, sk)) return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, (int)b, (int)h,
                          (int)sq, (int)sk, st, scale, causal, s);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, (int)b,
                           (int)h, (int)sq, (int)sk, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
