// Flash attention forward for Hopper: (out, lse) of softmax(scale * Q K^T) V
// over [b, s, h, d] tensors, causal or not.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel / _fwd
// (its pallas_call at :242), without the bias, segment-id and dropout modes.
//
// Bound on the H100: operations. At the training path's shape (b 4, s 2048,
// h 16, d 128, causal, bf16) the two products are 68.7 GFLOP against
// ~134 MB of q, k, v, out and lse: 69 us at the 989 TFLOP/s bf16
// tensor-core peak against 40 us at 3.35 TB/s.
//
// Design. The TPU kernel walks a (b*h, q block, k block) grid in order and
// carries acc, m and l in VMEM scratch across the sequential k axis. Blocks
// on Hopper run in no order and carry nothing, so here one block of 4 warps
// owns a 64-row q tile of one (batch, head) and loops over the k tiles
// itself, 64 keys at a time:
//   - q, k and v are read through their strides (no transposed copy); each
//     tile goes global -> shared in 16-byte vectors, then into tensor-core
//     fragments with ldmatrix (V with ldmatrix.trans, as the B operand of
//     P V). Each warp keeps its 16 q rows as A fragments in registers.
//   - two shared stages of (K, V), copied with cp.async, so tile j + 1
//     streams in while tile j is computed.
//   - S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, fp32 sums).
//   - online softmax in fp32 per row, in base 2 (exp2 of the scores times
//     scale * log2 e); each lane keeps partial row sums of its columns and
//     the quad adds them once at the end.
//   - causal: the loop stops at the tile holding the diagonal, the
//     counterpart of the Pallas dead-block skip (:124-130, :209-216); tiles
//     are launched heaviest (last q tile) first.
//   - a ragged s is masked in the kernel (rows and keys past the end are
//     zero-filled and masked), where the JAX code pads to whole blocks.
//
// Arithmetic against the Pallas kernel (and flash_fwd_plain): QK^T of bf16
// inputs is exact in fp32, only the order of the sums differs; the Pallas
// kernel scales q before the product and this one scales the fp32 product
// (one fp32 rounding apart). P is rounded to bf16 for the P V product
// (the TPU's MXU does the same at default precision); the plain version
// keeps P in fp32, so the output differs by about one bf16 ulp of out.
// Inputs are bf16 only (the wrapper raises on others). Masked
// scores take -1e30, the subtracted max is clamped at -1e25, and a row that
// sees no key gets out = 0 and lse = -1e30, as in the Pallas kernel.
//
// C interface (bound with ctypes): flash_fwd_launch returns the CUDA launch
// error (0 on success); it never synchronises.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;   // 4 warps x 16 q rows
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int sq, int sk,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, float scale, bool causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two stages of (K, V); the Q tile is staged in stage 1's K first
  bf16* sK[2] = {reinterpret_cast<bf16*>(smem_raw),
                 reinterpret_cast<bf16*>(smem_raw) + 2 * kBK * LD};
  bf16* sV[2] = {sK[0] + kBK * LD, sK[1] + kBK * LD};

  const int nq = (sq + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // heaviest tile first
  const int bh = blockIdx.y, bi = bh / H, hi = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;

  const bf16* qb = q + bi * q_sb + hi * q_sh;
  const bf16* kb = k + bi * k_sb + hi * k_sh;
  const bf16* vb = v + bi * v_sb + hi * v_sh;

  const int kend = causal ? min(sk, q0 + kBQ + off) : sk;   // keys < kend
  const int n_tiles = kend > 0 ? (kend + kBK - 1) / kBK : 0;
  auto issue = [&](int jt) {   // tile jt of K and V into stage jt & 1
    const int k0 = jt * kBK;
    load_tile_async<kBK, D, LD, kThreads>(sK[jt & 1], kb + k0 * k_ss,
                                          k_ss, sk - k0);
    load_tile_async<kBK, D, LD, kThreads>(sV[jt & 1], vb + k0 * v_ss,
                                          v_ss, sk - k0);
    cp_async_commit();
  };

  load_tile_async<kBQ, D, LD, kThreads>(sK[1], qb + q0 * q_ss, q_ss,
                                        sq - q0);
  cp_async_commit();
  if (n_tiles > 0) issue(0);
  if (n_tiles > 0) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(qf[ks], a_addr<LD>(sK[1], warp * 16, ks * 16, lane));

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {kNeg, kNeg};   // running max (base-2 scaled scores)
  float l_r[2] = {0.f, 0.f};     // this lane's partial row sums
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kBK;
    const bf16* cK = sK[jt & 1];
    const bf16* cV = sV[jt & 1];
    __syncthreads();   // stage (jt + 1) & 1 (tile jt - 1, or Q) is consumed
    if (jt + 1 < n_tiles) {
      issue(jt + 1);   // streams in while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile jt is visible to every warp

    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<LD>(cK, np * 16, ks * 16, lane));
        mma(s[2 * np], qf[ks], b[0], b[1]);
        mma(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        const float x = visible(row[i >> 1], col, sq, sk, off, causal)
                            ? s[nt][i] * scale_log2 : kNeg;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m_r[r] - mx[r]);
      msub[r] = fmaxf(mx[r], kClamp);
      m_r[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[nt][i] - msub[i >> 1]);
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, a_addr<LD>(cV, kk * 16, dp * 16, lane));
        mma(o[2 * dp], a, b[0], b[1]);
        mma(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const float l_safe = l == 0.f ? 1.f : l;
    if (row[r] >= sq) continue;
    bf16* orow = out + (((int64_t)bi * sq + row[r]) * H + hi) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(orow + i * 8 + 2 * t, o[i][2 * r] / l_safe,
             o[i][2 * r + 1] / l_safe);
    if (t == 0)
      lse[(int64_t)bh * sq + row[r]] =
          l == 0.f ? kNeg : (m_r[r] + log2f(l)) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int h, int sq, int sk, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 4 * kBK * (D + 8);
  auto kern = flash_fwd_kernel<D>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), h, sq, sk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out are bfloat16. Strides are in elements, (batch, seq,
// head) for each of q, k, v; head_dim is contiguous. out is contiguous [b, sq, h, d]; lse fp32 [b, h, sq].
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int64_t b, int64_t h,
                                int64_t sq, int64_t sk, int64_t d,
                                int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                float scale, int causal, void* stream) {
  if (b * h <= 0 || sq <= 0) return 0;
  if (b * h > 65535 || sq > (1 << 30) || sk < 0 || sk > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, out, lse, (int)b, (int)h, (int)sq, (int)sk,
                      st, scale, causal, s);
  if (d == 128)
    return launch<128>(q, k, v, out, lse, (int)b, (int)h, (int)sq, (int)sk,
                       st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
