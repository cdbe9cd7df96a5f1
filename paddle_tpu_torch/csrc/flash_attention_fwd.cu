// Flash attention forward for Hopper: (out, lse) of softmax(scale * Q K^T) V
// over [b, s, h, d] tensors, causal or not.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel / _fwd
// (its pallas_call at :242), with its additive bias mode (has_bias), its
// in-kernel dropout (dropout_p, _drop_mask :50), its segment-id mode
// (has_seg, flash_attn_unpadded :765) and any input dtype the JAX kernel
// takes in bf16 and fp32.
//
// Bound on the H100: operations. At the training path's shape (b 4, s 2048,
// h 16, d 128, causal, bf16) the two products are 68.7 GFLOP against
// ~134 MB of q, k, v, out and lse: 69 us at the 989 TFLOP/s bf16
// tensor-core peak against 40 us at 3.35 TB/s. fp32 (GPT-2 small, b 8, s
// 1024, h 12, d 64, causal): 12.9 GFLOP at the fastest fp32-accurate rate,
// 3xTF32 at 494.7 / 3 TFLOP/s, 78 us.
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
//   - bias mode (HAS_BIAS, a template flag, so the no-bias instantiations
//     are the kernels they were): an fp32 additive bias read through four
//     element strides (batch, head, query, key), so a broadcast dimension
//     is a stride of 0 and BERT's [b, 1, 1, sk] key-padding mask is never
//     materialised at [b, 1, sq, sk]. Each lane reads the bias of the
//     score elements it holds (a quad's 8 consecutive keys of one row:
//     whole 32-byte sectors) and adds it to the fp32 score before the
//     running max, as _fwd_kernel adds it after (q * scale) k (:146-148).
//     Keys past sk are masked, never read: the JAX code pads them with
//     -1e30 (_pad_bias :268), which gives them the same p = 0.
//   - fp32 mode (T = float; here at d 128, and with segment ids at d 64
//     too: see below): the same loop on 3xTF32 products
//     (flash_common.cuh), Q in its own shared tile (its split fragments
//     would not fit the registers), fp32 tiles with LD = D + 4.
//   - dropout mode (DROP, a template flag; here fp32 at d 128): as
//     _fwd_kernel (:149-163), the
//     row sums l take the undropped p; each lane then draws the keep bits
//     of the elements it holds (philox.cuh) and P V takes keep ? p / (1 -
//     p_drop) : 0. lse is unchanged. The key (seed, offset) is read from a
//     device int64 [2], so no draw waits for the host.
//   - segment mode (SEG, a template flag, instantiated without bias and
//     dropout: no path combines them): packed sequences, where a query sees
//     only keys of its own segment id. The Pallas kernel masks elements and
//     skips causal-dead blocks only, so a packed batch of 8 documents
//     (8,760 tokens) pays for 38.4 M causal pairs where 6.2 M are kept.
//     Here the loop runs only over the k tiles that the wrapper's grain
//     summaries allow for this q tile ([first, end), flash_common.cuh) and
//     skips a tile whose id range does not meet the q tile's, so a block
//     visits its own document's tiles (and those a boundary straddles);
//     the range of the tile after next is loaded while the current one
//     is computed, so a step waits on no load. Inside a live tile that
//     holds more than one id each element is masked to -1e30 where its
//     ids differ, after the causal test (:143-146): each lane reads the
//     key ids of its 16 columns once into a bitmask (same_ids) before the
//     products, and a tile of one id reads none (a test per element with
//     its own load took 1.3-1.5x the time on an H100,
//     tools/flash_seg_probe.py).
//     Stages alternate by the count of live tiles, not by tile index. A
//     row that sees no key (a segment with queries and no keys) gets out
//     = 0 and lse = -1e30.
//
// Arithmetic against the Pallas kernel (and flash_fwd_plain): QK^T of bf16
// inputs is exact in fp32, only the order of the sums differs; the Pallas
// kernel scales q before the product and this one scales the fp32 product
// (one fp32 rounding apart). bf16: P is rounded to bf16 for the P V
// product (the TPU's MXU does the same at default precision); the plain
// version keeps P in fp32, so the output differs by about one bf16 ulp of
// out. fp32: every product to fp32 accuracy (3xTF32), P too. Masked
// scores take -1e30, the subtracted max is clamped at -1e25, and a row that
// sees no key gets out = 0 and lse = -1e30, as in the Pallas kernel.
//
// The modes without segment ids (plain, bias, dropout and bias +
// dropout: the ones Llama, Qwen2-MoE, BERT and GPT-2 train with) run the
// wgmma / TMA kernels instead, by mode and shape alone: bf16 the bf16 ones
// of flash_fwd_wgmma.cuh, fp32 at d 64 the TF32 ones of
// flash_fwd_tf32.cuh. launch() routes them there, so this file's kernel is
// instantiated for segment ids alone (bf16 and fp32, d 64 and 128) and
// for every other fp32 mode at d 128 (8 instantiations); a map or launch
// that the wgmma kernels refuse returns its error, with no fall back here.
//
// C interface (bound with ctypes): flash_fwd_launch returns the CUDA launch
// error (0 on success); it never synchronises.

#include "flash_common.cuh"
#include "flash_fwd_tf32.cuh"
#include "flash_fwd_wgmma.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;   // 4 warps x 16 q rows
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <typename T, int D, bool HAS_BIAS, bool DROP, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int sq, int sk,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, float scale, bool causal,
                 const float* __restrict__ bias, int64_t b_sb, int64_t b_sh,
                 int64_t b_sq, int64_t b_sk,
                 const int64_t* __restrict__ seed, uint32_t thresh,
                 float inv_keep, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k,
                 const int4* __restrict__ q_info,
                 const int4* __restrict__ k_info) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = Pitch<T, D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // bf16: two stages of (K, V), the Q tile staged in stage 1's K first;
  // fp32: Q's own tile, then the two stages
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* st0 = kF32 ? sQ + kBQ * LD : sQ;
  T* sK[2] = {st0, st0 + 2 * kBK * LD};
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

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;

  const int kend = causal ? min(sk, q0 + kBQ + off) : sk;   // keys < kend
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

  load_tile_async<kBQ, D, LD, kThreads>(kF32 ? sQ : sK[1], qb + q0 * q_ss,
                                        q_ss, sq - q0);
  cp_async_commit();
  if (jt < j_end) issue(jt, 0);
  int jn = 0;   // SEG: the next live k tile
  if constexpr (SEG) jn = walk.next(jt + 1, rnext);
  if (jt < j_end) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];   // bf16: this warp's Q rows as A fragments
  if constexpr (!kF32) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldsm_x4(qf[ks], a_addr<LD>(sK[1], warp * 16, ks * 16, lane));
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {kNeg, kNeg};   // running max (base-2 scaled scores)
  float l_r[2] = {0.f, 0.f};     // this lane's partial row sums
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* brow[2] = {nullptr, nullptr};   // this lane's bias rows
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias + bi * b_sb + hi * b_sh + (int64_t)row[r] * b_sq;
  }
  int srow[2] = {0, 0};   // SEG: this lane's rows' ids
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r) srow[r] = row[r] < sq ? seg_q[row[r]] : -1;
  }

  for (int it = 0; jt < j_end; ++it) {
    if constexpr (!SEG) jn = jt + 1;
    const int k0 = jt * kBK, st = (SEG ? it : jt) & 1;
    const T* cK = sK[st];
    const T* cV = sV[st];
    __syncthreads();   // stage st ^ 1 (the previous tile, or Q) is consumed
    if (jn < j_end) {
      issue(jn, st ^ 1);   // streams in while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile jt is visible to every warp
    SegRange rpre{};      // SEG: tile jn + 1's range, loaded during this tile
    uint32_t same = ~0u;  // SEG: the elements whose ids are equal
    if constexpr (SEG) {
      if (jn + 1 < j_end) rpre = walk.range(jn + 1);
      if (!walk.uniform(rcur)) same = same_ids<kBK / 8>(seg_k, k0, sk, srow, t);
    }

    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    if constexpr (kF32) {
      nt_product_f32<kBK / 8, D, LD>(s, sQ, warp * 16, cK, lane);
    } else {
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
    }

    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + 2 * t + (i & 1);
        float x;
        if constexpr (HAS_BIAS) {
          x = visible(row[i >> 1], col, sq, sk, off, causal)
                  ? fmaf(s[nt][i], scale_log2,
                         __ldg(brow[i >> 1] + col * b_sk) * kLog2e)
                  : kNeg;
        } else {
          bool vis = visible(row[i >> 1], col, sq, sk, off, causal);
          if constexpr (SEG) vis = vis && same_bit(same, nt, i);
          x = vis ? s[nt][i] * scale_log2 : kNeg;
        }
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
    if constexpr (DROP) {   // l keeps the undropped p; P V the dropped one
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool keep0, keep1;
          drop_keep2(bh, row[r], k0 + nt * 8 + 2 * t, key0, key1, thresh,
                     keep0, keep1);
          s[nt][2 * r] = keep0 ? s[nt][2 * r] * inv_keep : 0.f;
          s[nt][2 * r + 1] = keep1 ? s[nt][2 * r + 1] * inv_keep : 0.f;
        }
      }
    }

    if constexpr (kF32) {
      nn_product_f32<kBK, D, LD>(o, s, cV, lane);
    } else {
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const float l_safe = l == 0.f ? 1.f : l;
    if (row[r] >= sq) continue;
    T* orow = out + (((int64_t)bi * sq + row[r]) * H + hi) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store2(orow + i * 8 + 2 * t, o[i][2 * r] / l_safe,
             o[i][2 * r + 1] / l_safe);
    if (t == 0)
      lse[(int64_t)bh * sq + row[r]] =
          l == 0.f ? kNeg : (m_r[r] + log2f(l)) * kLn2;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* bias, const void* seed, const void* const* seg,
           int b, int h, int sq, int sk, const int64_t* st, float scale,
           int causal, uint32_t thresh, float inv_keep,
           cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  [[maybe_unused]] const flash_wg::Mode md{
      static_cast<const float*>(bias), st[9], st[10], st[11], st[12],
      static_cast<const int64_t*>(seed), thresh, inv_keep};
  if constexpr (kBf16) {   // every mode but segment ids: the wgmma kernel
    if (!seg[0])
      return flash_wg::fwd_launch<D>(q, k, v, out, lse, b, h, sq, sk, st,
                                     scale, causal, md, stream);
  } else if constexpr (D == 64) {   // fp32 at d 64, the same modes: TF32
    if (!seg[0])
      return flash_tf32::fwd_launch(q, k, v, out, lse, b, h, sq, sk, st,
                                    scale, causal, md, stream);
  }
  constexpr int LD = Pitch<T, D>::LD;
  const size_t smem = kBf16 ? sizeof(T) * 4 * kBK * LD
                            : sizeof(T) * (kBQ + 4 * kBK) * LD;
  auto kern = flash_fwd_kernel<T, D, false, false, true>;   // segment ids
  if constexpr (!kBf16 && D != 64) {   // fp32 at d 128, every other mode
    if (!seg[0])
      kern = bias ? (seed ? flash_fwd_kernel<T, D, true, true, false>
                          : flash_fwd_kernel<T, D, true, false, false>)
                  : (seed ? flash_fwd_kernel<T, D, false, true, false>
                          : flash_fwd_kernel<T, D, false, false, false>);
  }
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), h, sq, sk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal != 0,
      static_cast<const float*>(bias), st[9], st[10], st[11], st[12],
      static_cast<const int64_t*>(seed), thresh, inv_keep,
      static_cast<const int*>(seg[0]), static_cast<const int*>(seg[1]),
      static_cast<const int4*>(seg[2]), static_cast<const int4*>(seg[3]));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out are one dtype: dtype 1 bfloat16, 0 float32. Strides are
// in elements, (batch, seq, head) for each of q, k, v; head_dim is
// contiguous. out is contiguous [b, sq, h, d]; lse fp32 [b, h, sq].
// bias is null (no bias) or fp32, element (b, h, q, k) at bias_sb * b +
// bias_sh * h + bias_sq * q + bias_sk * k (a broadcast dimension: stride 0).
// seed is null (no dropout) or a device int64 [2] (seed, offset), the
// Philox key of the keep mask; an element is kept when its word is >=
// thresh, and a kept p is multiplied by inv_keep = 1 / (1 - p_drop).
// seg_q is null (no segment ids) or, with seg_k, contiguous int32 ids [sq]
// and [sk]; q_info and k_info are their int4 grain summaries
// [ceil(sq / kSegGrain)] and [ceil(sk / kSegGrain)] (flash_common.cuh).
// Segment ids take neither a bias nor dropout.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, const void* bias,
                                const void* seed, const void* seg_q,
                                const void* seg_k, const void* q_info,
                                const void* k_info, int64_t b, int64_t h,
                                int64_t sq, int64_t sk, int64_t d,
                                int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                int64_t bias_sb, int64_t bias_sh,
                                int64_t bias_sq, int64_t bias_sk,
                                float scale, int causal, int dtype,
                                uint32_t thresh, float inv_keep,
                                void* stream) {
  if (b * h <= 0 || sq <= 0) return 0;
  if (b * h > 65535 || sq > (1 << 30) || sk < 0 || sk > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (seg_q && (bias || seed)) return (int)cudaErrorInvalidValue;
  const void* const seg[4] = {seg_q, seg_k, q_info, k_info};
  const int64_t st[13] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                          v_sh, bias_sb, bias_sh, bias_sq, bias_sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_LAUNCH(T, D)                                              \
  return launch<T, D>(q, k, v, out, lse, bias, seed, seg, (int)b, (int)h,  \
                      (int)sq, (int)sk, st, scale, causal, thresh, inv_keep, \
                      s)
  if (dtype == 1 && d == 64) FLASH_FWD_LAUNCH(bf16, 64);
  if (dtype == 1 && d == 128) FLASH_FWD_LAUNCH(bf16, 128);
  if (dtype == 0 && d == 64) FLASH_FWD_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) FLASH_FWD_LAUNCH(float, 128);
#undef FLASH_FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
