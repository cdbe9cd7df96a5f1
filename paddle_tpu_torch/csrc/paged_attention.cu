// Paged decode attention for Hopper: one query token per slot attends its
// KV cache through a block table of fixed-size pages.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_decode_kernel /
// paged_attention_tpu in both its modes: fp pools (fp32 or bf16), and
// int8 pools (quant mode: codes [P, ps, kvh, d] with one fp32 absmax
// scale per row in [P, ps, kvh], dequantized inside the page loop).
//
// Bound on the H100: bytes. Each slot's live K and V rows are read once
// (2 * (seq_len + 1) * kvh * d elements, plus 4 bytes of scale per row
// in int8 mode: (d + 4) / (2 d) of the bf16 bytes, 52% at d = 128); the
// arithmetic is 4 operations per KV element pair, far below what the
// card can do per byte moved.
//
// Design: one block of 512 threads (16 warps) per (kv head, slot); the
// g = h / kvh query heads of that kv head share the block, so each K/V
// row is read once for all of them (GQA without repeating the cache).
// Only live positions 0..seq_lens[s] are visited, so dead pages cost
// nothing, and the page holding position seq_lens[s] is live even when
// that position is its first. Inactive slots carry seq_lens = 0 and
// table entries 0: they attend scratch page 0, position 0, and produce
// finite values the engine discards.
//
// Each position costs a chain of dependent steps (table entry, row load,
// the g warp-shuffle reductions), so the block spreads positions over as
// many warps as its registers allow: warp w takes positions w, w + 16,
// ...; a lane loads d/32 consecutive elements of a row in one vector
// load, so a warp reads whole rows, coalesced (int8 at d = 128: 4 codes
// in one 32-bit load, a whole 128-byte row per warp; the row's scale is
// one fp32 that every lane of the warp reads at once, a broadcast). (On
// an H100, 512 threads ran the serving shapes in about half the time of
// 256, and taking several positions per warp at once was slower; see
// PERF.md.)
//
// Arithmetic: the grouped GQA core of nn/functional/attention.py
// (_grouped_decode_attn), not the TPU kernel's. q is rounded to the
// core's dtype, scores accumulate in fp32, the softmax is exp(s - max) /
// sum in fp32, and the probabilities are rounded to the core's dtype
// before the PV product, which accumulates in fp32; the output is
// rounded once to q's dtype. The core's dtype is the cache dtype for fp
// pools and fp32 for int8 pools: the core dequantizes an int8 cache to
// fp32 (code * scale, one fp32 rounding per element), so q and the
// probabilities are not rounded at all. The kernel dequantizes each
// element the same way before its product rather than factoring the
// scale out of the dot product, so it keeps the core's roundings and
// differs only in the order of the sums (4 multiplies per lane and row,
// free at this arithmetic intensity). The engine runs a request's decode
// rows through this kernel on pure-decode steps and through the plain
// core on mixed steps, so matching the core up to summation order keeps
// the two step shapes as close as they can be. Matching its rounding of
// the NORMALISED probabilities needs the softmax's max and sum before
// the first PV product, so the block makes two passes:
//   1. scores: per position, the g dot products reduce by warp shuffles
//      and lane 0 writes the scaled score to a global fp32 scratch
//      [b, kvh, g, M*ps] (live positions only); the block then reduces
//      the max and the sum of exponentials;
//   2. PV: positions are taken in tiles of 64 whose probabilities are
//      staged in shared memory; each warp accumulates p * v for its
//      positions into per-lane registers, and the 16 warps' partial sums
//      are added in shared memory, warp 0 first, in a fixed order.
// K is read in pass 1 and V in pass 2, each once; the scratch adds
// 8 * g bytes per position (written once, read twice), ~6% of the KV
// bytes at d = 128, g = 4 in bf16 (~12% in int8).
//
// C interface (bound with ctypes): paged_decode_launch returns the CUDA
// launch error (0 on success); it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kTile = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float to T's precision and back (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// the dtype the attention core runs in: the cache's, fp32 for int8 codes
template <typename CT> struct Core { using T = CT; };
template <> struct Core<int8_t> { using T = float; };

template <int BYTES> struct VecOf;
template <> struct VecOf<1> { using T = unsigned char; };
template <> struct VecOf<2> { using T = unsigned short; };
template <> struct VecOf<4> { using T = unsigned int; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<16> { using T = uint4; };

// N consecutive elements in one vector load (the wrapper checks that the
// pools are 16-byte aligned; every row offset is a multiple of N).
template <typename CT, int N>
__device__ __forceinline__ void load_row(const CT* p, float (&out)[N]) {
  using V = typename VecOf<N * sizeof(CT)>::T;
  const V raw = *reinterpret_cast<const V*>(p);
  const CT* e = reinterpret_cast<const CT*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

template <typename QT, typename CT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q,          // [b, h, D]
                    const CT* __restrict__ pool_k,     // [P, ps, kvh, D]
                    const CT* __restrict__ pool_v,     // [P, ps, kvh, D]
                    const float* __restrict__ k_scale,  // [P, ps, kvh] (int8)
                    const float* __restrict__ v_scale,  // [P, ps, kvh] (int8)
                    const int32_t* __restrict__ tables,    // [b, M]
                    const int32_t* __restrict__ seq_lens,  // [b]
                    QT* __restrict__ out,              // [b, h, D]
                    float* __restrict__ scores,        // [b, kvh, G, M*ps]
                    int kvh, int G, int ps, int M, float scale) {
  static_assert(D == 32 || D == 64 || D == 128, "unsupported head dim");
  constexpr int kPer = D / 32;              // row elements per lane
  constexpr bool kInt8 = std::is_same<CT, int8_t>::value;
  using RT = typename Core<CT>::T;          // q and p are rounded to RT

  const int n = blockIdx.x;                 // kv head
  const int s = blockIdx.y;                 // slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = kvh * G;
  const int S = M * ps;
  int len = seq_lens[s] + 1;                // positions 0..seq_lens[s]
  len = len < 1 ? 1 : (len > S ? S : len);

  extern __shared__ float smem[];
  float* q_s = smem;                        // [G][D]; pass 2 sums here
  float* p_s = q_s + G * D;                 // [G][kTile]
  float* red = p_s + G * kTile;             // [kWarps][kMaxG]
  float* stat = red + kWarps * kMaxG;       // max [kMaxG], sum [kMaxG]

  for (int i = tid; i < G * D; i += kThreads) {
    const int gi = i / D, dd = i % D;
    q_s[i] = round_to<RT>(to_f(q[((int64_t)s * h + n * G + gi) * D + dd]));
  }
  __syncthreads();

  const int64_t row_stride = (int64_t)kvh * D;
  const int64_t page_stride = (int64_t)ps * row_stride;
  const int32_t* tab = tables + (int64_t)s * M;
  float* sc = scores + ((int64_t)s * kvh + n) * G * S;
  const int64_t head_off = (int64_t)n * D + lane * kPer;

  // ---- pass 1: scores and their max ----
  float m_loc[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) m_loc[gi] = -CUDART_INF_F;
  for (int t = warp; t < len; t += kWarps) {
    float kv[kPer];
    const int64_t page = tab[t / ps];
    load_row<CT, kPer>(pool_k + page * page_stride + (t % ps) * row_stride
                       + head_off, kv);
    if constexpr (kInt8) {
      const float sk = k_scale[(page * ps + t % ps) * kvh + n];
#pragma unroll
      for (int e = 0; e < kPer; ++e) kv[e] *= sk;
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < G) {
        const float* qr = q_s + gi * D + lane * kPer;
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc += qr[e] * kv[e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const float sv = acc * scale;
        if (lane == 0) sc[gi * S + t] = sv;
        m_loc[gi] = fmaxf(m_loc[gi], sv);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) red[warp * kMaxG + gi] = m_loc[gi];
  }
  __syncthreads();   // also publishes pass 1's score writes to the block
  if (tid < G) {
    float m = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w * kMaxG + tid]);
    stat[tid] = m;
  }
  __syncthreads();

  // ---- softmax denominators ----
  float l_loc[kMaxG];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) l_loc[gi] = 0.f;
  for (int t = tid; t < len; t += kThreads) {
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < G) l_loc[gi] += expf(sc[gi * S + t] - stat[gi]);
  }
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < G) {
      float l = l_loc[gi];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      if (lane == 0) red[warp * kMaxG + gi] = l;
    }
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[w * kMaxG + tid];
    stat[kMaxG + tid] = l;
  }

  // ---- pass 2: probabilities (rounded to the core's dtype) times V ----
  float acc[kMaxG][kPer];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[gi][e] = 0.f;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int nt = min(kTile, len - t0);
    __syncthreads();   // the previous tile is consumed; stat is visible
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int gi = i / kTile, j = i % kTile;
      float p = 0.f;
      if (j < nt) {
        p = round_to<RT>(expf(sc[gi * S + t0 + j] - stat[gi])
                         / stat[kMaxG + gi]);
      }
      p_s[i] = p;
    }
    __syncthreads();
    for (int j = warp; j < nt; j += kWarps) {
      const int t = t0 + j;
      float vv[kPer];
      const int64_t page = tab[t / ps];
      load_row<CT, kPer>(pool_v + page * page_stride + (t % ps) * row_stride
                         + head_off, vv);
      if constexpr (kInt8) {
        const float sv = v_scale[(page * ps + t % ps) * kvh + n];
#pragma unroll
        for (int e = 0; e < kPer; ++e) vv[e] *= sv;
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < G) {
          const float p = p_s[gi * kTile + j];
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[gi][e] += p * vv[e];
        }
      }
    }
  }
  // add the warps' partial sums in a fixed order (q_s is free now)
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < G) {
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            float* dst = q_s + gi * D + lane * kPer + e;
            *dst = (w == 0 ? 0.f : *dst) + acc[gi][e];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int gi = i / D, dd = i % D;
    out[((int64_t)s * h + n * G + gi) * D + dd] = from_f<QT>(q_s[i]);
  }
}

template <typename QT, typename CT, int D>
int launch(const void* q, const void* pk, const void* pv, const void* ks,
           const void* vs, const void* tables, const void* seq_lens,
           void* out, void* scores, int b, int kvh, int G, int ps, int M,
           float scale, cudaStream_t stream) {
  const dim3 grid(kvh, b);
  const size_t smem =
      sizeof(float) * (G * D + G * kTile + kWarps * kMaxG + 2 * kMaxG);
  paged_decode_kernel<QT, CT, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(pk),
      static_cast<const CT*>(pv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(seq_lens), static_cast<QT*>(out),
      static_cast<float*>(scores), kvh, G, ps, M, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
int launch_d(int D, const void* q, const void* pk, const void* pv,
             const void* ks, const void* vs, const void* tables,
             const void* seq_lens, void* out, void* scores, int b, int kvh,
             int G, int ps, int M, float scale, cudaStream_t stream) {
  if (D == 128)
    return launch<QT, CT, 128>(q, pk, pv, ks, vs, tables, seq_lens, out,
                               scores, b, kvh, G, ps, M, scale, stream);
  if (D == 64)
    return launch<QT, CT, 64>(q, pk, pv, ks, vs, tables, seq_lens, out,
                              scores, b, kvh, G, ps, M, scale, stream);
  if (D == 32)
    return launch<QT, CT, 32>(q, pk, pv, ks, vs, tables, seq_lens, out,
                              scores, b, kvh, G, ps, M, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only). q/out
// share q_dtype; the two pools share c_dtype (16-byte aligned). c_dtype 2
// needs the fp32 row scales k_scale/v_scale [P, ps, kvh]; the fp modes
// ignore them. D in {32, 64, 128}; 1 <= G <= 16.
extern "C" int paged_decode_launch(const void* q, const void* pool_k,
                                   const void* pool_v, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* seq_lens, void* out,
                                   void* scores, int b, int kvh, int G,
                                   int D, int ps, int M, float scale,
                                   int q_dtype, int c_dtype, void* stream) {
  if (b <= 0) return 0;
  if (G < 1 || G > kMaxG || kvh < 1 || ps < 1 || M < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (c_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_CASE(QC, CC, QT, CT)                                          \
  if (q_dtype == QC && c_dtype == CC)                                       \
    return launch_d<QT, CT>(D, q, pool_k, pool_v, k_scale, v_scale,        \
                            tables, seq_lens, out, scores, b, kvh, G, ps, M, \
                            scale, st);
  PAGED_CASE(0, 0, float, float)
  PAGED_CASE(0, 1, float, __nv_bfloat16)
  PAGED_CASE(1, 0, __nv_bfloat16, float)
  PAGED_CASE(1, 1, __nv_bfloat16, __nv_bfloat16)
  PAGED_CASE(0, 2, float, int8_t)
  PAGED_CASE(1, 2, __nv_bfloat16, int8_t)
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}
