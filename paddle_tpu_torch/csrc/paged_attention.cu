// Paged decode attention for Hopper: one query token per slot attends its
// KV cache through a block table of fixed-size pages.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_decode_kernel /
// paged_attention_tpu in both its modes: fp pools (fp32 or bf16), and
// int8 pools (quant mode: codes [P, ps, kvh, d] with one fp32 absmax
// scale per row in [P, ps, kvh], dequantized per element).
//
// Bound on the H100: bytes. Each slot's live K and V rows are read once
// (2 * (seq_len + 1) * kvh * d elements, plus 4 bytes of scale per row
// in int8 mode: (d + 4) / (2 d) of the bf16 bytes, 52% at d = 128); the
// arithmetic is 4 operations per KV element pair, far below what the
// card can do per byte moved. At decode sizes (a few MB) what sets the
// time is how many rows are in flight at once and how few dependent
// steps lie between the launch and the last store.
//
// Design: each (kv head, slot) context is cut into chunks of T tiles of
// kTile = 64 positions, independent of page boundaries; T (1, 2, 4 or 8)
// is the host's, from shapes alone (the fewest tiles that keep the chunk
// count near 1024; 1 at serving sizes), and seq_lens is never read back.
// The chunks are items of work in ONE launch of 2 * items blocks
// (items = b * kvh * ceil(M * ps / (64 T))) of NT threads: 256 for
// one-tile chunks, whose items are short chains where more threads
// shorten each step; 128 for longer ones, where five blocks an SM keep
// more rows in flight than four of 256 (both measured on the H100). A
// block takes its item by an atomic ticket, not by blockIdx (pair-major
// inside a range):
//   tickets [0, items)         score items: stream the chunk's K tiles,
//                              write the scaled scores to scratch and
//                              publish the chunk's max and sum of
//                              exp(s - chunk max) with a release flag;
//   tickets [items, 2 * items) PV items: request the chunk's first V
//                              tiles (V streams while the scores finish),
//                              wait on the pair's score flags, combine
//                              the chunks' statistics into the context's
//                              max and sum, stream V and compute the
//                              chunk's fp32 partial [G, d]. The pair's
//                              last live chunk waits on the others'
//                              partials (a release flag each), adds them
//                              in chunk order, its own last, and writes
//                              the output; the others publish theirs.
// Every wait is on a lower ticket (a PV item on score items, the last
// chunk's PV item on its pair's other PV items), whose block is resident
// or done, so no wait can deadlock whatever the scheduler does. A chunk
// past its slot's live length exits at once. A pair whose context fits
// one chunk (a "whole" pair) is done by its score item alone: K, scores,
// statistics, then V into the same buffers, the PV product and the
// output; its PV item exits at once.
// Inside an item: the chunk's table entries are read once (beside
// seq_lens: both are known from shapes) into shared memory; tiles stream
// through a ring of two buffers, each tile's live rows requested at once
// as 16-byte cp.async pieces (int8 scales as 4-byte ones), the next tile
// in flight while one is used; q is read while the first K tile is in
// flight. Rows sit 16 bytes past a multiple of 32 apart, so the 16-byte
// reads of 8 neighbouring lanes fall on 8 different bank groups. Scores:
// thread (position, part) dots its part of the K row (a half with 128
// threads, a quarter with 256, whole 16-byte pieces) with every query
// head from shared memory (q broadcast), shuffles join the parts; a
// chunk's statistics over its tiles are a running max and a sum
// rescaled to it, tile by tile. PV: the probabilities sit [position]
// [head], so thread (head group, column) reads a pass's four heads in
// one 16-byte load while it walks the positions in order. Int8 codes
// become floats by a byte permute and one add (2^23 + 128 trick), not
// the quarter-rate integer conversion.
// The workspace, per device and stream (the wrapper's): a control part
// (the ticket, and two flags per item: statistics, partial) that every
// call leaves zeroed, and a data part (statistics, scores, partials)
// that needs no reset. The block that draws the last ticket resets the
// ticket; a pair's last PV item resets the pair's flags; no memset
// launch. A flag not set within ~10 s traps, as does a ticket past the
// last item (one a faulty call left set).
//
// Arithmetic: the grouped GQA core of nn/functional/attention.py
// (_grouped_decode_attn), not the TPU kernel's. q is rounded to the
// core's dtype, scores accumulate in fp32, the softmax is exp(s - max) /
// sum in fp32 with the max and the sum of the whole context known before
// the first PV product, and the probabilities are rounded to the core's
// dtype before the PV product, which accumulates in fp32; the output is
// rounded once to q's dtype. The core's dtype is the cache dtype for fp
// pools and fp32 for int8 pools: the core dequantizes an int8 cache to
// fp32 (code * scale, one fp32 rounding per element), so q and the
// probabilities are not rounded at all; the kernel dequantizes each
// element the same way before its product. The context's sum is the
// chunks' sums each scaled by exp(chunk max - max), added in a fixed
// order (not flash-decoding's rescale of unnormalised partials, which
// would round p differently for a bf16 cache). The engine runs a
// request's decode rows through this kernel on pure-decode steps and
// through the plain core on mixed steps, so matching the core up to
// summation order keeps the two step shapes as close as they can be.
// Every sum runs in an order fixed by the inputs (the chunk statistics
// by a fixed shuffle tree, the partials in chunk order), never in arrival
// order, and there are no float atomics: two launches on the same inputs
// agree bitwise.
//
// C interface (bound with ctypes): paged_decode_launch returns the CUDA
// launch error (0 on success); it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxG = 16;
constexpr int kTile = 64;                 // positions a tile
constexpr int kMaxTiles = 8;              // tiles a chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// an int8 code as a float: 2^23 + (code + 128) built in the mantissa,
// less 2^23 + 128 (exact)
__device__ __forceinline__ float to_f(int8_t v) {
  return __uint_as_float(0x4B000000u | (unsigned)(uint8_t)(v ^ 0x80))
         - 8388736.f;
}

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

// The workspace. Control (zero between calls): ctrl[0] the ticket, then
// per item a flag for its statistics and one for its partial. Data: the
// chunks' statistics [pair][G][nch] (max, sum), the scores [item][G][64
// T] and the partials [item][G][D], all fp32.
struct Work {
  unsigned* ctrl;
  unsigned* flag;
  unsigned* done;
  float2* stats;
  float* scores;
  float* part;
};

size_t ctrl_bytes(int64_t items) { return 4 * (4 + 2 * items); }

size_t data_bytes(int64_t items, int G, int D, int T) {
  return 4 * items * G * (2 + kTile * T + D);
}

Work carve(void* ctrl, void* data, int64_t items, int G, int T) {
  Work w;
  w.ctrl = static_cast<unsigned*>(ctrl);
  w.flag = w.ctrl + 4;
  w.done = w.flag + items;
  float* f = static_cast<float*>(data);
  w.stats = reinterpret_cast<float2*>(f);
  w.scores = f + 2 * items * G;
  w.part = w.scores + items * G * kTile * T;
  return w;
}

template <typename QT, typename CT>
struct Args {
  const QT* q;            // [b, h, D]
  const CT* pk;           // [P, ps, kvh, D]
  const CT* pv;           // [P, ps, kvh, D]
  const float* ks;        // [P, ps, kvh] (int8)
  const float* vs;        // [P, ps, kvh] (int8)
  const int32_t* tables;  // [b, M]
  const int32_t* seq_lens;  // [b]
  QT* out;                // [b, h, D]
  Work w;
  int b, kvh, G, ps, M, nch, tiles;
  float scale;
};

// A tile's rows in shared memory: kStride bytes apart, 16 past a
// multiple of 32.
template <typename CT, int D>
struct Rows {
  static constexpr int kRow = D * (int)sizeof(CT);   // bytes of a row
  static constexpr int kStride = kRow + 16;
  static constexpr int kPieces = kRow / 16;          // cp.async pieces a row
  static constexpr int kBuf = kTile * kStride;       // bytes of a tile
};

// Shared memory of a block, in bytes from the start: the chunk's pool
// rows (int64), the ring's row scales (int8), the heads' statistics, a
// tile's scores or probabilities [GM][kTile], q [G][D], the ring.
template <typename CT, int D, int GM>
struct Layout {
  int rows, rsc, st, sp, qs, kv, bytes;
  __host__ __device__ Layout(int G, int T) {
    rows = 0;
    rsc = rows + 8 * kTile * T;
    st = rsc + 4 * 2 * kTile;
    sp = st + 4 * 2 * kMaxG;
    qs = sp + 4 * GM * kTile;
    kv = qs + ((4 * G * D + 15) & ~15);
    bytes = kv + (T > 1 ? 2 : 1) * Rows<CT, D>::kBuf;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// Wait until an item has published (its statistics or its partial);
// trap after ~10 s (a flag that never comes is a fault, not a wait).
__device__ __forceinline__ void wait_published(const unsigned* f) {
  const long long t0 = clock64();
  while (ld_acquire(f) != 1u) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Request tile `tt` of the chunk (positions 64 tt .. of the chunk's nt
// live ones) of `pool` and, int8, its row scales into ring buffer `buf`;
// one commit group.
template <typename CT, int D, int NT>
__device__ __forceinline__ void request_tile(
    const CT* pool, const float* scales, const int64_t* rows, int tt,
    int nt, int kvh, int n, unsigned char* kv, float* rsc) {
  using R = Rows<CT, D>;
  const int ntt = min(kTile, nt - tt * kTile);
  const int64_t* tr = rows + tt * kTile;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(pool);
  for (int p = threadIdx.x; p < ntt * R::kPieces; p += NT) {
    const int j = p / R::kPieces, e = p - j * R::kPieces;
    cp_async16(kv + j * R::kStride + e * 16,
               base + (tr[j] * kvh + n) * R::kRow + e * 16);
  }
  if constexpr (std::is_same<CT, int8_t>::value) {
    for (int j = threadIdx.x; j < ntt; j += NT)
      cp_async4(rsc + j, scales + tr[j] * kvh + n);
  }
  cp_async_commit();
}

// The row elements of a 16-byte piece as floats (int8: 16 codes, each
// by a byte permute and one add, xor 0x80 having made it unsigned).
template <typename CT>
__device__ __forceinline__ void piece(const uint4& raw,
                                      float (&k)[16 / sizeof(CT)]) {
  const CT* el = reinterpret_cast<const CT*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(CT)); ++i) k[i] = to_f(el[i]);
}

template <>
__device__ __forceinline__ void piece<int8_t>(const uint4& raw,
                                              float (&k)[16]) {
  const unsigned w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    k[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4B000000u,
                                       0x7540u | (i & 3))) - 8388736.f;
}

// Scores of one tile: thread (position j, part h) dots part h of K row j
// (kSplit parts of whole 16-byte pieces: quarters, or halves of a
// 32-byte row; int8: each element dequantized by the row's scale first,
// as the core does) with each head's q, four heads a pass; shuffles add
// the parts. Writes sp[g][j] and, unless sc is null, the scratch scores
// sc[g * cstride + j].
template <typename CT, int D, int NT>
__device__ __forceinline__ void tile_scores(const unsigned char* kv,
                                            const float* rsc,
                                            const float* qs, float* sp,
                                            float* sc, int cstride, int ntt,
                                            int G, float scale) {
  using R = Rows<CT, D>;
  constexpr int kVec = 16 / (int)sizeof(CT);
  constexpr int kSplit = R::kPieces < NT / kTile ? R::kPieces : NT / kTile;
  constexpr int kPer = 32 / kSplit;         // positions a warp
  constexpr int kPart = D / kSplit;         // elements a thread
  const int lane = threadIdx.x & 31;
  const int j = (threadIdx.x >> 5) * kPer + lane % kPer, h = lane / kPer;
  const bool live = j < ntt;
  const unsigned char* kr = kv + j * R::kStride + h * kPart * sizeof(CT);
  const float* qh = qs + h * kPart;
  float rs = 1.f;
  if constexpr (std::is_same<CT, int8_t>::value) rs = live ? rsc[j] : 0.f;
  for (int g0 = 0; g0 < G; g0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
#pragma unroll
      for (int e0 = 0; e0 < kPart; e0 += kVec) {
        float k[kVec];
        piece<CT>(*reinterpret_cast<const uint4*>(kr + e0 * sizeof(CT)), k);
        if constexpr (std::is_same<CT, int8_t>::value) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) k[i] *= rs;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (g0 + u < G) {
            const float* qr = qh + (g0 + u) * D + e0;
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[u] += qr[i] * k[i];
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o >= kPer; o >>= 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    }
    if (live && h == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = g0 + u;
        if (g < G) {
          const float sv = acc[u] * scale;
          sp[g * kTile + j] = sv;
          if (sc) sc[g * cstride + j] = sv;
        }
      }
    }
  }
}

// p V over one tile's positions, in order, into acc: thread (head group,
// column d) holds column d of heads (tid / D) NA .. + NA - 1, up to four
// heads a pass over the rows (passes past the last head are skipped);
// the probabilities sit [position][GM], a pass's heads side by side
template <typename CT, int D, int GM, int NA>
__device__ __forceinline__ void pv_product(const unsigned char* kv,
                                           const float* rsc, const float* sp,
                                           int ntt, int G, float (&acc)[NA]) {
  using R = Rows<CT, D>;
  constexpr int kPass = NA < 4 ? NA : 4;
  static_assert(NA % kPass == 0, "heads in passes");
  const int d = threadIdx.x % D, h0 = (threadIdx.x / D) * NA;
#pragma unroll
  for (int a0 = 0; a0 < NA; a0 += kPass) {
    if (h0 + a0 < G) {
#pragma unroll 4
      for (int j = 0; j < ntt; ++j) {
        float v = to_f(*reinterpret_cast<const CT*>(kv + j * R::kStride
                                                    + d * sizeof(CT)));
        if constexpr (std::is_same<CT, int8_t>::value) v *= rsc[j];
        const float* p = sp + j * GM + h0 + a0;
        if constexpr (kPass == 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(p);
          acc[a0] += p4.x * v;
          acc[a0 + 1] += p4.y * v;
          acc[a0 + 2] += p4.z * v;
          acc[a0 + 3] += p4.w * v;
        } else if constexpr (kPass == 2) {
          const float2 p2 = *reinterpret_cast<const float2*>(p);
          acc[a0] += p2.x * v;
          acc[a0 + 1] += p2.y * v;
        } else {
          acc[a0] += p[0] * v;
        }
      }
    }
  }
}

// The chunk's scores, tile by tile through the ring (tiles 0 and 1
// requested here), each written to sp and the scratch `sc` (null: sp
// only, for a one-tile whole chunk), and the chunk's statistics per head
// into st_m, st_l: a running max and the sum of exp(s - max) rescaled to
// it tile by tile. With `then_v`, the chunk's first V tiles are requested
// into the ring as soon as the last K tile is used.
template <typename QT, typename CT, int D, int NT>
__device__ __forceinline__ void score_pass(
    const Args<QT, CT>& a, const int64_t* rows, int nt, int n,
    const QT* q, unsigned char* kv, float* rsc, float* qs, float* sp,
    float* sc, float* st_m, float* st_l, bool then_v) {
  using R = Rows<CT, D>;
  using RT = typename Core<CT>::T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, ntiles = (nt + kTile - 1) / kTile;
  request_tile<CT, D, NT>(a.pk, a.ks, rows, 0, nt, a.kvh, n, kv, rsc);
  if (ntiles > 1)
    request_tile<CT, D, NT>(a.pk, a.ks, rows, 1, nt, a.kvh, n,
                            kv + R::kBuf, rsc + kTile);
  // q [G][D], rounded to the core's dtype, while K is in flight
  for (int i = tid; i < G * D; i += NT)
    qs[i] = round_to<RT>(to_f(q[i]));
  if (tid < G) {
    st_m[tid] = -CUDART_INF_F;
    st_l[tid] = 0.f;
  }
  for (int tt = 0; tt < ntiles; ++tt) {
    const int buf = tt & 1, ntt = min(kTile, nt - tt * kTile);
    if (tt + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    tile_scores<CT, D, NT>(kv + buf * R::kBuf, rsc + buf * kTile, qs, sp,
                           sc ? sc + tt * kTile : nullptr, kTile * a.tiles,
                           ntt, G, a.scale);
    __syncthreads();                        // the tile's K is used
    if (tt + 2 < ntiles)
      request_tile<CT, D, NT>(a.pk, a.ks, rows, tt + 2, nt, a.kvh, n,
                              kv + buf * R::kBuf, rsc + buf * kTile);
    else if (then_v && tt == ntiles - 1) {
      request_tile<CT, D, NT>(a.pv, a.vs, rows, 0, nt, a.kvh, n, kv, rsc);
      if (ntiles > 1)
        request_tile<CT, D, NT>(a.pv, a.vs, rows, 1, nt, a.kvh, n,
                                kv + R::kBuf, rsc + kTile);
    }
    for (int g = warp; g < G; g += NT / 32) {
      const float s0 = lane < ntt ? sp[g * kTile + lane] : -CUDART_INF_F;
      const float s1 = lane + 32 < ntt ? sp[g * kTile + lane + 32]
                                       : -CUDART_INF_F;
      const float m = warp_max(fmaxf(s0, s1));
      const float e = warp_sum((lane < ntt ? expf(s0 - m) : 0.f)
                               + (lane + 32 < ntt ? expf(s1 - m) : 0.f));
      if (lane == 0) {
        const float m_new = fmaxf(st_m[g], m);
        st_l[g] = st_l[g] * expf(st_m[g] - m_new) + e * expf(m - m_new);
        st_m[g] = m_new;
      }
    }
  }
  __syncthreads();
}

// Tile tt's scratch scores (of the chunk's nt live positions) into v:
// thread tid holds (head, position) tid, tid + NT, ... of the
// tile's [GM][kTile].
template <int GM, int NT>
__device__ __forceinline__ void load_scores(
    const float* sc, int cstride, int tt, int nt, int G,
    float (&v)[(GM * kTile + NT - 1) / NT]) {
  const int ntt = min(kTile, nt - tt * kTile);
#pragma unroll
  for (int k = 0; k < (GM * kTile + NT - 1) / NT; ++k) {
    const int i = threadIdx.x + k * NT, g = i / kTile, j = i % kTile;
    v[k] = g < G && j < ntt ? __ldcg(sc + g * cstride + tt * kTile + j)
                            : 0.f;
  }
}

// p V over the chunk's tiles through the ring (its first V tiles already
// requested) into acc, given the context's max and sum in st_m, st_l.
// Each tile's probabilities come from its scores: tile 0's in `cur`
// (the caller's), each next tile's loaded from the scratch scores `sc`
// while this one is used. p goes to sp as [position][GM].
template <typename QT, typename CT, int D, int GM, int NT, int NA>
__device__ __forceinline__ void pv_pass(
    const Args<QT, CT>& a, const int64_t* rows, int nt, int n,
    unsigned char* kv, float* rsc, float* sp, const float* sc,
    const float* st_m, const float* st_l,
    float (&cur)[(GM * kTile + NT - 1) / NT], float (&acc)[NA]) {
  using R = Rows<CT, D>;
  using RT = typename Core<CT>::T;
  constexpr int kSc = (GM * kTile + NT - 1) / NT;
  const int tid = threadIdx.x, G = a.G, cstride = kTile * a.tiles;
  const int ntiles = (nt + kTile - 1) / kTile;
  float nxt[kSc] = {};
#pragma unroll
  for (int k = 0; k < NA; ++k) acc[k] = 0.f;
  for (int tt = 0; tt < ntiles; ++tt) {
    const int buf = tt & 1, ntt = min(kTile, nt - tt * kTile);
    if (tt + 1 < ntiles)
      load_scores<GM, NT>(sc, cstride, tt + 1, nt, G, nxt);
#pragma unroll
    for (int k = 0; k < kSc; ++k) {
      const int i = tid + k * NT, g = i / kTile, j = i % kTile;
      if (i < GM * kTile)
        sp[j * GM + g] = g < G && j < ntt
            ? round_to<RT>(expf(cur[k] - st_m[g]) / st_l[g]) : 0.f;
    }
    if (tt + 1 < ntiles) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    pv_product<CT, D, GM>(kv + buf * R::kBuf, rsc + buf * kTile, sp, ntt, G,
                          acc);
    __syncthreads();                        // the tile's V and p are used
    if (tt + 2 < ntiles)
      request_tile<CT, D, NT>(a.pv, a.vs, rows, tt + 2, nt, a.kvh, n,
                              kv + buf * R::kBuf, rsc + buf * kTile);
#pragma unroll
    for (int k = 0; k < kSc; ++k) cur[k] = nxt[k];
  }
}

// Where an item lies: its ticket's range (score or PV), the chunk and
// its (slot, kv head) pair, pair-major (a pair's chunks draw together,
// so its PV items find its statistics early).
struct Item {
  bool pv;
  int item, pair, c, s, n;
  __device__ __forceinline__ Item(unsigned ticket, unsigned items, int nch,
                                  int kvh) {
    pv = ticket >= items;
    item = (int)(pv ? ticket - items : ticket);
    pair = item / nch;
    c = item - pair * nch;
    s = pair / kvh;
    n = pair - s * kvh;
  }
};

// GM: the most query heads a kv head the instantiation takes (4 or 16)
template <typename QT, typename CT, int D, int GM, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
paged_decode_kernel(const Args<QT, CT> a) {
  constexpr int kThreads = NT, kWarps = NT / 32;
  constexpr int kGroups = kThreads / D;
  constexpr int kAcc = GM / kGroups > 0 ? GM / kGroups : 1;
  constexpr int kSc = (GM * kTile + kThreads - 1) / kThreads;
  const int h0 = (threadIdx.x / D) * kAcc;  // this thread's first head
  const Layout<CT, D, GM> lo(a.G, a.tiles);
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* rows = reinterpret_cast<int64_t*>(smem + lo.rows);
  float* rsc = reinterpret_cast<float*>(smem + lo.rsc);
  float* st_m = reinterpret_cast<float*>(smem + lo.st);
  float* st_l = st_m + kMaxG;
  float* sp = reinterpret_cast<float*>(smem + lo.sp);
  float* qs = reinterpret_cast<float*>(smem + lo.qs);
  unsigned char* kv = smem + lo.kv;
  __shared__ unsigned s_ticket;

  const Work& w = a.w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, nch = a.nch, chunk = kTile * a.tiles;
  const unsigned items = (unsigned)(a.b * a.kvh * nch);
  if (tid == 0) {
    const unsigned t = atomicAdd(&w.ctrl[0], 1u);
    if (t == 2u * items - 1u) atomicExch(&w.ctrl[0], 0u);  // the last one
    s_ticket = t;
  }
  __syncthreads();
  const unsigned ticket = s_ticket;
  if (ticket >= 2u * items) __trap();      // a ticket a faulty call left set
  const Item it(ticket, items, nch, a.kvh);
  const int pair = it.pair, c = it.c, n = it.n, item = it.item;
  const int S = a.M * a.ps, t0 = c * chunk;
  // the chunk's pool rows, read beside seq_lens (both known from shapes;
  // an entry is used only where its position is live)
  for (int i = tid; i < chunk; i += kThreads) {
    const int t = t0 + i;
    rows[i] = t < S ? (int64_t)a.tables[(int64_t)it.s * a.M + t / a.ps]
                      * a.ps + t % a.ps : 0;
  }
  int len = a.seq_lens[it.s] + 1;           // positions 0..seq_lens[s]
  len = len < 1 ? 1 : (len > S ? S : len);
  __syncthreads();
  const int nt = min(chunk, len - t0);      // live positions of the chunk
  const int nlive = (len + chunk - 1) / chunk;
  const bool whole = nlive == 1;
  if (nt <= 0 || (it.pv && whole)) return;

  const int64_t q0 = ((int64_t)it.s * a.kvh * G + (int64_t)n * G) * D;
  float* sc = w.scores + (int64_t)item * G * chunk;
  float acc[kAcc];
  float cur[kSc];
  if (!it.pv) {
    // ---- score item: K tiles, scores, the chunk's statistics ----
    const bool one_tile = whole && nt <= kTile;
    score_pass<QT, CT, D, NT>(a, rows, nt, n, a.q + q0, kv, rsc, qs, sp,
                              one_tile ? nullptr : sc, st_m, st_l, whole);
    if (!whole) {
      if (tid < G)
        w.stats[((int64_t)pair * G + tid) * nch + c] =
            make_float2(st_m[tid], st_l[tid]);
      __syncthreads();                     // the block's writes, then one
      if (tid == 0) st_release(&w.flag[item], 1u);  // release (cumulative)
      return;
    }
    // a whole pair: the context is this chunk (its one tile's scores
    // still in sp as [head][position])
    if (one_tile) {
#pragma unroll
      for (int k = 0; k < kSc; ++k) {
        const int i = tid + k * kThreads;
        cur[k] = i < GM * kTile && i / kTile < G ? sp[i] : 0.f;
      }
      __syncthreads();
    } else {
      load_scores<GM, NT>(sc, chunk, 0, nt, G, cur);
    }
    pv_pass<QT, CT, D, GM, NT>(a, rows, nt, n, kv, rsc, sp, sc, st_m, st_l,
                               cur, acc);
#pragma unroll
    for (int a_ = 0; a_ < kAcc; ++a_) {
      const int g = h0 + a_;
      if (g < G) a.out[q0 + g * D + tid % D] = from_f<QT>(acc[a_]);
    }
    return;
  }

  // ---- PV item: the first V tiles, then the pair's statistics ----
  request_tile<CT, D, NT>(a.pv, a.vs, rows, 0, nt, a.kvh, n, kv, rsc);
  if (nt > kTile)
    request_tile<CT, D, NT>(a.pv, a.vs, rows, 1, nt, a.kvh, n,
                            kv + Rows<CT, D>::kBuf, rsc + kTile);
  const int64_t first = (int64_t)pair * nch;
  for (int i = tid; i < nlive; i += kThreads)
    wait_published(&w.flag[first + i]);
  __syncthreads();
  // the chunk's first scores, in flight beside the statistics
  load_scores<GM, NT>(sc, chunk, 0, nt, G, cur);
  // the context's max and sum: the chunks' statistics in a fixed order
  // (lane i holds chunks i, i + 32, ...; then a fixed shuffle tree)
  for (int g = warp; g < G; g += kWarps) {
    const float2* st = w.stats + ((int64_t)pair * G + g) * nch;
    float2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < nlive ? __ldcg(&st[i]) : make_float2(-CUDART_INF_F, 0.f);
    }
    float m = fmaxf(fmaxf(v[0].x, v[1].x), fmaxf(v[2].x, v[3].x));
    for (int i = lane + 128; i < nlive; i += 32)
      m = fmaxf(m, __ldcg(&st[i]).x);
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < nlive) l += v[k].y * expf(v[k].x - m);
    for (int i = lane + 128; i < nlive; i += 32) {
      const float2 u = __ldcg(&st[i]);
      l += u.y * expf(u.x - m);
    }
    l = warp_sum(l);
    if (lane == 0) {
      st_m[g] = m;
      st_l[g] = l;
    }
  }
  __syncthreads();
  pv_pass<QT, CT, D, GM, NT>(a, rows, nt, n, kv, rsc, sp, sc, st_m, st_l,
                             cur, acc);
  if (c != nlive - 1) {
    // a partial: written, then published with one release
    float* part = w.part + (int64_t)item * G * D;
#pragma unroll
    for (int a_ = 0; a_ < kAcc; ++a_) {
      const int g = h0 + a_;
      if (g < G) part[g * D + tid % D] = acc[a_];
    }
    __syncthreads();
    if (tid == 0) st_release(&w.done[item], 1u);
    return;
  }
  // the pair's last chunk (its highest ticket): wait on the others'
  // partials, add them in chunk order, its own last, write the output
  for (int i = tid; i < nlive - 1; i += kThreads)
    wait_published(&w.done[first + i]);
  __syncthreads();
  const float* p0 = w.part + first * G * D;
  float tot[kAcc];
#pragma unroll
  for (int a_ = 0; a_ < kAcc; ++a_) {
    const int g = h0 + a_;
    tot[a_] = g < G ? __ldcg(p0 + g * D + tid % D) : 0.f;
  }
#pragma unroll 4
  for (int i = 1; i < nlive - 1; ++i) {
    const float* pi = p0 + (int64_t)i * G * D;
#pragma unroll
    for (int a_ = 0; a_ < kAcc; ++a_) {
      const int g = h0 + a_;
      if (g < G) tot[a_] += __ldcg(pi + g * D + tid % D);
    }
  }
#pragma unroll
  for (int a_ = 0; a_ < kAcc; ++a_) {
    const int g = h0 + a_;
    if (g < G) a.out[q0 + g * D + tid % D] = from_f<QT>(tot[a_] + acc[a_]);
  }
  // the pair's control words, zero for the next call: every other item
  // of the pair has read its flags before it published its partial
  for (int i = tid; i < nlive; i += kThreads) {
    w.flag[first + i] = 0u;
    w.done[first + i] = 0u;
  }
}

template <typename QT, typename CT, int D, int GM, int NT>
int launch_g(const Args<QT, CT>& a, int64_t items, cudaStream_t stream) {
  const int bytes = Layout<CT, D, GM>(a.G, a.tiles).bytes;
  static int opted = 48 * 1024;             // dynamic shared memory allowed
  if (bytes > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<QT, CT, D, GM, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  paged_decode_kernel<QT, CT, D, GM, NT>
      <<<(unsigned)(2 * items), NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// four heads a kv head or fewer (every GQA model the port serves) take
// the instantiation with four accumulators a thread, not sixteen
template <typename QT, typename CT, int D>
int launch(const Args<QT, CT>& a, int64_t items, cudaStream_t stream) {
  if (a.tiles == 1)
    return a.G <= 4 ? launch_g<QT, CT, D, 4, 256>(a, items, stream)
                    : launch_g<QT, CT, D, kMaxG, 256>(a, items, stream);
  return a.G <= 4 ? launch_g<QT, CT, D, 4, 128>(a, items, stream)
                  : launch_g<QT, CT, D, kMaxG, 128>(a, items, stream);
}

template <typename QT, typename CT>
int launch_d(int D, const void* q, const void* pk, const void* pv,
             const void* ks, const void* vs, const void* tables,
             const void* seq_lens, void* out, const Work& w, int b, int kvh,
             int G, int ps, int M, int nch, int T, float scale,
             cudaStream_t stream) {
  const Args<QT, CT> a{static_cast<const QT*>(q), static_cast<const CT*>(pk),
                       static_cast<const CT*>(pv),
                       static_cast<const float*>(ks),
                       static_cast<const float*>(vs),
                       static_cast<const int32_t*>(tables),
                       static_cast<const int32_t*>(seq_lens),
                       static_cast<QT*>(out), w, b, kvh, G, ps, M, nch, T,
                       scale};
  const int64_t items = (int64_t)b * kvh * nch;
  if (D == 128) return launch<QT, CT, 128>(a, items, stream);
  if (D == 64) return launch<QT, CT, 64>(a, items, stream);
  if (D == 32) return launch<QT, CT, 32>(a, items, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only). q/out
// share q_dtype; the two pools share c_dtype (16-byte aligned). c_dtype 2
// needs the fp32 row scales k_scale/v_scale [P, ps, kvh]; the fp modes
// ignore them. D in {32, 64, 128}; 1 <= G <= 16. A chunk is `tiles`
// (1, 2, 4 or 8) tiles of `tile` positions (the wrapper's; `tile` must be
// this source's); `ctrl` (zeroed before its first call, left zeroed by
// every call) and `data` are the workspace, at least as large as the
// wrapper's workspace_bytes say.
extern "C" int paged_decode_launch(const void* q, const void* pool_k,
                                   const void* pool_v, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* seq_lens, void* out,
                                   void* ctrl, size_t ctrl_size, void* data,
                                   size_t data_size, int b, int kvh, int G,
                                   int D, int ps, int M, int tile, int tiles,
                                   float scale, int q_dtype, int c_dtype,
                                   void* stream) {
  if (b <= 0) return 0;
  if (G < 1 || G > kMaxG || kvh < 1 || ps < 1 || M < 1 || b > 65535 ||
      tile != kTile || tiles < 1 || tiles > kMaxTiles ||
      (tiles & (tiles - 1)) || ctrl == nullptr || data == nullptr)
    return (int)cudaErrorInvalidValue;
  if (c_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t nch = ((int64_t)M * ps + kTile * tiles - 1) / (kTile * tiles);
  const int64_t pairs = (int64_t)b * kvh, items = pairs * nch;
  if (2 * items > INT_MAX || ctrl_size < ctrl_bytes(items) ||
      data_size < data_bytes(items, G, D, tiles))
    return (int)cudaErrorInvalidValue;
  const Work w = carve(ctrl, data, items, G, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_CASE(QC, CC, QT, CT)                                          \
  if (q_dtype == QC && c_dtype == CC)                                       \
    return launch_d<QT, CT>(D, q, pool_k, pool_v, k_scale, v_scale, tables, \
                            seq_lens, out, w, b, kvh, G, ps, M, (int)nch,  \
                            tiles, scale, st);
  PAGED_CASE(0, 0, float, float)
  PAGED_CASE(0, 1, float, __nv_bfloat16)
  PAGED_CASE(1, 0, __nv_bfloat16, float)
  PAGED_CASE(1, 1, __nv_bfloat16, __nv_bfloat16)
  PAGED_CASE(0, 2, float, int8_t)
  PAGED_CASE(1, 2, __nv_bfloat16, int8_t)
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}
