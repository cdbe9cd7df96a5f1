// Fused top-2 MoE routing: the port of paddle_tpu/ops/pallas/moe_routing.py
// (_routing_kernel, its pallas_call at :147), the routing front-end of the
// fused grouped-GEMM dispatch.
//
// What it computes, per token t of logits [T, E] (fp32):
//   softmax (max, exp, sum, divide, as the Pallas body); g1i = the first
//   index of the largest probability, g2i = the first index of the largest
//   of the probabilities with g1i's set to 0; g1, g2 those probabilities;
//   keep2 = u[t] < 2 g2 / max(g1 + g2, 1e-9) from passed-in uniforms (or 1);
//   p1 = the number of earlier tokens whose top-1 expert is g1i; c2 = the
//   number of earlier tokens with a kept second claim on g2i (0 if not
//   kept); per expert count1 = the number of top-1 claims and me_sum = the
//   sum of the probabilities over all tokens.
// The positions are a scan over all T tokens in token order: the Pallas
// grid is sequential and carries the running counts across its 1024-token
// blocks in scratch.
//
// What bounds it on the H100: nothing the card is good at. It reads ~T*E*4
// + T*4 bytes and writes ~T*28 (0.8 MB at T 8192, E 16: ~0.24 us at 3.35
// TB/s); the positions are a scan, so what sets the time is how few
// dependent steps lie between the first load and the last store. Design:
// one launch of T / 256 blocks of 256 threads, thread i of a block owning
// token i of its tile:
//   A. softmax, top-2 and keep2 in registers, reading its logits row (L1
//      holds it across the passes); the tile's per-expert probability sums
//      by warp shuffles, then the 8 warps in order;
//   B. per warp, each token's rank among the warp's claims on its expert
//      (__match_any_sync) and the warp's count per expert; thread e scans
//      the 8 warps' counts for expert e: the start of each warp's claims in
//      the tile, and the tile's counts;
//   C. the tile's counts and probability sums go to the workspace with a
//      ready flag; the block waits for its predecessors' flags and sums
//      their counts (integer sums: exact in any order) into the tile's
//      offsets; position = offset + warp start + rank;
//   D. the last block to finish sums the tiles' probability sums in a
//      fixed order (me_sum) and resets the workspace for the next call.
// Tiles are handed out by an atomic ticket, not by blockIdx: a block waits
// only on tiles ticketed before its own, whose blocks are resident or done,
// so the waits cannot deadlock whatever the scheduler does. No float
// atomics: a second launch is bitwise equal to the first. The workspace
// (Work, ~385 KB) is the wrapper's, zeroed once and one a device and stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 256;                  // tokens a tile = threads a block
constexpr int kWarps = kBT / 32;
constexpr int kMaxE = 128;
constexpr int kMaxTiles = 65536 / kBT;    // T <= 65536

// Zero between calls: every call leaves it so.
struct Work {
  unsigned ticket, done, pad[2];
  unsigned flag[kMaxTiles];               // 1: tile's counts published
  int cnt[kMaxTiles * 2 * kMaxE];         // [tile][2E]: top-1, kept top-2
  float me[kMaxTiles * kMaxE];            // [tile][E] probability sums
};

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

// Wait until tile j's counts are published; trap after ~10 s (a flag that
// never comes is a fault, not a wait).
__device__ __forceinline__ void wait_published(const Work* w, int j) {
  const long long t0 = clock64();
  while (ld_acquire(&w->flag[j]) != 1u) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    __nanosleep(64);
  }
}

__global__ void __launch_bounds__(kBT) routing_tiles_kernel(
    const float* __restrict__ logits, const float* __restrict__ u,
    int* __restrict__ g1i_out, int* __restrict__ g2i_out,
    float* __restrict__ g1_out, float* __restrict__ g2_out,
    int* __restrict__ p1_out, int* __restrict__ c2_out,
    int* __restrict__ keep2_out, float* __restrict__ count1_out,
    float* __restrict__ me_out, Work* __restrict__ w, int T, int E,
    int random_keep2) {
  __shared__ int wc1[kWarps * kMaxE], wc2[kWarps * kMaxE];  // [warp][E]
  __shared__ float wme[kWarps * kMaxE];
  __shared__ int off[2 * kMaxE];          // the tile's offsets: top-1, top-2
  __shared__ int s_tile, s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int n_tiles = T / kBT, W2 = 2 * E;
  if (tid == 0) s_tile = (int)atomicAdd(&w->ticket, 1u);
  for (int i = tid; i < kWarps * E; i += kBT) wc1[i] = wc2[i] = 0;
  for (int i = tid; i < W2; i += kBT) off[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  if (tile >= n_tiles) __trap();          // a ticket the last call left set
  const int t = tile * kBT + tid;
  const float* row = logits + (int64_t)t * E;

  // A. softmax and the top-2 choice of token t
  float mx = row[0];
  for (int e = 1; e < E; ++e) mx = fmaxf(mx, row[e]);
  float sum = 0.f;
  for (int e = 0; e < E; ++e) sum += expf(row[e] - mx);
  int i1 = 0;
  float v1 = expf(row[0] - mx) / sum;
  for (int e = 1; e < E; ++e) {
    const float p = expf(row[e] - mx) / sum;
    if (p > v1) { v1 = p; i1 = e; }          // strict: the first tie wins
  }
  int i2 = 0;
  float v2 = i1 == 0 ? 0.f : expf(row[0] - mx) / sum;   // index 0
  for (int e = 1; e < E; ++e) {
    const float p = e == i1 ? 0.f : expf(row[e] - mx) / sum;
    if (p > v2) { v2 = p; i2 = e; }
  }
  const bool keep2 =
      !random_keep2 || u[t] < 2.0f * v2 / fmaxf(v1 + v2, 1e-9f);
  g1i_out[t] = i1;
  g2i_out[t] = i2;
  g1_out[t] = v1;
  g2_out[t] = v2;
  keep2_out[t] = keep2 ? 1 : 0;
  for (int e = 0; e < E; ++e) {            // the warp's probability sums
    float p = expf(row[e] - mx) / sum;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) wme[warp * E + e] = p;
  }

  // B. rank among the warp's claims on the same expert; each expert's
  // warps in token order
  const int e2 = keep2 ? i2 : -1;
  const unsigned peers1 = __match_any_sync(0xffffffffu, i1);
  const unsigned peers2 = __match_any_sync(0xffffffffu, e2);
  const int rank1 = __popc(peers1 & lt), rank2 = __popc(peers2 & lt);
  if (rank1 == 0) wc1[warp * E + i1] = __popc(peers1);
  if (e2 >= 0 && rank2 == 0) wc2[warp * E + e2] = __popc(peers2);
  __syncthreads();
  int n1 = 0;                              // thread e: the tile's top-1 count
  if (tid < E) {
    int n2 = 0;
    float me = 0.f;
    for (int v = 0; v < kWarps; ++v) {
      const int c1 = wc1[v * E + tid], c2 = wc2[v * E + tid];
      wc1[v * E + tid] = n1;
      wc2[v * E + tid] = n2;
      n1 += c1;
      n2 += c2;
      me += wme[v * E + tid];
    }
    // C. publish the tile's counts and probability sums
    w->cnt[tile * W2 + tid] = n1;
    w->cnt[tile * W2 + E + tid] = n2;
    w->me[tile * E + tid] = me;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) st_release(&w->flag[tile], 1u);
  if (tid < tile) wait_published(w, tid);  // tile <= 255 < kBT
  __syncthreads();
  // the predecessors' counts: [0, tile) x [2E], contiguous
  const int n_prev = tile * W2;
  for (int i = tid; i < n_prev; i += kBT)
    atomicAdd(&off[i % W2], __ldcg(&w->cnt[i]));
  __syncthreads();
  p1_out[t] = off[i1] + wc1[warp * E + i1] + rank1;
  c2_out[t] = e2 >= 0 ? off[E + e2] + wc2[warp * E + e2] + rank2 : 0;
  if (tile == n_tiles - 1 && tid < E)
    count1_out[tid] = (float)(off[tid] + n1);

  // D. the last block: me_sum, and the workspace reset for the next call
  __syncthreads();                         // every read of the workspace done
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&w->done, 1u) == (unsigned)(n_tiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each expert's tile sums in a fixed order: G groups of consecutive
  // tiles, then the groups in order
  const int G = kBT / E, per = (n_tiles + G - 1) / G;
  if (tid < G * E) {
    const int gi = tid / E, e = tid % E;
    const int j0 = gi * per, j1 = min(n_tiles, j0 + per);
    float s = 0.f;
    for (int j = j0; j < j1; ++j) s += __ldcg(&w->me[j * E + e]);
    wme[gi * E + e] = s;
  }
  __syncthreads();
  if (tid < E) {
    float s = 0.f;
    for (int gi = 0; gi < G; ++gi) s += wme[gi * E + tid];
    me_out[tid] = s;
  }
  for (int j = tid; j < n_tiles; j += kBT) w->flag[j] = 0u;
  if (tid == 0) {
    w->ticket = 0u;
    w->done = 0u;
  }
}

}  // namespace

// bytes of the workspace that moe_routing_launch takes, zeroed before its
// first call
extern "C" size_t moe_routing_work_bytes() { return sizeof(Work); }

extern "C" int moe_routing_launch(
    const float* logits, const float* u, int* g1i, int* g2i, float* g1,
    float* g2, int* p1, int* c2, int* keep2, float* count1, float* me_sum,
    void* work, int T, int E, int random_keep2, cudaStream_t stream) {
  if (T % 1024 != 0 || T <= 0 || T > kMaxTiles * kBT || E < 2 ||
      E > kMaxE || !work)
    return cudaErrorInvalidValue;
  routing_tiles_kernel<<<T / kBT, kBT, 0, stream>>>(
      logits, u, g1i, g2i, g1, g2, p1, c2, keep2, count1, me_sum,
      static_cast<Work*>(work), T, E, random_keep2);
  return cudaGetLastError();
}
