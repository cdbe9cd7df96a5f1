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
// TB/s), but the positions are a sequential scan. Design: ONE block of 1024
// threads walks the tiles of 1024 tokens in order (the TPU grid's loop),
// thread i owning token i of the tile:
//   A. softmax, top-2 and keep2 in registers, reading its logits row (L1
//      holds it across the three passes); the per-expert probability sums
//      are reduced per warp by shuffles and kept per warp in shared memory;
//   B. per warp, each token's rank among the warp's claims on its expert
//      (__match_any_sync) and the warp's count per expert;
//   C. thread e scans the 32 warps' counts for expert e onto the running
//      count: the start of each warp's claims;
//   D. position = start + rank.
// No atomics, so the result does not depend on the schedule. A single
// block is launch- and latency-bound (~tens of us at T 8192); splitting
// the scan over blocks (per-tile counts, a scan, then positions) is the
// next step when it shows in a profile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBT = 1024;       // tokens per tile = threads in the block
constexpr int kWarps = kBT / 32;

__global__ void __launch_bounds__(kBT) routing_kernel(
    const float* __restrict__ logits, const float* __restrict__ u,
    int* __restrict__ g1i_out, int* __restrict__ g2i_out,
    float* __restrict__ g1_out, float* __restrict__ g2_out,
    int* __restrict__ p1_out, int* __restrict__ c2_out,
    int* __restrict__ keep2_out, float* __restrict__ count1_out,
    float* __restrict__ me_out, int T, int E, int random_keep2) {
  extern __shared__ int smem[];
  int* wc1 = smem;                      // [kWarps][E] counts, then starts
  int* wc2 = wc1 + kWarps * E;
  float* me = reinterpret_cast<float*>(wc2 + kWarps * E);  // [kWarps][E]
  int* run1 = reinterpret_cast<int*>(me + kWarps * E);      // [E]
  int* run2 = run1 + E;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  for (int i = tid; i < kWarps * E; i += kBT) me[i] = 0.f;
  for (int i = tid; i < E; i += kBT) run1[i] = run2[i] = 0;
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += kBT) {
    for (int i = tid; i < kWarps * E; i += kBT) wc1[i] = wc2[i] = 0;
    const int t = t0 + tid;
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
    // per-expert probability sums: warp shuffles, then one add per warp
    for (int e = 0; e < E; ++e) {
      float p = expf(row[e] - mx) / sum;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) me[warp * E + e] += p;
    }

    // B. rank among the warp's claims on the same expert
    const int e2 = keep2 ? i2 : -1;
    const unsigned peers1 = __match_any_sync(0xffffffffu, i1);
    const unsigned peers2 = __match_any_sync(0xffffffffu, e2);
    const int rank1 = __popc(peers1 & lt), rank2 = __popc(peers2 & lt);
    __syncthreads();                          // wc zeroed
    if (rank1 == 0) wc1[warp * E + i1] = __popc(peers1);
    if (e2 >= 0 && rank2 == 0) wc2[warp * E + e2] = __popc(peers2);
    __syncthreads();

    // C. each expert's warps in token order, onto its running counts
    if (tid < E) {
      int base = run1[tid];
      for (int w = 0; w < kWarps; ++w) {
        const int c = wc1[w * E + tid];
        wc1[w * E + tid] = base;
        base += c;
      }
      run1[tid] = base;
      base = run2[tid];
      for (int w = 0; w < kWarps; ++w) {
        const int c = wc2[w * E + tid];
        wc2[w * E + tid] = base;
        base += c;
      }
      run2[tid] = base;
    }
    __syncthreads();

    // D. global 0-based positions
    p1_out[t] = wc1[warp * E + i1] + rank1;
    c2_out[t] = e2 >= 0 ? wc2[warp * E + e2] + rank2 : 0;
    __syncthreads();                          // before the next tile's zeroing
  }

  if (tid < E) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += me[w * E + tid];
    me_out[tid] = s;
    count1_out[tid] = (float)run1[tid];
  }
}

}  // namespace

extern "C" int moe_routing_launch(
    const float* logits, const float* u, int* g1i, int* g2i, float* g1,
    float* g2, int* p1, int* c2, int* keep2, float* count1, float* me_sum,
    int T, int E, int random_keep2, cudaStream_t stream) {
  if (T % kBT != 0 || T <= 0 || E < 2 || E > 128) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * kWarps * E + 2 * E) * sizeof(int);
  cudaError_t err = flash::allow_smem(routing_kernel, smem);
  if (err != cudaSuccess) return err;
  routing_kernel<<<1, kBT, smem, stream>>>(logits, u, g1i, g2i, g1, g2, p1,
                                           c2, keep2, count1, me_sum, T, E,
                                           random_keep2);
  return cudaGetLastError();
}
