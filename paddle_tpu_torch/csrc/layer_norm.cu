// Row LayerNorm for Hopper: y = (x - mean) * rsqrt(var + eps) * w + b.
//
// Replaces paddle_tpu/ops/pallas/fused_norm.py::_ln_kernel / _ln_fwd_pallas
// (its pallas_call at :127), the one-pass forward behind fused_layer_norm.
//
// Bound on the H100: bytes. The kernel reads N*d elements of x and d each
// of w and b, and writes N*d of y; it does ~8 operations per element, far
// below the card's operations-per-byte line. At BERT-Base's training shape
// ([16384, 768] bf16) that is 50.3 MB, ~15 us at 3.35 TB/s.
//
// Design: one warp per row, four rows to a block of 128 threads. Each lane
// loads its share of the row as 16-byte vectors (8 bf16 or 4 fp32; NV of
// them, NV a template parameter) and keeps them in registers, so the mean,
// the variance of the centred values and the output all come from the one
// read of x. Neighbouring lanes load neighbouring vectors. The two row sums
// are warp shuffles: no shared memory and no barrier.
//
// Arithmetic against the Pallas kernel (and layer_norm_plain): fp32 x, w and
// b; the mean first, then the mean of the squared centred values (not
// E[x^2] - mean^2), rsqrt(var + eps), (xc * inv) * w + b, and one rounding
// to x's dtype. Only the order of the sums differs.
//
// C interface (bound with ctypes): layer_norm_launch returns the CUDA launch
// error (0 on success); it never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

typedef __nv_bfloat16 bf16;

template <typename T> struct Vec;   // elements in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load16(const bf16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store16(bf16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, T* __restrict__ y,
                      int64_t n_rows, int d, float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // a whole warp leaves together
  const T* xr = x + row * d;
  float v[NV][V];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      load16(xr + c, v[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) sum += v[j][e];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((j * 32 + lane) * V < d) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[j][e] -= mean;
        ss += v[j][e] * v[j][e];
      }
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      float wf[V], bf[V];
      load16(w + c, wf);
      load16(b + c, bf);
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = v[j][e] * inv * wf[e] + bf[e];
      store16(yr + c, v[j]);
    }
  }
}

template <typename T, int NV>
int run(const void* x, const void* w, const void* b, void* y, int64_t n,
        int d, float eps, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps));
  layer_norm_fwd_kernel<T, NV><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), n, d, eps);
  return (int)cudaGetLastError();
}

// the smallest instantiated vector count per lane that covers d; d <= 4096
// takes NV <= 16 in bf16 and <= 32 in fp32 (128 fp32 registers a lane)
template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int64_t n,
           int d, float eps, cudaStream_t s) {
  const int nv = (d + 32 * Vec<T>::N - 1) / (32 * Vec<T>::N);
  if (nv <= 1) return run<T, 1>(x, w, b, y, n, d, eps, s);
  if (nv <= 2) return run<T, 2>(x, w, b, y, n, d, eps, s);
  if (nv <= 3) return run<T, 3>(x, w, b, y, n, d, eps, s);
  if (nv <= 4) return run<T, 4>(x, w, b, y, n, d, eps, s);
  if (nv <= 6) return run<T, 6>(x, w, b, y, n, d, eps, s);
  if (nv <= 8) return run<T, 8>(x, w, b, y, n, d, eps, s);
  if (nv <= 12) return run<T, 12>(x, w, b, y, n, d, eps, s);
  if (nv <= 16) return run<T, 16>(x, w, b, y, n, d, eps, s);
  if constexpr (Vec<T>::N == 4) {
    if (nv <= 24) return run<T, 24>(x, w, b, y, n, d, eps, s);
    if (nv <= 32) return run<T, 32>(x, w, b, y, n, d, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it). x and y are
// contiguous [n_rows, d], w and b contiguous [d]; d is a multiple of the
// elements in 16 bytes and at most 4096; every pointer is 16-byte aligned.
extern "C" int layer_norm_launch(const void* x, const void* w, const void* b,
                                 void* y, int64_t n_rows, int d, float eps,
                                 int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_rows > (int64_t)kWarps * 0x7fffffff || d <= 0 || d > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (d % Vec<float>::N) return (int)cudaErrorInvalidValue;
    return launch<float>(x, w, b, y, n_rows, d, eps, s);
  }
  if (dtype == 1) {
    if (d % Vec<bf16>::N) return (int)cudaErrorInvalidValue;
    return launch<bf16>(x, w, b, y, n_rows, d, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
