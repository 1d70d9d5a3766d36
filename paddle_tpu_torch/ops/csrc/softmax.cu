// Last-axis softmax forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
//   _make_softmax fwd -> _softmax_fwd_kernel   (softmax_fwd_kernel)
//   _make_softmax bwd -> _softmax_bwd_kernel   (softmax_bwd_kernel)
//
//   x, o, g, dx  [N, H]  T = f32 | bf16, contiguous rows
//
// Forward: o = exp(x - max(x)) / sum(exp(x - max(x))) in f32, rounded once
// to T.  The row max and sum come from one online pass (each lane keeps a
// running max and a sum rescaled when the max grows; the lanes merge with
// shuffles), then a second sweep writes o.
// Backward: dx = o * (g - sum(g * o)) with the sum in f32, rounded to T.
//
// What bounds it on this card: each element is read once or twice and
// written once with a few operations, so both kernels are bound by the
// bytes they move (3.35 TB/s on an H100 SXM).  One warp per row: the lanes
// stride the row (neighbouring lanes on neighbouring elements) and the
// second sweep finds the row in L1/L2.
//
// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ o, int n,
                   int h) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* xr = x + (long long)row * h;
  // online max and sum: sum holds sum(exp(x - m)) over this lane's columns.
  // m starts at the lowest finite float, not -inf: a -inf column (a masked
  // score) then adds exp(-inf) = 0 where exp(-inf - -inf) would be NaN,
  // with no further branch in the loop.  A lane that saw no finite column
  // carries sum = 0, which every merge below keeps at 0
  float m = -FLT_MAX, sum = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float v = to_f32(xr[c]);
    if (v > m) {
      sum = sum * expf(m - v) + 1.f;
      m = v;
    } else {
      sum += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(kFull, m, off);
    const float so = __shfl_xor_sync(kFull, sum, off);
    const float mn = fmaxf(m, mo);
    sum = sum * expf(m - mn) + so * expf(mo - mn);
    m = mn;
  }
  const float inv = 1.f / sum;
  T* orow = o + (long long)row * h;
  for (int c = lane; c < h; c += 32)
    store(orow + c, expf(to_f32(xr[c]) - m) * inv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_kernel(const T* __restrict__ o, const T* __restrict__ g,
                   T* __restrict__ dx, int n, int h) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const long long base = (long long)row * h;
  float s = 0.f;
  for (int c = lane; c < h; c += 32)
    s = fmaf(to_f32(g[base + c]), to_f32(o[base + c]), s);
  s = warp_sum(s);
  for (int c = lane; c < h; c += 32)
    store(dx + base + c, to_f32(o[base + c]) * (to_f32(g[base + c]) - s));
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int softmax_fwd_launch(const void* x, void* o, int n, int h,
                                  int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kWarps - 1) / kWarps;
  if (dtype == 0)
    softmax_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(o), n, h);
  else if (dtype == 1)
    softmax_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(o), n, h);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int softmax_bwd_launch(const void* o, const void* g, void* dx,
                                  int n, int h, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kWarps - 1) / kWarps;
  if (dtype == 0)
    softmax_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(g),
        static_cast<float*>(dx), n, h);
  else if (dtype == 1)
    softmax_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n, h);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
