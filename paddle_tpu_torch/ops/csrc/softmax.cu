// Last-axis softmax forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
//   _make_softmax fwd -> _softmax_fwd_kernel   (softmax_fwd_reg_kernel, or
//                                               softmax_fwd_kernel)
//   _make_softmax bwd -> _softmax_bwd_kernel   (softmax_bwd_kernel)
//
//   x, o, g, dx  [N, H]  T = f32 | bf16, contiguous rows
//
// Forward: o = exp(x - max(x)) / sum(exp(x - max(x))) in f32, rounded once
// to T.  Backward: dx = o * (g - sum(g * o)) with the sum in f32, rounded
// to T.
//
// What bounds it on this card: each element is read once and written once
// with a few operations, so both kernels are bound by the bytes they move
// (3.35 TB/s on an H100 SXM); the forward's least time at ERNIE's
// [8, 12, 512, 512] bf16 is 30 us.  One warp per row.
//   * The forward's register pass (softmax_fwd_reg_kernel) takes rows that
//     fit in registers: a multiple of 16 bytes long (8 bf16 or 4 f32), at
//     most kRegMax elements (64 f32 values a lane), on 16-byte aligned
//     buffers.  Each lane reads its
//     slice once, in 16-byte vectors with neighbouring lanes on
//     neighbouring addresses (two vectors a lane at H = 512 bf16), keeps it
//     in registers, takes the row max by shuffles, then one
//     exp2f((x - m) log2 e) per element, the row sum by shuffles, and
//     writes 16-byte vectors: one read and one write of the row, and one
//     exponential per element.  The previous version read bf16 scalars (64
//     bytes a warp load), read the row twice and took two exponentials per
//     element.  A row of -inf and finite values gives exact zeros at the
//     -inf columns; a row that is -inf throughout gives NaN, as the plain
//     version does.
//   * Every other row length takes softmax_fwd_kernel: an online pass (each
//     lane keeps a running max, starting at -FLT_MAX so that a leading -inf
//     column adds exp(-inf) = 0, and a sum rescaled when the max grows; the
//     lanes merge with shuffles), then a second sweep writes o, with the
//     row found in L1/L2.
//   * The forward's grid is one block of eight warps per eight rows.  A
//     grid sized to the card whose warps walk the rows with a stride was
//     slower at 2-16 blocks per SM (PERF.md, row 10) and was taken out.
//
// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kRegMax = 2048;          // longest row the register pass holds
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 16 bytes of T <-> f32: 4 floats, or 8 bf16 values
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v,
                                               float s) {
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    unpack8(o, __ldg(reinterpret_cast<const uint4*>(p)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v, float s) {
    float scaled[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) scaled[i] = v[i] * s;
    *reinterpret_cast<uint4*>(p) = pack8(scaled);
  }
};

// The register pass: NV 16-byte vectors a lane cover the row (H <= 32 NV
// times the vector's length; the lane's vectors past H are not touched).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_reg_kernel(const T* __restrict__ x, T* __restrict__ o, int n,
                       int h) {
  using V = Vec16<T>;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* xr = x + (long long)row * h;
  float v[NV][V::N];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V::N;
    if (c < h) {
      V::load(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < V::N; ++e) m = fmaxf(m, v[i][e]);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * V::N < h) {
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        v[i][e] = exp2f((v[i][e] - m) * kLog2e);
        sum += v[i][e];
      }
    }
  }
  const float inv = 1.f / warp_sum(sum);
  T* orow = o + (long long)row * h;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V::N;
    if (c < h) V::store(orow + c, v[i], inv);
  }
}

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

template <typename T>
cudaError_t softmax_fwd(const void* x, void* o, int n, int h,
                        cudaStream_t s) {
  const int blocks = (n + kWarps - 1) / kWarps;
  const T* xi = static_cast<const T*>(x);
  T* oo = static_cast<T*>(o);
  constexpr int vec = Vec16<T>::N;
  if (h % vec != 0 || h > kRegMax || !aligned16(x, o)) {
    softmax_fwd_kernel<T><<<blocks, kThreads, 0, s>>>(xi, oo, n, h);
  } else if (h <= 32 * vec) {
    softmax_fwd_reg_kernel<T, 1><<<blocks, kThreads, 0, s>>>(xi, oo, n, h);
  } else if (h <= 64 * vec) {
    softmax_fwd_reg_kernel<T, 2><<<blocks, kThreads, 0, s>>>(xi, oo, n, h);
  } else if (h <= 128 * vec) {
    softmax_fwd_reg_kernel<T, 4><<<blocks, kThreads, 0, s>>>(xi, oo, n, h);
  } else if (h <= 256 * vec) {
    softmax_fwd_reg_kernel<T, 8><<<blocks, kThreads, 0, s>>>(xi, oo, n, h);
  } else {
    softmax_fwd_reg_kernel<T, kRegMax / 32 / vec><<<blocks, kThreads, 0, s>>>(
        xi, oo, n, h);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16
extern "C" int softmax_fwd_launch(const void* x, void* o, int n, int h,
                                  int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return softmax_fwd<float>(x, o, n, h, s);
  if (dtype == 1) return softmax_fwd<__nv_bfloat16>(x, o, n, h, s);
  return cudaErrorInvalidValue;
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
