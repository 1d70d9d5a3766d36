// RMSNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
//   _make_rms fwd -> _rms_fwd_kernel   (rms_fwd_kernel)
//   _make_rms bwd -> _rms_bwd_kernel   (rms_bwd_kernel + rms_dw_reduce_kernel)
//
//   x, out, g, dx  [N, H]  T = f32 | bf16, contiguous rows
//   w, dw          [H]     W = f32 | bf16
//   inv            [N]     f32, rsqrt(mean(x^2) + eps) per row
//
// Forward: out = x * inv * w in f32, cast to T; inv is saved for the
// backward.  Backward: with xhat = x * inv and gw = g * w (f32),
// dx = inv * (gw - xhat * mean(gw * xhat)) cast to T, and
// dw = sum over rows of g * xhat in f32, cast to W.
//
// What bounds it on this card: a row pass reads each element once or twice
// and does a handful of operations on it, so both kernels are bound by the
// bytes they move (3.35 TB/s on an H100 SXM).  One warp per row: the
// lanes stride the row (neighbouring lanes on neighbouring elements), reduce
// with shuffles, and a second sweep of the same row finds it in L1/L2.
// dw sums across rows, which on the TPU was a scratch carried along the
// sequential grid; here blocks run in parallel, so each block writes an f32
// partial over its 64 rows and a second kernel sums the partials in a fixed
// order — deterministic, no float atomics.
//
// The C entries allocate nothing (the caller passes the partials buffer),
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;      // rows of one dw partial
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

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, float* __restrict__ inv, int n, int h,
               float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* xr = x + (long long)row * h;
  float ss = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(warp_sum(ss) / h + eps);
  T* orow = out + (long long)row * h;
  for (int c = lane; c < h; c += 32)
    store(orow + c, to_f32(xr[c]) * r * to_f32(w[c]));
  if (lane == 0) inv[row] = r;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
               const float* __restrict__ inv, const T* __restrict__ g,
               T* __restrict__ dx, float* __restrict__ partial, int n,
               int h) {
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, n - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // dx: one warp per row
  for (int rr = warp; rr < rows; rr += kWarps) {
    const long long base = (long long)(row0 + rr) * h;
    const float r = inv[row0 + rr];
    float dot = 0.f;
    for (int c = lane; c < h; c += 32)
      dot = fmaf(to_f32(g[base + c]) * to_f32(w[c]), to_f32(x[base + c]) * r,
                 dot);
    const float mean = warp_sum(dot) / h;
    for (int c = lane; c < h; c += 32) {
      const float xhat = to_f32(x[base + c]) * r;
      const float gw = to_f32(g[base + c]) * to_f32(w[c]);
      store(dx + base + c, r * (gw - xhat * mean));
    }
  }
  // this block's dw partial: one thread per column, rows in order
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float acc = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const long long at = (long long)(row0 + rr) * h + c;
      acc = fmaf(to_f32(g[at]), to_f32(x[at]) * inv[row0 + rr], acc);
    }
    partial[(long long)blockIdx.x * h + c] = acc;
  }
}

template <typename W>
__global__ void rms_dw_reduce_kernel(const float* __restrict__ partial,
                                     W* __restrict__ dw, int blocks, int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[(long long)b * h + c];
  store(dw + c, acc);
}

template <typename T, typename W>
cudaError_t fwd(const void* x, const void* w, void* out, float* inv, int n,
                int h, float eps, cudaStream_t s) {
  rms_fwd_kernel<T, W><<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), inv, n, h, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t bwd(const void* x, const void* w, const float* inv, const void* g,
                void* dx, void* dw, float* partial, int n, int h,
                cudaStream_t s) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  rms_bwd_kernel<T, W><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), inv,
      static_cast<const T*>(g), static_cast<T*>(dx), partial, n, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_reduce_kernel<W><<<(h + 255) / 256, 256, 0, s>>>(
      partial, static_cast<W*>(dw), blocks, h);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
#define RMS_DISPATCH(CALL)                                                  \
  if (x_dtype == 0 && w_dtype == 0) return CALL(float, float);              \
  if (x_dtype == 0 && w_dtype == 1) return CALL(float, __nv_bfloat16);      \
  if (x_dtype == 1 && w_dtype == 0) return CALL(__nv_bfloat16, float);      \
  if (x_dtype == 1 && w_dtype == 1) return CALL(__nv_bfloat16, __nv_bfloat16); \
  return cudaErrorInvalidValue;

}  // namespace

extern "C" int rms_norm_partial_rows() { return kRowsPerBlock; }

extern "C" int rms_norm_fwd_launch(const void* x, const void* w, void* out,
                                   void* inv, int n, int h, int x_dtype,
                                   int w_dtype, float eps, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* iv = static_cast<float*>(inv);
#define RMS_FWD(T, W) fwd<T, W>(x, w, out, iv, n, h, eps, s)
  RMS_DISPATCH(RMS_FWD)
#undef RMS_FWD
}

// partial: f32 scratch of ceil(n / rms_norm_partial_rows()) x h
extern "C" int rms_norm_bwd_launch(const void* x, const void* w,
                                   const void* inv, const void* g, void* dx,
                                   void* dw, void* partial, int n, int h,
                                   int x_dtype, int w_dtype, void* stream) {
  if (n <= 0 || h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* iv = static_cast<const float*>(inv);
  float* pt = static_cast<float*>(partial);
#define RMS_BWD(T, W) bwd<T, W>(x, w, iv, g, dx, dw, pt, n, h, s)
  RMS_DISPATCH(RMS_BWD)
#undef RMS_BWD
}
