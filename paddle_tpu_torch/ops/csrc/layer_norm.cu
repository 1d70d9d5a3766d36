// Affine LayerNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
//   _make_layer_norm fwd -> _ln_fwd_kernel   (ln_fwd_kernel)
//   _make_layer_norm bwd -> _ln_bwd_kernel   (ln_bwd_kernel + ln_dwb_reduce_kernel)
//
//   x, out, g, dx  [N, H]  T = f32 | bf16, contiguous rows
//   w, b, dw, db   [H]     W = f32 | bf16
//   mu, inv        [N]     f32: the row mean and rsqrt(var + eps)
//
// Forward: mu = mean(x), var = mean((x - mu)^2) (two passes over the row,
// in f32), out = (x - mu) * inv * w + b in f32, rounded once to T.
// Backward: with xhat = (x - mu) * inv and gw = g * w (f32),
// dx = inv * (gw - mean(gw) - xhat * mean(gw * xhat)) rounded to T;
// dw = sum over rows of g * xhat and db = sum over rows of g, in f32,
// rounded to W.
//
// What bounds it on this card: a row pass reads each element two or three
// times (the later sweeps find the row in L1/L2) and does a handful of
// operations on it, so both kernels are bound by the bytes they move
// (3.35 TB/s on an H100 SXM).  One warp per row: the lanes stride the row
// (neighbouring lanes on neighbouring elements) and reduce with shuffles.
// dw and db sum across rows, which on the TPU was a scratch carried along
// the sequential grid; here blocks run in parallel, so each block writes
// f32 partials over its 64 rows and a second kernel sums the partials in a
// fixed order: deterministic, no float atomics.  Both sums are compensated
// (Kahan), so the result stays within f32 rounding of the exact sum.
//
// The C entries allocate nothing (the caller passes the partials buffer),
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;      // rows of one dw / db partial
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// compensated (Kahan) sum: dw and db add 32,768 rows at ERNIE's train
// shape, where a plain running f32 sum drifts by ~1e-4 of the total
struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float x) {
    const float y = x - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, T* __restrict__ out,
              float* __restrict__ mu, float* __restrict__ inv, int n, int h,
              float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* xr = x + (long long)row * h;
  float s = 0.f;
  for (int c = lane; c < h; c += 32) s += to_f32(xr[c]);
  const float m = warp_sum(s) / h;
  float ss = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float d = to_f32(xr[c]) - m;
    ss = fmaf(d, d, ss);
  }
  const float r = rsqrtf(warp_sum(ss) / h + eps);
  T* orow = out + (long long)row * h;
  for (int c = lane; c < h; c += 32)
    store(orow + c, (to_f32(xr[c]) - m) * r * to_f32(w[c]) + to_f32(b[c]));
  if (lane == 0) {
    mu[row] = m;
    inv[row] = r;
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const float* __restrict__ mu, const float* __restrict__ inv,
              const T* __restrict__ g, T* __restrict__ dx,
              float* __restrict__ partial, int n, int h) {
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, n - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // dx: one warp per row
  for (int rr = warp; rr < rows; rr += kWarps) {
    const long long base = (long long)(row0 + rr) * h;
    const float m = mu[row0 + rr], r = inv[row0 + rr];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float gw = to_f32(g[base + c]) * to_f32(w[c]);
      s1 += gw;
      s2 = fmaf(gw, (to_f32(x[base + c]) - m) * r, s2);
    }
    const float m1 = warp_sum(s1) / h, m2 = warp_sum(s2) / h;
    for (int c = lane; c < h; c += 32) {
      const float xhat = (to_f32(x[base + c]) - m) * r;
      const float gw = to_f32(g[base + c]) * to_f32(w[c]);
      store(dx + base + c, r * (gw - m1 - xhat * m2));
    }
  }
  // this block's dw and db partials: one thread per column, rows in order;
  // partial rows [0, blocks) hold dw, [blocks, 2 * blocks) hold db
  float* pw = partial + (long long)blockIdx.x * h;
  float* pb = partial + (long long)(gridDim.x + blockIdx.x) * h;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    Kahan aw, ab;
    for (int rr = 0; rr < rows; ++rr) {
      const long long at = (long long)(row0 + rr) * h + c;
      const float gv = to_f32(g[at]);
      aw.add(gv * ((to_f32(x[at]) - mu[row0 + rr]) * inv[row0 + rr]));
      ab.add(gv);
    }
    pw[c] = aw.s;
    pb[c] = ab.s;
  }
}

template <typename W>
__global__ void ln_dwb_reduce_kernel(const float* __restrict__ partial,
                                     W* __restrict__ dw, W* __restrict__ db,
                                     int blocks, int h) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  Kahan aw, ab;
  for (int k = 0; k < blocks; ++k) {
    aw.add(partial[(long long)k * h + c]);
    ab.add(partial[(long long)(blocks + k) * h + c]);
  }
  store(dw + c, aw.s);
  store(db + c, ab.s);
}

template <typename T, typename W>
cudaError_t fwd(const void* x, const void* w, const void* b, void* out,
                float* mu, float* inv, int n, int h, float eps,
                cudaStream_t s) {
  ln_fwd_kernel<T, W><<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(out), mu, inv, n, h, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t bwd(const void* x, const void* w, const float* mu,
                const float* inv, const void* g, void* dx, void* dw, void* db,
                float* partial, int n, int h, cudaStream_t s) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_bwd_kernel<T, W><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), mu, inv,
      static_cast<const T*>(g), static_cast<T*>(dx), partial, n, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_dwb_reduce_kernel<W><<<(h + 255) / 256, 256, 0, s>>>(
      partial, static_cast<W*>(dw), static_cast<W*>(db), blocks, h);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
#define LN_DISPATCH(CALL)                                                   \
  if (x_dtype == 0 && w_dtype == 0) return CALL(float, float);              \
  if (x_dtype == 0 && w_dtype == 1) return CALL(float, __nv_bfloat16);      \
  if (x_dtype == 1 && w_dtype == 0) return CALL(__nv_bfloat16, float);      \
  if (x_dtype == 1 && w_dtype == 1) return CALL(__nv_bfloat16, __nv_bfloat16); \
  return cudaErrorInvalidValue;

}  // namespace

extern "C" int layer_norm_partial_rows() { return kRowsPerBlock; }

extern "C" int layer_norm_fwd_launch(const void* x, const void* w,
                                     const void* b, void* out, void* mu,
                                     void* inv, int n, int h, int x_dtype,
                                     int w_dtype, float eps, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* iv = static_cast<float*>(inv);
#define LN_FWD(T, W) fwd<T, W>(x, w, b, out, m, iv, n, h, eps, s)
  LN_DISPATCH(LN_FWD)
#undef LN_FWD
}

// partial: f32 scratch of 2 * ceil(n / layer_norm_partial_rows()) x h
extern "C" int layer_norm_bwd_launch(const void* x, const void* w,
                                     const void* mu, const void* inv,
                                     const void* g, void* dx, void* dw,
                                     void* db, void* partial, int n, int h,
                                     int x_dtype, int w_dtype, void* stream) {
  if (n <= 0 || h <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mu);
  const float* iv = static_cast<const float*>(inv);
  float* pt = static_cast<float*>(partial);
#define LN_BWD(T, W) bwd<T, W>(x, w, m, iv, g, dx, dw, db, pt, n, h, s)
  LN_DISPATCH(LN_BWD)
#undef LN_BWD
}
