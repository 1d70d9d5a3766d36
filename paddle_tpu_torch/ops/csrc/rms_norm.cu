// RMSNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
//   _make_rms fwd -> _rms_fwd_kernel   (rms_fwd_kernel)
//   _make_rms bwd -> _rms_bwd_kernel   (rms_bwd_vec_kernel or rms_bwd_kernel,
//                                       + rms_dw_reduce_kernel)
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
// What bounds it on this card: a row pass reads each element once and does
// a handful of operations on it, so both kernels are bound by the bytes
// they move (3.35 TB/s on an H100 SXM).  bf16 rows of up to 1,024 elements
// (H a multiple of 8, 16-byte aligned rows) take register passes: each lane
// holds its slice of a row in registers as 16-byte vectors, neighbouring
// lanes on neighbouring addresses (4 vectors at H = 1,024; w is read again
// per row, from L1), takes the row's sums by shuffles from them and writes
// its outputs as 16-byte vectors, so each element is read once.
//   * The forward (rms_fwd_vec_kernel) runs one warp per row and one block
//     of 8 warps per 8 rows, and computes out as x * inv * w in that order,
//     as the TPU kernel and the plain version round it.  The previous
//     version read the row twice in lane-strided 2-byte loads, the second
//     sweep finding it in L1/L2.
//   * The backward (rms_bwd_vec_kernel) moves three bytes for each one the
//     forward reads (x and g in, dx out).  It adds g * xhat into f32 dw
//     sums for the lane's fixed columns across the rows its warp walks, so
//     dw needs no second read of x and g.  dw sums across rows, which on
//     the TPU was a scratch carried along the sequential grid; here blocks
//     run in parallel, so the grid is sized to the card (2 blocks of 8
//     warps per SM, each a contiguous run of rows), each block adds its
//     warps' sums through shared memory in warp order into one f32 partial
//     row, and a second kernel sums the partial rows in a fixed order:
//     deterministic, no float atomics, about 1 MB of partials at H = 1,024.
// Other rows (f32 x, H not a multiple of 8 or above 1,024, unaligned rows)
// take general loops: one warp per row with element-wise loads, and in the
// backward, over the same grid, one thread per column of the block's dw
// partial walking the block's rows.
//
// The C entries allocate nothing (the caller passes the partials buffer),
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int kBwdBlocksPerSM = 2;     // backward blocks per SM
constexpr int kMaxVectors = 4;         // 16-byte vectors of a row per lane
                                       // in the register passes (H <= 1,024)

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

// the bf16 forward register pass: NV 16-byte vectors (8 elements) of the
// row per lane, one warp per row
template <typename W, int NV>
__global__ void __launch_bounds__(kThreads)
rms_fwd_vec_kernel(const __nv_bfloat16* __restrict__ x,
                   const W* __restrict__ w, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ inv, int n, int h, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const int nc = h / 8;                     // 16-byte vectors per row
  const long long base = (long long)row * h;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  uint4 xv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    xv[i] = c < nc ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float xf[8];
    unpack8(xf, xv[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(xf[e], xf[e], ss);
  }
  const float r = rsqrtf(warp_sum(ss) / h + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + base);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nc) {
      float xf[8], wf[8];
      unpack8(xf, xv[i]);
      load8(wf, w, c, nc);
#pragma unroll
      for (int e = 0; e < 8; ++e) xf[e] = xf[e] * r * wf[e];
      orow[c] = pack8(xf);
    }
  }
  if (lane == 0) inv[row] = r;
}

// the bf16 backward row pass: NV 16-byte vectors (8 elements) of each
// row per lane; the block takes rows [row0, row0 + rows_per_block) and its
// warp w rows row0 + w, row0 + w + 8, ...
template <typename W, int NV>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
rms_bwd_vec_kernel(const __nv_bfloat16* __restrict__ x,
                   const W* __restrict__ w, const float* __restrict__ inv,
                   const __nv_bfloat16* __restrict__ g,
                   __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ partial, int n, int h,
                   int rows_per_block) {
  __shared__ __align__(16) float sums[kWarps][NV * 32 * 8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = h / 8;                     // 16-byte vectors per row
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, n);
  float dw[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dw[i][e] = 0.f;
  for (int row = row0 + warp; row < row1; row += kWarps) {
    const long long base = (long long)row * h;
    const uint4* xr = reinterpret_cast<const uint4*>(x + base);
    const uint4* gr = reinterpret_cast<const uint4*>(g + base);
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < nc ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
      gv[i] = c < nc ? __ldg(gr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    const float r = inv[row];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv[i]);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv[i]);
      float wf[8];
      load8(wf, w, lane + 32 * i, nc);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dot = fmaf(to_f32(ge[e]) * wf[e], to_f32(xe[e]) * r, dot);
    }
    const float mean = warp_sum(dot) / h;
    uint4* dxr = reinterpret_cast<uint4*>(dx + base);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv[i]);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv[i]);
      float wf[8];
      load8(wf, w, c, nc);
      uint4 out;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = to_f32(xe[e]) * r, gf = to_f32(ge[e]);
        oe[e] = __float2bfloat16(r * (gf * wf[e] - xhat * mean));
        dw[i][e] = fmaf(gf, xhat, dw[i][e]);
      }
      if (c < nc) dxr[c] = out;
    }
  }
  // the block's dw partial: its warps' sums added in warp order
  block_partial<NV>(sums, dw, partial + (long long)blockIdx.x * h, h);
}

// the general backward row pass (any T, any H, any alignment): one warp per
// row with element-wise loads, then one thread per column of the block's
// dw partial walks the block's rows in order
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
               const float* __restrict__ inv, const T* __restrict__ g,
               T* __restrict__ dx, float* __restrict__ partial, int n, int h,
               int rows_per_block) {
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float acc = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const long long at = (long long)(row0 + rr) * h + c;
      acc = fmaf(to_f32(g[at]), to_f32(x[at]) * inv[row0 + rr], acc);
    }
    partial[(long long)blockIdx.x * h + c] = acc;
  }
}

// dw[c] = sum of the partial rows in row order; a block takes 32 columns,
// its 8 warps sum every 8th partial row and then add their sums in warp
// order
template <typename W>
__global__ void __launch_bounds__(kThreads)
rms_dw_reduce_kernel(const float* __restrict__ partial, W* __restrict__ dw,
                     int blocks, int h) {
  __shared__ float sums[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < h)
    for (int b = warp; b < blocks; b += kWarps)
      acc += partial[(long long)b * h + c];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < h) {
    float total = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) total += sums[v][lane];
    store(dw + c, total);
  }
}

template <typename T, typename W>
cudaError_t fwd(const void* x, const void* w, void* out, float* inv, int n,
                int h, float eps, cudaStream_t s) {
  const int blocks = (n + kWarps - 1) / kWarps;
  const int nv = (h / 8 + 31) / 32;         // 16-byte vectors per lane
  if (std::is_same<T, __nv_bfloat16>::value && h % 8 == 0 &&
      nv <= kMaxVectors && aligned16(x, w, out)) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    const W* wt = static_cast<const W*>(w);
#define RMS_FWD_VEC(NV)                                                   \
  rms_fwd_vec_kernel<W, NV><<<blocks, kThreads, 0, s>>>(xb, wt, ob, inv, n, \
                                                        h, eps)
    if (nv == 1) RMS_FWD_VEC(1);
    else if (nv == 2) RMS_FWD_VEC(2);
    else if (nv == 3) RMS_FWD_VEC(3);
    else RMS_FWD_VEC(4);
#undef RMS_FWD_VEC
  } else {
    rms_fwd_kernel<T, W><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(out), inv, n, h, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t bwd(const void* x, const void* w, const float* inv, const void* g,
                void* dx, void* dw, float* partial, int n, int h,
                cudaStream_t s) {
  int blocks = 0, rows = 0;
  cudaError_t err = card_grid(n, kBwdBlocksPerSM, &blocks, &rows);
  if (err != cudaSuccess) return err;
  const int nv = (h / 8 + 31) / 32;         // 16-byte vectors per lane
  if (std::is_same<T, __nv_bfloat16>::value && h % 8 == 0 &&
      nv <= kMaxVectors && aligned16(x, g, dx, w)) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* gb = static_cast<const __nv_bfloat16*>(g);
    auto* dxb = static_cast<__nv_bfloat16*>(dx);
    const W* wt = static_cast<const W*>(w);
#define RMS_VEC(NV)                                                          \
  rms_bwd_vec_kernel<W, NV><<<blocks, kThreads, 0, s>>>(xb, wt, inv, gb, dxb, \
                                                        partial, n, h, rows)
    if (nv == 1) RMS_VEC(1);
    else if (nv == 2) RMS_VEC(2);
    else if (nv == 3) RMS_VEC(3);
    else RMS_VEC(4);
#undef RMS_VEC
  } else {
    rms_bwd_kernel<T, W><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), inv,
        static_cast<const T*>(g), static_cast<T*>(dx), partial, n, h, rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rms_dw_reduce_kernel<W><<<(h + 31) / 32, kThreads, 0, s>>>(
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

// the number of dw partial rows that the backward of n rows writes on the
// current device, or -1 on a CUDA error
extern "C" int rms_norm_bwd_partials(int n) {
  int blocks = 0, rows = 0;
  if (n <= 0 || card_grid(n, kBwdBlocksPerSM, &blocks, &rows) != cudaSuccess)
    return -1;
  return blocks;
}

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

// partial: f32 scratch of rms_norm_bwd_partials(n) x h
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
