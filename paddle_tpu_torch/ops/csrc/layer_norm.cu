// Affine LayerNorm forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
//   _make_layer_norm fwd -> _ln_fwd_kernel   (ln_fwd_kernel)
//   _make_layer_norm bwd -> _ln_bwd_kernel   (ln_bwd_vec_kernel or
//                                             ln_bwd_kernel, + ln_dwb_reduce_kernel)
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
// What bounds it on this card: a row pass does a handful of operations per
// element, so both kernels are bound by the bytes they move (3.35 TB/s on
// an H100 SXM); the backward's least time at ERNIE's [32768, 768] bf16 is
// 45 us.  The forward runs one warp per row: the lanes stride the row
// (neighbouring lanes on neighbouring elements), reduce with shuffles, and
// the later sweeps find the row in L1/L2.
//   * The backward's register pass (ln_bwd_vec_kernel) takes bf16 rows of
//     up to 1,024 elements (H a multiple of 8, 16-byte aligned buffers).
//     Each lane holds its slice of x and g as 16-byte vectors in registers
//     (3 + 3 at H = 768; w is read again per row, from L1), takes both row
//     sums by shuffles in one pass, writes dx as 16-byte vectors, and adds
//     g * xhat and g into f32 dw / db sums for its fixed columns, in
//     registers, across the rows its warp walks: x and g are read once.
//     The previous version swept each row twice in 2-byte loads for dx and
//     a third time, column-wise and serially, for the dw / db partials.
//   * dw and db sum across rows, which on the TPU was a scratch carried
//     along the sequential grid; here blocks run in parallel, so the grid
//     is sized to the card (2 blocks of 8 warps per SM, each a contiguous
//     run of rows: 263 blocks of 125 rows at ERNIE's shape on an H100's
//     132 SMs, where the previous grid had 512 blocks of 64), each block
//     adds its warps' sums through shared memory in warp order into one dw
//     and one db partial row, and ln_dwb_reduce_kernel sums the partial
//     rows: a block per 32 columns of dw or of db, its 8 warps striding the
//     partial rows, then a fixed warp order.  Deterministic, no float
//     atomics; the previous reduce ran on 3 blocks, each thread a 512-long
//     chain.
//   * Other rows (f32 x, H not a multiple of 8 or above 1,024, unaligned
//     buffers) take a general loop over the same grid: one warp per row
//     with element-wise loads for dx, then one thread per column of the
//     block's partials walking the block's rows.
//   * Compensation (Kahan) only on the long chains, where f32 dw / db
//     would otherwise drift as far from the exact sum as torch.sum does
//     (the phase-2c gate holds the two against each other): the reduce,
//     which adds the partial rows 33 to a warp and then 8 warps, and the
//     general loop's 125-row column walks.  The register pass's sums stay
//     plain (16 rows a lane, then 8 warps).  Both chains are bound by
//     latency, not operations.  Phase 2c of chip_smoke.py prints the f32
//     sums' distance from a float64 sum beside torch.sum's.
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
                                       // in the register pass (H <= 1,024)

// compensated (Kahan) sum, for the long chains: the reduce's over the
// partial rows and the general loop's over a block's rows
struct Kahan {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float x) {
    const float y = x - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

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

// the bf16 backward register pass: NV 16-byte vectors (8 elements) of each
// row per lane; the block takes rows [row0, row0 + rows_per_block) and its
// warp w rows row0 + w, row0 + w + 8, ...; partial rows [0, blocks) get
// the blocks' dw, [blocks, 2 * blocks) their db.  At NV = 4 the x, g, dw
// and db registers alone are 96 a thread, so that instantiation is not held
// to 2 blocks per SM's 128 registers and may run 1 block per SM.
template <typename W, int NV>
__global__ void __launch_bounds__(kThreads, NV < 4 ? kBwdBlocksPerSM : 1)
ln_bwd_vec_kernel(const __nv_bfloat16* __restrict__ x,
                  const W* __restrict__ w, const float* __restrict__ mu,
                  const float* __restrict__ inv,
                  const __nv_bfloat16* __restrict__ g,
                  __nv_bfloat16* __restrict__ dx,
                  float* __restrict__ partial, int n, int h,
                  int rows_per_block) {
  __shared__ __align__(16) float sums[kWarps][NV * 32 * 8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = h / 8;                     // 16-byte vectors per row
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, n);
  float dw[NV][8], db[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dw[i][e] = db[i][e] = 0.f;
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
    const float m = mu[row], r = inv[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float xf[8], gf[8], wf[8];
      unpack8(xf, xv[i]);
      unpack8(gf, gv[i]);
      load8(wf, w, lane + 32 * i, nc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float gw = gf[e] * wf[e];
        s1 += gw;
        s2 = fmaf(gw, (xf[e] - m) * r, s2);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(kFull, s1, o);
      s2 += __shfl_xor_sync(kFull, s2, o);
    }
    const float m1 = s1 / h, m2 = s2 / h;
    uint4* dxr = reinterpret_cast<uint4*>(dx + base);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      float xf[8], gf[8], wf[8];
      unpack8(xf, xv[i]);
      unpack8(gf, gv[i]);
      load8(wf, w, c, nc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xhat = (xf[e] - m) * r;
        dw[i][e] = fmaf(gf[e], xhat, dw[i][e]);
        db[i][e] += gf[e];
        xf[e] = r * (gf[e] * wf[e] - m1 - xhat * m2);
      }
      if (c < nc) dxr[c] = pack8(xf);
    }
  }
  // the block's dw and db partials: its warps' sums added in warp order
  block_partial<NV>(sums, dw, partial + (long long)blockIdx.x * h, h);
  block_partial<NV>(sums, db, partial + (long long)(gridDim.x + blockIdx.x) * h,
                    h);
}

// the general backward row pass (any T, any H, any alignment): one warp per
// row with element-wise loads for dx, then one thread per column of the
// block's dw / db partials walks the block's rows in order, compensated
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const float* __restrict__ mu, const float* __restrict__ inv,
              const T* __restrict__ g, T* __restrict__ dx,
              float* __restrict__ partial, int n, int h, int rows_per_block) {
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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

// dw (blockIdx.y 0, partial rows [0, blocks)) and db (blockIdx.y 1, rows
// [blocks, 2 * blocks)) from the partial rows: a block takes 32 columns,
// its 8 warps sum every 8th partial row and then add their sums in warp
// order, both compensated
template <typename W>
__global__ void __launch_bounds__(kThreads)
ln_dwb_reduce_kernel(const float* __restrict__ partial, W* __restrict__ dw,
                     W* __restrict__ db, int blocks, int h) {
  __shared__ float sums[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const float* src = partial + (long long)blockIdx.y * blocks * h;
  Kahan acc;
  if (c < h)
    for (int b = warp; b < blocks; b += kWarps)
      acc.add(src[(long long)b * h + c]);
  sums[warp][lane] = acc.s;
  __syncthreads();
  if (warp == 0 && c < h) {
    Kahan total;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) total.add(sums[v][lane]);
    store((blockIdx.y == 0 ? dw : db) + c, total.s);
  }
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
#define LN_VEC(NV)                                                           \
  ln_bwd_vec_kernel<W, NV><<<blocks, kThreads, 0, s>>>(xb, wt, mu, inv, gb,  \
                                                       dxb, partial, n, h,   \
                                                       rows)
    if (nv == 1) LN_VEC(1);
    else if (nv == 2) LN_VEC(2);
    else if (nv == 3) LN_VEC(3);
    else LN_VEC(4);
#undef LN_VEC
  } else {
    ln_bwd_kernel<T, W><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), mu, inv,
        static_cast<const T*>(g), static_cast<T*>(dx), partial, n, h, rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_dwb_reduce_kernel<W><<<dim3((h + 31) / 32, 2), kThreads, 0, s>>>(
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

// the number of partial rows of each of dw and db that the backward of n
// rows writes on the current device, or -1 on a CUDA error
extern "C" int layer_norm_bwd_partials(int n) {
  int blocks = 0, rows = 0;
  if (n <= 0 || card_grid(n, kBwdBlocksPerSM, &blocks, &rows) != cudaSuccess)
    return -1;
  return blocks;
}

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

// partial: f32 scratch of 2 * layer_norm_bwd_partials(n) x h
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
