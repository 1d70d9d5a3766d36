// Hopper (sm_90a) building blocks shared by the port's tensor-core
// kernels (flash_attention.cu, ragged_paged_attention.cuh): asynchronous
// 16-byte copies into shared memory (cp.async), ldmatrix fragments of
// swizzled (or padded) bf16 row tiles, the mma.sync m16n8k16 bf16 product with f32
// accumulation, and the once-per-device dynamic shared-memory opt-in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as a hi and a lo bf16 pair: hi = bf16(x) and lo = bf16(x - hi);
// x - hi is exact in f32 and at most 2^-8 |x|, so hi + lo is x to 2^-16
// relative
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi,
                                          unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// The shared-memory layout of a bf16 row tile [rows][W] (W a multiple of
// 16, so W / 8 16-byte chunks a row).  An ldmatrix phase reads one chunk of
// 8 consecutive rows, and it is conflict-free when those 8 chunks lie in 8
// distinct 16-byte bank groups.  With W / 8 a multiple of 8 (W = 64, 128,
// 192, 256) chunk c of row r sits at c ^ (r % 8): the XOR flips only the
// low 3 bits of c, so every chunk stays inside its own group of 8 and its
// own row.  Any other W (32, 48, 80, 96, 160: 4, 6, 10, 12, 20 chunks)
// would XOR a chunk out of its row (chunk 8 of row 7 to chunk 15 of a
// 10-chunk row), so those rows stay unswizzled and are padded by one chunk
// instead: a stride of W / 8 + 1 chunks is odd, which puts 8 consecutive
// rows in 8 distinct bank groups.
template <int W>
constexpr bool kSwizzled = (W / 8) % 8 == 0;

// the row stride of such a tile, in elements
template <int W>
__host__ __device__ constexpr int tile_ld() {
  return kSwizzled<W> ? W : W + 8;
}

// element offset of 16-byte chunk c of row r in a [rows][W] tile
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (kSwizzled<W>) return r * W + ((c ^ (r & 7)) << 3);
  else return r * (W + 8) + (c << 3);
}

// the A fragments (16 x 16 bf16 per k-step) of rows [r0, r0 + 16) of a
// tile, k-step kk
template <int D>
__device__ __forceinline__ void load_a(unsigned a[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + swz<D>(r0 + (lane & 15), kk * 2 + (lane >> 4)));
}

// B fragments of two n-tiles (rows n0 .. n0 + 15 of a row tile read as
// B^T: B[k][n] = tile[n][k]) at k-step kk: b[0], b[1] for n0, b[2], b[3]
// for n0 + 8
template <int D>
__device__ __forceinline__ void load_bt(unsigned b[4],
                                        const __nv_bfloat16* tile, int n0,
                                        int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + swz<D>(n0 + ((lane >> 4) << 3) + (lane & 7),
                           kk * 2 + ((lane >> 3) & 1)));
}

// B fragments of two n-tiles of a row tile read as B: B[k][n] = tile[k][n],
// k = k0 .. k0 + 15, n = chunk pair dp: b[0], b[1] for columns 16 dp ..,
// b[2], b[3] for 16 dp + 8 ..
template <int D>
__device__ __forceinline__ void load_b(unsigned b[4],
                                       const __nv_bfloat16* tile, int k0,
                                       int dp) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(b, tile + swz<D>(k0 + (((lane >> 3) & 1) << 3) + (lane & 7),
                             dp * 2 + (lane >> 4)));
}

// A kernel's dynamic shared-memory limit, set once per device: `done` is
// the call site's own flag word (one bit per device), so that
// cudaFuncSetAttribute's host cost is not paid on every launch.
template <typename K>
cudaError_t allow_smem(std::atomic<unsigned long long>& done, K kernel,
                       int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  else cudaGetLastError();  // the caller gets the error; later calls do not
  return err;
}

}  // namespace
