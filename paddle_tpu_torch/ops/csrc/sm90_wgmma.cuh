// Hopper (sm_90a) building blocks of the warp-specialised attention bodies
// in flash_attention.cuh, as raw PTX: mbarriers, TMA tile loads into
// 128-byte-swizzled shared tiles, warpgroup matrix products (wgmma) that
// read those tiles through matrix descriptors, register hand-over between
// warpgroups (setmaxnreg), and the host-side tensor maps, encoded through
// the driver entry point that the runtime hands out, so that no library
// links against libcuda.
//
// Tiles.  Every bf16 row tile [rows][W] lives in shared memory as W / 64
// panels (rounded up) of [rows][64]: one 128-byte row of 64 values per
// tile row, the 16-byte chunks of row r XOR-swizzled by r % 8, as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes them.  Each panel starts on a 1,024-byte
// boundary (the swizzle pattern repeats every 8 rows = 1,024 bytes), and
// TMA fills the columns past the tensor's head dim and the rows past its
// sequence with zeros.  A panel is read by wgmma two ways:
//   * K-major (the contraction runs along the row): A = Q in S = Q K^T, and
//     B = K, Q or dO where B[k][n] = tile[n][k].  k-step kk of a panel
//     starts 32 * kk bytes into it; 8-row groups are 1,024 bytes apart.
//   * MN-major (the contraction runs down the rows): B = V in O += P V, and
//     dO, Q in dV += p^T dO, dK += ds^T Q.  One n64 product covers one
//     panel; k-step kk starts 16 rows = 2,048 bytes into it.
// The A operand of P V, p^T dO and ds^T Q comes from registers: a
// warpgroup's m64 x k16 A fragment is mma.sync's m16 x k16 fragment per
// warp, and its m64 x nN accumulator is mma.sync's m16 x n8 accumulator per
// warp repeated along N, so an S accumulator is, packed to bf16, the A
// operand of the next product.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA data to come
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the completion of the barrier's phase of parity `parity`, then
// reconverges the warp (the wgmma that follows a wait is warp-aligned)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
  __syncwarp();
}

// -- TMA ---------------------------------------------------------------------
// box (64 columns, rows, 1, 1) of a [B, S, H, D] tensor at (column c, row
// s, head h, batch b) -> dst, completing `bytes` on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(s), "r"(h), "r"(b)
      : "memory");
}

// -- warpgroups --------------------------------------------------------------
// named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: wait for
// all n, or count this warp's threads among them and go on
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties an accumulator to its place in the program, so that the compiler
// neither reads it before the wgmma that writes it has been waited for nor
// writes it while one is in flight
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// the same for register A fragments, which a wgmma in flight reads: they
// stay allocated to the fragment until the wait after it
template <int N>
__device__ __forceinline__ void fence_frag(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// ties a value to its place in the program: the work that computes it is
// issued before what follows (a wgmma wait, so that it runs while the
// tensor cores do)
__device__ __forceinline__ void fence_reg(unsigned& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// the matrix descriptor of a 128-byte-swizzled operand starting at p:
// `lead` and `stride` are the byte offsets between swizzle atoms along the
// operand's leading dimension and between 8-row groups
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lead,
                                              unsigned stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lead & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((stride & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

// a K-major panel operand at k-step kk of a [rows][64] panel
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* panel,
                                           int kk) {
  return gmma_desc(panel + 16 * kk, 16, 1024);
}

// an MN-major panel operand (one n64 product) at k-step kk; the offset
// between atoms along N is not read for n64, and 8-row groups along K are
// 1,024 bytes apart
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* panel,
                                            int kk) {
  return gmma_desc(panel + 16 * 64 * kk, 1024, 1024);
}

// d (m64 x n32 f32) = (scale_d ? d : 0) + A (m64 x k16, shared, K-major)
// . B (k16 x n32, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64 f32) = (scale_d ? d : 0) + A (m64 x k16, shared, K-major)
// . B (k16 x n64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n128 f32) = (scale_d ? d : 0) + A (m64 x k16, shared, K-major)
// . B (k16 x n128, shared, K-major): the forward's 128-key score tiles
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64 f32) += A (m64 x k16, registers) . B (k16 x n64, shared,
// MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const unsigned (&a)[4], uint64_t db) {
  const int scale_d = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// -- host: tensor maps -------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime already loaded
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the map of a bf16 [B, S, H, D] tensor at p, read through its (batch,
// seq, head) element strides, in boxes of 64 columns x `rows` rows of one
// (batch, head), 128-byte swizzled; columns past D and rows past S read as
// zeros
inline cudaError_t tile_map(CUtensorMap* map, const void* p,
                            const long long* strides, int batch, int seq,
                            int heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
