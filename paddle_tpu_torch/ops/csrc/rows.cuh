// Building blocks shared by the port's row kernels (rms_norm.cu,
// layer_norm.cu, softmax.cu): blocks of eight warps with one warp on a row,
// f32 math on f32 or bf16 elements, warp sums by shuffles, bf16 rows as
// 16-byte vectors, a weight row read as 16-byte vectors, and the grid sized
// to the card that the norm backwards walk, with the block's dw partial
// summed in warp order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// the 8 bf16 values of a 16-byte vector as f32
__device__ __forceinline__ void unpack8(float out[8], const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 f32 values rounded to bf16 into a 16-byte vector
__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

// w[8 c .. 8 c + 7] as f32 in 16-byte loads (zeros when c >= nc); w is read
// again for every row, from L1, so that it takes no registers across rows
__device__ __forceinline__ void load8(float out[8],
                                      const __nv_bfloat16* __restrict__ w,
                                      int c, int nc) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (c < nc) v = __ldg(reinterpret_cast<const uint4*>(w) + c);
  unpack8(out, v);
}

__device__ __forceinline__ void load8(float out[8],
                                      const float* __restrict__ w, int c,
                                      int nc) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (c < nc) {
    a = __ldg(reinterpret_cast<const float4*>(w) + 2 * c);
    b = __ldg(reinterpret_cast<const float4*>(w) + 2 * c + 1);
  }
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// One f32 partial row of a column sum (dw or db): each lane holds its sums
// for the columns of its NV 16-byte vectors (lane + 32 i); the block's
// warps add theirs through shared memory in warp order into dst[0, h).
// Every thread of the block must call it; ``sums`` is free again once it
// returns.
template <int NV>
__device__ __forceinline__ void block_partial(float (*sums)[NV * 32 * 8],
                                              const float (&acc)[NV][8],
                                              float* __restrict__ dst,
                                              int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float4* d = reinterpret_cast<float4*>(&sums[warp][8 * (lane + 32 * i)]);
    d[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    d[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < h; c += kThreads) {
    float total = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) total += sums[v][c];
    dst[c] = total;
  }
  __syncthreads();
}

// A grid sized to the current device: about blocks_per_sm blocks per SM
// (fewer for short inputs: at least one row per warp), each a contiguous
// run of rows_per_block of the n rows; *blocks is the number of blocks,
// which is also the number of partial rows a column sum writes.
inline cudaError_t card_grid(int n, int blocks_per_sm, int* blocks,
                             int* rows_per_block) {
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& count = sms[dev & 63];
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int most = blocks_per_sm * count, least = (n + kWarps - 1) / kWarps;
  const int want = least < most ? least : most;
  *rows_per_block = (n + want - 1) / want;
  *blocks = (n + *rows_per_block - 1) / *rows_per_block;
  return cudaSuccess;
}

// whether every pointer is 16-byte aligned (the vector passes' loads)
inline bool aligned16(const void* a, const void* b,
                      const void* c = nullptr, const void* d = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

}  // namespace
