// Ragged paged attention for NVIDIA Hopper (sm_90a): the kernel body shared
// by the plain entry (ragged_paged_attention.cu, f32/bf16 pages) and the
// fused-dequant entry (ragged_paged_attention_quant.cu, int8/fp8 pages with
// per-row f32 scales).  One template, so the online-softmax code of the two
// cannot drift apart — the role the TPU kernels' shared `_attend_page`
// plays in paddle_tpu/ops/pallas/paged_attention.py.
//
//   q          [S, Qmax, Hq, D]   T = f32 | bf16, contiguous
//   k_pages    [Hkv, NP, ps, D]   S = T (plain) | int8 | fp8 e4m3 (quant)
//   v_pages    [Hkv, NP, ps, D]
//   k_scales   [Hkv, NP, ps] f32  quant only: one scale per stored row
//   v_scales   [Hkv, NP, ps] f32
//   page_table [S, P]  int32      physical page of each logical page
//   q_start    [S]     int32      absolute position of query 0
//   q_len      [S]     int32      valid queries (0 = inactive slot)
//   kv_len     [S]     int32      valid KV tokens, segment included
//   out        [S, Qmax, Hq, D]   f32 | bf16
//
// Query j of slot s sits at position q_start[s] + j and attends KV
// positions col <= q_start[s] + j with col < kv_len[s].  Row r of a
// (slot, kv head) group is query r / rep of q head h * rep + r % rep
// (rep = Hq / Hkv).  Math is f32 throughout (q, k, v upcast; a quantized
// element becomes float(code) * scale[row] in registers right before it is
// used, the TPU kernel's dequant expression; running max, denominator and
// accumulator in f32); a row that sees no valid position (padding rows,
// q_len = 0 slots) comes out as exact zeros.
//
// What bounds it on the card: at decode every K/V byte of a slot's cache
// is read once per kv head and used by one query row per q head of the
// group (rep rows), so the kernel is bound by the K/V bytes read from
// device memory (3.35 TB/s on an H100 SXM) — codes plus scales for
// quantized pages — not by arithmetic.  The design follows from that:
//   * one block per (row tile, kv head, slot): the GQA group's query rows
//     share each K/V load, and K/V are never materialized per q head;
//   * the TPU's sequential page grid axis becomes a loop inside the block
//     that walks only the slot's own tokens, stopping at the tile's causal
//     frontier min(kv_len, q_start + last query + 1); table entries past
//     the slot's pages are never dereferenced;
//   * the eight warps of a block split the token range (warp w takes the
//     32-token chunks w, w + 8, ...), so a decode block with a single query
//     row still keeps eight warps of loads in flight (measured on an H100:
//     four warps took twice as long at decode — the loop is bound by load
//     latency, not bandwidth); the warps' online-softmax partials merge
//     once at the end through shared memory;
//   * each lane owns one token of a chunk for the scores (16-byte loads of
//     its K row — 4 f32, 8 bf16 or 16 one-byte codes — reused by every
//     query row of the tile), and D / 32 contiguous output dims for P @ V
//     (coalesced V rows, loaded eight tokens at a time so the loads overlap
//     instead of queueing);
//   * the page table is read by the block itself (the TPU used scalar
//     prefetch): one entry per token by the lane that owns the token,
//     handed to the other lanes by shuffle.  A quantized page's two scale
//     rows go through the same lookup (same page, same offset, the scale
//     pages' own [Hkv, NP, ps] stride): the owning lane reads the K and V
//     scale of its token, and the V scale travels with the row by shuffle.
// Tensor cores (wgmma) and TMA staging are left for later work: this
// version favours a simple, checkable structure.
//
// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;               // query rows per block tile
constexpr int kPV = 8;                 // V rows loaded together in P @ V
constexpr float kNegInf = -1e30f;      // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// N contiguous elements at p (aligned to N * sizeof(T)) -> f32.
template <typename T, int N>
struct Load;

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <>
struct Load<float, 2> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x; o[1] = v.y;
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x; o[1] = f.y;
  }
};

// one-byte codes: N of them arrive in one N-byte load
template <int N> struct Bytes;
template <> struct Bytes<16> { using type = uint4; };
template <> struct Bytes<4> { using type = unsigned int; };
template <> struct Bytes<2> { using type = unsigned short; };

__device__ __forceinline__ float code_f32(int8_t c) { return static_cast<float>(c); }
// e4m3 -> f32 is exact (through f16, cvt.rn.f16x2.e4m3x2 on sm_90)
__device__ __forceinline__ float code_f32(__nv_fp8_e4m3 c) { return static_cast<float>(c); }

template <typename S, int N>
struct LoadCodes {
  static __device__ __forceinline__ void run(const S* p, float* o) {
    using V = typename Bytes<N>::type;
    const V u = __ldg(reinterpret_cast<const V*>(p));
    const S* c = reinterpret_cast<const S*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = code_f32(c[i]);
  }
};

template <int N> struct Load<int8_t, N> : LoadCodes<int8_t, N> {};
template <int N> struct Load<__nv_fp8_e4m3, N> : LoadCodes<__nv_fp8_e4m3, N> {};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// T: q element type; S: page element type (T itself, or a one-byte code
// dequantized by k_scales / v_scales); TO: output element type.
template <typename T, typename S, typename TO, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const S* __restrict__ k_pages,
                              const S* __restrict__ v_pages,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              const int* __restrict__ page_table,
                              const int* __restrict__ q_start,
                              const int* __restrict__ q_len,
                              const int* __restrict__ kv_len,
                              TO* __restrict__ out,
                              int qmax, int hq, int hkv, int num_pages,
                              int page_size, int table_width, float sm_scale) {
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int DPL = D / 32;               // output dims owned by a lane
  constexpr int KV = 16 / sizeof(S);        // elements per 16-byte K load
  __shared__ __align__(16) float q_s[kRows][D];
  __shared__ float red_m[kWarps][kRows];
  __shared__ float red_l[kWarps][kRows];
  __shared__ __align__(16) float red_acc[kWarps][kRows][D];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = hq / hkv;
  const int row0 = tile * kRows;
  const int nrows = min(kRows, qmax * rep - row0);
  const int qs0 = q_start[s];
  // rows are ordered by query index, so the tile's real rows (query index
  // < q_len) are a prefix of it; the rest are written as zeros
  const int nvalid = max(0, min(nrows, q_len[s] * rep - row0));
  // causal frontier of the tile's last real row; never past the slot's
  // page-table row (the TPU grid covered only its P pages too)
  const int kv_end = nvalid > 0
      ? min(min(kv_len[s], qs0 + (row0 + nvalid - 1) / rep + 1),
            table_width * page_size)
      : 0;

  for (int i = threadIdx.x; i < nvalid * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int rg = row0 + r;
    const int head = h * rep + rg % rep;
    q_s[r][d] = to_f32(q[((size_t)(s * qmax + rg / rep) * hq + head) * D + d]);
  }
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][DPL];
  int frontier[kRows];                      // last visible position per row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
    frontier[r] = r < nvalid ? qs0 + (row0 + r) / rep : -1;
  }

  // pool rows of this kv head start here, in the pages and (one f32 per
  // row) in the scale pages
  const size_t scale_base = (size_t)h * num_pages * page_size;
  const size_t head_base = scale_base * D;
  const int* pt = page_table + (size_t)s * table_width;

  for (int c0 = warp * 32; c0 < kv_end; c0 += kWarps * 32) {
    const int t = c0 + lane;
    // lane j looks up the pool row (page * ps + offset) of token c0 + j
    // once; the P @ V loop below takes it by shuffle
    const int row_off =
        t < kv_end ? pt[t / page_size] * page_size + t % page_size : 0;
    float k_sc = 1.f, v_sc = 1.f;
    if constexpr (kQuant) {
      if (t < kv_end) {
        k_sc = __ldg(k_scales + scale_base + row_off);
        v_sc = __ldg(v_scales + scale_base + row_off);
      }
    }
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    if (t < kv_end) {
      const S* kp = k_pages + head_base + (size_t)row_off * D;
#pragma unroll 4
      for (int d = 0; d < D; d += KV) {
        float kv[KV];
        Load<S, KV>::run(kp + d, kv);
        if constexpr (kQuant) {
#pragma unroll
          for (int e = 0; e < KV; ++e) kv[e] *= k_sc;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nvalid) {
#pragma unroll
            for (int e = 0; e < KV; ++e) sc[r] = fmaf(q_s[r][d + e], kv[e], sc[r]);
          }
        }
      }
    }
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = 0.f;
      if (r < nvalid) {                      // block-uniform branch
        const bool ok = t < kv_end && t <= frontier[r];
        const float sv = ok ? sc[r] * sm_scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sv));
        // p re-masked explicitly: on a row with nothing visible yet,
        // exp(NEG_INF - NEG_INF) would be 1
        p[r] = ok ? expf(sv - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = alpha * l[r] + warp_sum(p[r]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
      }
    }
    // P @ V in groups of kPV tokens: the group's V rows are all loaded
    // before any is used, so kPV loads are in flight at once.  Tokens past
    // the chunk's end load nothing and carry p = 0.
    const int nt = min(32, kv_end - c0);
    for (int j0 = 0; j0 < nt; j0 += kPV) {
      float vv[kPV][DPL];
#pragma unroll
      for (int u = 0; u < kPV; ++u) {
        const int j = j0 + u;
        const int ro = __shfl_sync(kFull, row_off, j);
        const float vs = kQuant ? __shfl_sync(kFull, v_sc, j) : 1.f;
        if (j < nt) {
          Load<S, DPL>::run(v_pages + head_base + (size_t)ro * D + lane * DPL,
                            vv[u]);
          if constexpr (kQuant) {
#pragma unroll
            for (int e = 0; e < DPL; ++e) vv[u][e] *= vs;
          }
        } else {
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kPV; ++u) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nvalid) {
            const float pj = __shfl_sync(kFull, p[r], j0 + u);
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              acc[r][e] = fmaf(pj, vv[u][e], acc[r][e]);
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nvalid) {
      if (lane == 0) {
        red_m[warp][r] = m[r];
        red_l[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) red_acc[warp][r][lane * DPL + e] = acc[r][e];
    }
  }
  __syncthreads();

  for (int r = warp; r < nrows; r += kWarps) {
    const int rg = row0 + r;
    const int head = h * rep + rg % rep;
    TO* o = out + ((size_t)(s * qmax + rg / rep) * hq + head) * D + lane * DPL;
    float res[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) res[e] = 0.f;
    if (r < nvalid) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][r]);
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float scale = expf(red_m[w][r] - mx);
        den += red_l[w][r] * scale;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          res[e] = fmaf(red_acc[w][r][lane * DPL + e], scale, res[e]);
      }
      const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) res[e] *= inv;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) store(o + e, res[e]);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;                    // null for the plain kernel
  const float* v_scales;
  const int* page_table;
  const int* q_start;
  const int* q_len;
  const int* kv_len;
  void* out;
  int s_slots, qmax, hq, hkv, num_pages, page_size, table_width;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename S, typename TO, int D>
cudaError_t launch(const Args& a) {
  const int rows = a.qmax * (a.hq / a.hkv);
  const dim3 grid((rows + kRows - 1) / kRows, a.hkv, a.s_slots);
  ragged_paged_attention_kernel<T, S, TO, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.k_scales, a.v_scales, a.page_table,
      a.q_start, a.q_len, a.kv_len, static_cast<TO*>(a.out), a.qmax, a.hq,
      a.hkv, a.num_pages, a.page_size, a.table_width, a.sm_scale);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <typename T, typename S>
cudaError_t launch_out(int head_dim, int out_dtype, const Args& a) {
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  if (out_dtype == 0)
    return head_dim == 64 ? launch<T, S, float, 64>(a)
                          : launch<T, S, float, 128>(a);
  if (out_dtype == 1)
    return head_dim == 64 ? launch<T, S, __nv_bfloat16, 64>(a)
                          : launch<T, S, __nv_bfloat16, 128>(a);
  return cudaErrorInvalidValue;
}

// the checks every entry makes before it launches anything
inline bool valid_geometry(int hq, int hkv, int page_size) {
  return hkv > 0 && hq % hkv == 0 && page_size > 0;
}

}  // namespace
