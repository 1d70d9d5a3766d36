// Ragged paged attention for NVIDIA Hopper (sm_90a): the kernel bodies
// shared by the plain entry (ragged_paged_attention.cu, f32/bf16 pages) and
// the fused-dequant entry (ragged_paged_attention_quant.cu, int8/fp8 pages
// with per-row f32 scales).  One set of templates over the page type, so the
// online-softmax code of the two cannot drift apart — the role the TPU
// kernels' shared `_attend_page` plays in
// paddle_tpu/ops/pallas/paged_attention.py.
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
// (rep = Hq / Hkv).  Running max, denominator and accumulator are f32, the
// softmax in base 2 (scores times sm_scale * log2 e, then exp2); a row that
// sees no valid position (padding rows, q_len = 0 slots) comes out as exact
// zeros.
//
// What bounds it on the card: at decode every K/V byte of a slot's cache
// is read once per kv head and used by one query row per q head of the
// group (rep rows), so the kernel is bound by the K/V bytes read from
// device memory (3.35 TB/s on an H100 SXM) — codes plus scales for
// quantized pages; 9.8 us for 7B's four decode slots of 96-1,040 tokens.
// A prefill chunk reuses each K/V row for up to 256 query rows and is
// bound by its products.  The design:
//   * Split-KV (flash-decoding).  The grid is (KV split, row tile x kv
//     head, slot); a block walks only its split's tokens, up to the tile's
//     causal frontier min(kv_len, q_start + last row + 1), so a decode step
//     of 4 slots x 32 kv heads fills the card with several blocks per SM
//     instead of one.  The host picks the split count from shapes it knows
//     (the table's width, slots, kv heads, row tiles), never from kv_len,
//     so the launch never waits on the device.  With more than one split a
//     block writes its rows' partial state (max m, denominator l and the
//     unnormalized f32 accumulator, or l = 0 for an empty range) to a
//     workspace, and ragged_paged_attention_combine_kernel merges the
//     splits in a fixed order (deterministic) and writes zeros for rows
//     past q_len; with one split the main kernel writes `out` itself.
//   * Pages staged through shared memory.  Tokens go in chunks of
//     aligned 8-token groups, each inside one page (page_size is a multiple
//     of 8), so the page-table entry is read once per group (once per page
//     at page 16) and each group's K and V rows are one contiguous run
//     fetched with 16-byte cp.async, neighbouring lanes on neighbouring
//     addresses.  A warp reads the entries of its next 32 groups at once,
//     a batch ahead and without waiting for kv_len (entries inside the
//     table are always readable), so no copy waits on the table.  A ring of
//     RPA_STAGES chunks lets the next chunk's copy overlap this chunk's
//     scores and P V.  Rows past the range are zero-filled and their pages
//     never read.
//   * One row a group (decode without GQA), or a few rows with f32 q:
//     ragged_paged_attention_kernel, on the CUDA cores, with tiles of 1 or
//     kRows rows, so that decode holds no registers for rows it does not
//     have.  Each of RPA_WARPS warps walks its own chunks (w, w +
//     RPA_WARPS, ...) through its own ring, so the loop needs no block
//     barrier; lane pair (j, j + 16) scores token j, each lane over half
//     of D (K rows XOR-swizzled in 16-byte units, so the 8 lanes of a
//     shared-memory phase hit distinct banks, and q is a broadcast), and
//     each lane owns D / 32 output dims of P V.  A quantized element
//     becomes float(code) * scale[row] in registers right before use, the
//     TPU kernel's f32 dequant expression (int8 converted by a byte
//     permute and an add, not the quarter-rate I2F).  The warps'
//     online-softmax states merge once at the end through shared memory.
//   * A group of 2 rows or more with bf16 q (verify, GQA decode, the
//     prefill chunk, the suffix prefill): ragged_paged_attention_mma_kernel,
//     64-row tiles on the tensor cores with mma.sync m16n8k16 and f32
//     accumulation, as the flash-attention forward (flash_attention.cu
//     fa_fwd_mma_kernel): each of 4 warps owns 16 rows and keeps their S,
//     P and O in registers (a warp whose rows are all padding only
//     copies); Q and the 64-token K/V tiles are ldmatrix fragments of
//     swizzled shared tiles, K/V arriving through the page table into the
//     cp.async ring.  Five verify rows on tensor cores beat them on CUDA
//     cores (phase 5's design steps).  One-byte codes are dequantized to
//     bf16 in shared memory (bf16(code * scale), the rounding the plain
//     version and JAX's reference make) before ldmatrix.  p enters P V as
//     a hi + lo bf16 pair (2^-16 relative), so an f32 output keeps f32
//     accuracy.

// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "sm90_mma.cuh"

// Compile-time settings, measured in phase 5 of chip_smoke.py (which builds
// variants of them for that measurement only; the port loads the defaults).
#ifndef RPA_WARPS
#define RPA_WARPS 4            // warps of a CUDA-core block
#endif
#ifndef RPA_STAGES
#define RPA_STAGES 2           // depth of the K / V rings (>= 2)
#endif

namespace {

constexpr int kRows = 8;               // query rows of a CUDA-core tile (1
                                       // for a one-row group: decode, MHA)
constexpr int kChunk = 16;             // tokens of a CUDA-core ring stage
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows of a tensor-core tile
constexpr int kKeyTile = 64;           // tokens of a tensor-core ring stage
constexpr float kNegInf = -1e30f;      // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
static_assert(RPA_STAGES >= 2, "the rings hold at least two stages");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(x, y);
}

// Element k of a 32-bit word holding 4 / sizeof(S) elements of S, as f32
// (exact: bf16 by a shift, int8 by a byte permute and an add, e4m3
// through f16 by cvt.rn.f16x2.e4m3x2).
template <typename S>
__device__ __forceinline__ float word_f32(unsigned w, int k);
template <>
__device__ __forceinline__ float word_f32<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_f32<__nv_bfloat16>(unsigned w, int k) {
  return __uint_as_float(k ? w & 0xffff0000u : w << 16);
}
// int8 without I2F (a quarter-rate instruction): byte k offset by 128
// lands in the low mantissa of 2^23 by one byte permute, and one add takes
// 2^23 + 128 off again — exact for every code
template <>
__device__ __forceinline__ float word_f32<int8_t>(unsigned w, int k) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7540 + k)) - 8388736.f;
}
template <>
__device__ __forceinline__ float word_f32<__nv_fp8_e4m3>(unsigned w, int k) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> (16 * (k / 2))), __NV_E4M3);
  __half_raw r;
  r.x = k % 2 ? h.y : h.x;
  return __half2float(__half(r));
}

// N elements of S at p (aligned to N * sizeof(S): 2, 4, 8 or 16 bytes) ->
// f32, with no local array in memory
template <typename S, int N>
__device__ __forceinline__ void load_f32(const S* p, float* o) {
  constexpr int B = N * (int)sizeof(S);
  constexpr int PW = 4 / (int)sizeof(S);    // elements of a 32-bit word
  static_assert(B == 16 || B == 8 || B == 4 || B == 2, "vector width");
  unsigned w[(B + 3) / 4];
  if constexpr (B == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (B == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = word_f32<S>(w[i / PW], i % PW);
}

// The XOR swizzle of a K row's 16-byte chunks in a CUDA-core stage: chunk
// c of token row j sits at chunk c ^ key_swizzle(j), so that the 8 lanes of
// a phase (tokens j .. j + 7, the same logical chunk) hit 8 bank groups.
template <int NCH>
__device__ __forceinline__ int key_swizzle(int j) {
  constexpr int rpl = NCH >= 8 ? 1 : 8 / NCH;    // rows per 128-byte line
  constexpr int mask = (NCH >= 8 ? 8 : NCH) - 1;
  return (j / rpl) & mask;
}

// Where chunk c of row r of a staged tile sits, in 16-byte chunks: plain;
// a CUDA-core K stage (key_swizzle); a tensor-core tile (swz<D>'s
// swizzle, as ldmatrix reads it)
template <int NCH>
struct PlainRows {
  __device__ int operator()(int r, int c) const { return r * NCH + c; }
};
template <int NCH>
struct KeyRows {
  __device__ int operator()(int r, int c) const {
    return r * NCH + (c ^ key_swizzle<NCH>(r));
  }
};
template <int NC>
struct MmaRows {
  __device__ int operator()(int r, int c) const { return r * NC + (c ^ (r & 7)); }
};

// Where a block's rows and tokens are: the tile's real rows (query index <
// q_len; rows are ordered by query, so they are a prefix of the tile), its
// causal frontier, and the split's token range [t_begin, t_end).
struct Tile {
  int s, h, row0, nrows, nvalid, qs0, t_begin, t_end;
  int t_table;      // end of the split within the table: its entries up to
                    // here may be read before kv_len is known

  __device__ Tile(int split, int tile_rows, int qmax, int rep, int hkv,
                  const int* q_start, const int* q_len, const int* kv_len,
                  int table_width, int page_size, int split_len) {
    s = blockIdx.z;
    h = blockIdx.y % hkv;
    row0 = (blockIdx.y / hkv) * tile_rows;
    nrows = min(tile_rows, qmax * rep - row0);
    qs0 = q_start[s];
    nvalid = max(0, min(nrows, q_len[s] * rep - row0));
    // never past the slot's page-table row (the TPU grid covered only its
    // P pages too)
    const int kv_end = nvalid > 0
        ? min(min(kv_len[s], qs0 + (row0 + nvalid - 1) / rep + 1),
              table_width * page_size)
        : 0;
    t_begin = split * split_len;
    t_table = min(t_begin + split_len, table_width * page_size);
    t_end = min(kv_end, t_table);
  }
  // position of the last token row r may see
  __device__ int frontier(int r, int rep) const { return qs0 + (row0 + r) / rep; }
};

// The output and the partials of group row rg of (slot s, kv head h):
// out is [S, Qmax, Hq, D]; partial p = ((split * S + s) * Hkv + h) * R + rg
// with R = Qmax * rep rows, ml[p] = (m, l), acc[p * D ..] the accumulator.
struct Layout {
  int qmax, hq, hkv, rep, s_slots;
  __device__ long long out_row(int s, int h, int rg) const {
    return ((long long)(s * qmax + rg / rep) * hq + h * rep + rg % rep);
  }
  __device__ long long partial(int split, int s, int h, int rg) const {
    return ((long long)(split * s_slots + s) * hkv + h) * qmax * rep + rg;
  }
};

// The pool rows of the page-table groups a warp copies.  The warp's chunk i
// is 16 tokens from first + i * stride: two 8-token groups, each inside
// one page.  Lane l holds the first pool row of group l % 2 of chunk
// 16 b + l / 2 for the current batch b (cur) and for batch b + 1 (next),
// so that a batch's table reads are in flight 16 chunks before they are
// needed and the copies never wait on the table.  A group at or past
// t_table (the split's end in the table) reads no entry; one inside it is
// read even past kv_len (its pages are not: the copies are masked by
// t_end), so the table reads do not wait for kv_len.
struct GroupRows {
  const int* pt;
  int page_size, first, stride, t_table, batch;
  long long cur, next;

  __device__ long long load(int b) const {
    const int lane = threadIdx.x % 32;
    const int t = first + (16 * b + lane / 2) * stride + 8 * (lane & 1);
    return t < t_table
        ? (long long)pt[t / page_size] * page_size + t % page_size : 0;
  }
  __device__ GroupRows(const int* pt_, int page_size_, int first_,
                       int stride_, int t_table_)
      : pt(pt_), page_size(page_size_), first(first_), stride(stride_),
        t_table(t_table_), batch(0) {
    cur = load(0);
    next = load(1);
  }
  // chunk i's two group rows; i is warp-uniform and grows by one a call
  __device__ void rows(int i, long long& g0, long long& g1) {
    if (i / 16 != batch) {
      cur = next;
      next = load(++batch + 1);
    }
    g0 = __shfl_sync(kFull, cur, 2 * (i % 16));
    g1 = __shfl_sync(kFull, cur, 2 * (i % 16) + 1);
  }
};

// One warp copies token rows [t0, t0 + 16) (the groups at pool rows g0 and
// g1) of the block's kv head into shared memory by 16-byte cp.async: chunk
// c of K row r at chunk kswz(r, c), of V row r at vswz(r, c), and (quant)
// the two scales of each row.  Rows at or past t_end are zero-filled.
template <typename S, int D, typename KSwz, typename VSwz>
__device__ __forceinline__ void copy_chunk16(
    unsigned char* k_dst, unsigned char* v_dst, float* ks_dst, float* vs_dst,
    const S* k_head, const S* v_head, const float* ks_head,
    const float* vs_head, long long g0, long long g1, int t0, int t_end,
    KSwz kswz, VSwz vswz) {
  constexpr int NCH = D * (int)sizeof(S) / 16;   // 16-byte chunks of a row
  const int lane = threadIdx.x % 32;
#pragma unroll 8
  for (int i = lane; i < 16 * NCH; i += 32) {
    const int r = i / NCH, c = i % NCH;
    const bool ok = t0 + r < t_end;
    const size_t off =
        ((size_t)((r < 8 ? g0 : g1) + (r & 7)) * D) * sizeof(S) + c * 16;
    cp_async16(k_dst + kswz(r, c) * 16,
               reinterpret_cast<const unsigned char*>(k_head) + off, ok);
    cp_async16(v_dst + vswz(r, c) * 16,
               reinterpret_cast<const unsigned char*>(v_head) + off, ok);
  }
  if constexpr (sizeof(S) == 1) {
    // 8 scales of a group are 32 bytes, 32-byte aligned: lanes 0-3 copy the
    // K scales, 4-7 the V scales, four rows each
    if (lane < 8) {
      const int q4 = lane & 3, r = 4 * q4;
      const bool ok = t0 + r < t_end;
      const long long row = (q4 < 2 ? g0 : g1) + (r & 7);
      if (lane < 4) cp_async16(ks_dst + r, ks_head + row, ok);
      else cp_async16(vs_dst + r, vs_head + row, ok);
    }
  }
}

// -- few rows, CUDA cores ----------------------------------------------------
// T: q element type; S: page element type (T itself, or a one-byte code
// dequantized by k_scales / v_scales); TO: output element type.  R query
// rows a block (kRows, or 1 when a group has one row, so that decode keeps
// no registers for rows it does not have); NW warps, rings of NS 16-token
// stages, one ring a warp.
template <typename S, int D>
struct CoreStage {
  static constexpr int NCH = D * (int)sizeof(S) / 16;     // chunks of a row
  static constexpr int KB = kChunk * D * (int)sizeof(S);  // K (or V) rows
  static constexpr int BYTES = 2 * KB + (sizeof(S) == 1 ? 2 * kChunk * 4 : 0);
};

template <typename T, typename S, int D, int NW, int NS, int R>
constexpr int core_smem() {
  constexpr int ring = NW * NS * CoreStage<S, D>::BYTES;
  constexpr int merge = NW * R * (D + 2) * 4;
  return R * D * (int)sizeof(T) + NW * R * kChunk * 4 +
         (ring > merge ? ring : merge);
}

template <typename T, typename S, typename TO, int D, int NW, int NS, int R>
__global__ void __launch_bounds__(NW * 32, 1)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const S* __restrict__ k_pages,
                              const S* __restrict__ v_pages,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              const int* __restrict__ page_table,
                              const int* __restrict__ q_start,
                              const int* __restrict__ q_len,
                              const int* __restrict__ kv_len,
                              TO* __restrict__ out, float2* __restrict__ ml,
                              float* __restrict__ acc_ws, int qmax, int hq,
                              int hkv, int num_pages, int page_size,
                              int table_width, int split_len, int n_splits,
                              float sm_scale) {
  using St = CoreStage<S, D>;
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int DPL = D / 32;               // output dims owned by a lane
  constexpr int NCH = St::NCH;
  constexpr int E = 16 / (int)sizeof(S);    // elements of a 16-byte chunk
  constexpr int QV = 16 / (int)sizeof(T);   // q elements of a 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                 // [R][D]
  float* p_s = reinterpret_cast<float*>(q_s + R * D);  // [NW][R][16]
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      p_s + NW * R * kChunk);               // [NW][NS] stages

  const int rep = hq / hkv;
  const Tile tl(blockIdx.x, R, qmax, rep, hkv, q_start, q_len, kv_len,
                table_width, page_size, split_len);
  const Layout lay{qmax, hq, hkv, rep, (int)gridDim.z};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool split = n_splits > 1;
  if (split && tl.t_begin >= tl.t_end) {    // nothing here: an empty partial
    for (int r = threadIdx.x; r < tl.nvalid; r += NW * 32)
      ml[lay.partial(blockIdx.x, tl.s, tl.h, tl.row0 + r)] =
          make_float2(kNegInf, 0.f);
    return;
  }

  // pool rows of this kv head start here, in the pages and (one f32 per
  // row) in the scale pages
  const size_t scale_base = (size_t)tl.h * num_pages * page_size;
  const S* k_head = k_pages + scale_base * D;
  const S* v_head = v_pages + scale_base * D;
  const float* ks_head = kQuant ? k_scales + scale_base : nullptr;
  const float* vs_head = kQuant ? v_scales + scale_base : nullptr;
  const int* pt = page_table + (size_t)tl.s * table_width;
  const int n_chunks = (tl.t_end - tl.t_begin + kChunk - 1) / kChunk;
  const int mine = n_chunks > warp ? (n_chunks - warp + NW - 1) / NW : 0;
  unsigned char* wring = ring + warp * NS * St::BYTES;
  auto chunk_t0 = [&](int i) { return tl.t_begin + (warp + i * NW) * kChunk; };
  GroupRows groups(pt, page_size, chunk_t0(0), NW * kChunk, tl.t_table);
  auto fetch = [&](int i) {
    unsigned char* st = wring + (i % NS) * St::BYTES;
    float* sc = reinterpret_cast<float*>(st + 2 * St::KB);
    long long g0, g1;
    groups.rows(i, g0, g1);
    copy_chunk16<S, D>(st, st + St::KB, sc, sc + kChunk, k_head, v_head,
                       ks_head, vs_head, g0, g1, chunk_t0(i), tl.t_end,
                       KeyRows<NCH>(), PlainRows<NCH>());
  };
  // the K / V copies go first: the q rows' load overlaps them
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < mine) fetch(i);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < tl.nvalid * D / QV; i += NW * 32) {
    const int r = i / (D / QV), c = i % (D / QV);
    *reinterpret_cast<uint4*>(q_s + r * D + c * QV) =
        *reinterpret_cast<const uint4*>(
            q + lay.out_row(tl.s, tl.h, tl.row0 + r) * D + c * QV);
  }
  __syncthreads();

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;                             // this lane's tokens only
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  const float scale2 = sm_scale * kLog2e;
  const int j = lane & 15, half = lane >> 4;  // lanes j, j + 16: token j
  float* pw = p_s + warp * R * kChunk;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<NS - 2>();                // this lane's copies of chunk i
    __syncwarp();                           // ... and the others'; chunk
                                            // i - 1's stage is free
    if (i + NS - 1 < mine) fetch(i + NS - 1);
    cp_async_commit();
    const unsigned char* st = wring + (i % NS) * St::BYTES;
    const S* ks = reinterpret_cast<const S*>(st);
    const S* vs = reinterpret_cast<const S*>(st + St::KB);
    const float* k_sc = reinterpret_cast<const float*>(st + 2 * St::KB);
    const float* v_sc = k_sc + kChunk;

    // scores of token j over this lane's half of D
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    const float ksj = kQuant ? k_sc[j] : 1.f;
#pragma unroll
    for (int cc = 0; cc < NCH / 2; ++cc) {
      const int c = half * (NCH / 2) + cc;
      float kv[E];
      load_f32<S, E>(ks + (j * NCH + (c ^ key_swizzle<NCH>(j))) * E, kv);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] *= ksj;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < tl.nvalid) {              // block-uniform branch
#pragma unroll
          for (int e0 = 0; e0 < E; e0 += QV) {
            float qv[QV];
            load_f32<T, QV>(q_s + r * D + c * E + e0, qv);
#pragma unroll
            for (int e = 0; e < QV; ++e)
              sc[r] = fmaf(qv[e], kv[e0 + e], sc[r]);
          }
        }
      }
    }
    const int t = chunk_t0(i) + j;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < tl.nvalid) {
        sc[r] += __shfl_xor_sync(kFull, sc[r], 16);
        const bool ok = t < tl.t_end && t <= tl.frontier(r, rep);
        const float sv = ok ? sc[r] * scale2 : kNegInf;
        float cm = sv;                    // max over the 16 tokens
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
        const float m_new = fmaxf(m[r], cm);
        // p re-masked explicitly: on a row with nothing visible yet,
        // exp2(NEG_INF - NEG_INF) would be 1
        const float p = ok ? exp2f(sv - m_new) : 0.f;
        const float alpha = exp2f(m[r] - m_new);
        l[r] = alpha * l[r] + (half == 0 ? p : 0.f);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
        if (half == 0) pw[r * kChunk + j] = p;
      }
    }
    __syncwarp();
    // P V: this lane's D / 32 dims of each token's V row (zero-filled
    // past the range, where p is 0)
#pragma unroll 4
    for (int v = 0; v < kChunk; ++v) {
      float vv[DPL];
      load_f32<S, DPL>(vs + v * D + lane * DPL, vv);
      if constexpr (kQuant) {
        const float vsv = v_sc[v];
#pragma unroll
        for (int e = 0; e < DPL; ++e) vv[e] *= vsv;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < tl.nvalid) {
          const float pv = pw[r * kChunk + v];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pv, vv[e], acc[r][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the merge buffers alias the rings

  // merge the warps' online-softmax states
  float* red_m = reinterpret_cast<float*>(ring);          // [NW][R]
  float* red_l = red_m + NW * R;                      // [NW][R]
  float* red_acc = red_l + NW * R;                    // [NW][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < tl.nvalid) {
      const float lw = warp_sum(l[r]);
      if (lane == 0) {
        red_m[warp * R + r] = m[r];
        red_l[warp * R + r] = lw;
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        red_acc[(warp * R + r) * D + lane * DPL + e] = acc[r][e];
    }
  }
  __syncthreads();

  for (int r = warp; r < tl.nrows; r += NW) {
    const int rg = tl.row0 + r;
    float res[DPL], mx = kNegInf, den = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) res[e] = 0.f;
    if (r < tl.nvalid) {
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_m[w * R + r]);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float scale = exp2f(red_m[w * R + r] - mx);
        den += red_l[w * R + r] * scale;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          res[e] = fmaf(red_acc[(w * R + r) * D + lane * DPL + e], scale,
                        res[e]);
      }
    }
    if (!split) {
      const float inv = den > 0.f ? 1.f / den : 0.f;
      TO* o = out + lay.out_row(tl.s, tl.h, rg) * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) store(o + e, res[e] * inv);
    } else if (r < tl.nvalid) {
      const long long p = lay.partial(blockIdx.x, tl.s, tl.h, rg);
      if (lane == 0) ml[p] = make_float2(mx, den);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc_ws[p * D + lane * DPL + e] = res[e];
    }
  }
}

// -- 64-row tiles, tensor cores (bf16 q) -------------------------------------
template <typename S, int D>
struct MmaStage {
  static constexpr int RAW = kKeyTile * D * (int)sizeof(S);  // K (or V) tile
  static constexpr int BYTES = 2 * RAW + (sizeof(S) == 1 ? 2 * kKeyTile * 4 : 0);
};

template <typename S, int D, int NS>
constexpr int mma_smem() {
  return kMmaRows * D * 2 + NS * MmaStage<S, D>::BYTES +
         (sizeof(S) == 1 ? 2 * kKeyTile * D * 2 : 0);
}

template <typename S, typename TO, int D, int NS>
__global__ void __launch_bounds__(kMmaWarps * 32)
ragged_paged_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const S* __restrict__ k_pages,
                                  const S* __restrict__ v_pages,
                                  const float* __restrict__ k_scales,
                                  const float* __restrict__ v_scales,
                                  const int* __restrict__ page_table,
                                  const int* __restrict__ q_start,
                                  const int* __restrict__ q_len,
                                  const int* __restrict__ kv_len,
                                  TO* __restrict__ out,
                                  float2* __restrict__ ml,
                                  float* __restrict__ acc_ws, int qmax,
                                  int hq, int hkv, int num_pages,
                                  int page_size, int table_width,
                                  int split_len, int n_splits,
                                  float sm_scale) {
  using St = MmaStage<S, D>;
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int NTHR = kMmaWarps * 32, BN = kKeyTile;
  constexpr int KS = D / 16;                // k-steps of Q K^T
  constexpr int NO = D / 8;                 // n-tiles of O
  constexpr int NC = D / 8;                 // 16-byte chunks of a bf16 row
  constexpr int NCH = D * (int)sizeof(S) / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][D]
  unsigned char* ring = smem_raw + kMmaRows * D * 2;                // NS stages
  // quant: the stage's codes dequantized to bf16, [BN][D] K then V
  __nv_bfloat16* kd_s = reinterpret_cast<__nv_bfloat16*>(ring + NS * St::BYTES);
  __nv_bfloat16* vd_s = kd_s + BN * D;

  const int rep = hq / hkv;
  const Tile tl(blockIdx.x, kMmaRows, qmax, rep, hkv, q_start, q_len, kv_len,
                table_width, page_size, split_len);
  const Layout lay{qmax, hq, hkv, rep, (int)gridDim.z};
  const bool split = n_splits > 1;
  if (split && tl.t_begin >= tl.t_end) {    // nothing here: an empty partial
    for (int r = threadIdx.x; r < tl.nvalid; r += NTHR)
      ml[lay.partial(blockIdx.x, tl.s, tl.h, tl.row0 + r)] =
          make_float2(kNegInf, 0.f);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;               // the warp's first row of the tile

  const size_t scale_base = (size_t)tl.h * num_pages * page_size;
  const S* k_head = k_pages + scale_base * D;
  const S* v_head = v_pages + scale_base * D;
  const float* ks_head = kQuant ? k_scales + scale_base : nullptr;
  const float* vs_head = kQuant ? v_scales + scale_base : nullptr;
  const int* pt = page_table + (size_t)tl.s * table_width;
  const int n_kt = (tl.t_end - tl.t_begin + BN - 1) / BN;
  // warp w copies tokens 16 w .. 16 w + 15 of a key tile (16 w is a
  // multiple of 8, so its rows keep the tile's swizzle phase)
  GroupRows groups(pt, page_size, tl.t_begin + 16 * warp, BN, tl.t_table);
  auto fetch = [&](int kt) {
    unsigned char* st = ring + (kt % NS) * St::BYTES;
    float* sc = reinterpret_cast<float*>(st + 2 * St::RAW) + 16 * warp;
    const int off = 16 * warp * D * (int)sizeof(S);
    const int t0 = tl.t_begin + kt * BN + 16 * warp;
    long long g0, g1;
    groups.rows(kt, g0, g1);
    // codes land plain (the dequant pass swizzles); bf16 rows swizzled,
    // as ldmatrix reads them
    using Rows = typename std::conditional<kQuant, PlainRows<NCH>,
                                           MmaRows<NC>>::type;
    copy_chunk16<S, D>(st + off, st + St::RAW + off, sc, sc + BN, k_head,
                       v_head, ks_head, vs_head, g0, g1, t0, tl.t_end,
                       Rows(), Rows());
  };

  // group 0: Q (rows past the real ones zero-filled) and key tile 0;
  // groups 1 .. NS - 2: key tiles 1 .. NS - 2
  for (int i = threadIdx.x; i < kMmaRows * NC; i += NTHR) {
    const int r = i / NC, c = i % NC;
    const bool ok = r < tl.nvalid;
    cp_async16(q_s + swz<D>(r, c),
               q + lay.out_row(tl.s, tl.h, tl.row0 + (ok ? r : 0)) * D + c * 8,
               ok);
  }
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_kt) fetch(s);
    cp_async_commit();
  }

  const float scale2 = sm_scale * kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g, g + 8 of the warp; l: this lane's columns only
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<NS - 2>();                // tile kt (and Q) have landed
    __syncthreads();                        // ... for every thread; tile
                                            // kt - 1's stage is free
    if (kt + NS - 1 < n_kt) fetch(kt + NS - 1);
    cp_async_commit();
    const unsigned char* st = ring + (kt % NS) * St::BYTES;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    if constexpr (kQuant) {
      // codes x scale -> bf16 (the plain version's rounding), swizzled
      const float* k_sc = reinterpret_cast<const float*>(st + 2 * St::RAW);
      for (int i = threadIdx.x; i < 2 * BN * (D / 16); i += NTHR) {
        const int which = i / (BN * (D / 16)), ii = i % (BN * (D / 16));
        const int r = ii / (D / 16), c = ii % (D / 16);
        float f[16];
        load_f32<S, 16>(reinterpret_cast<const S*>(st + which * St::RAW) +
                            r * D + c * 16, f);
        const float sc = k_sc[which * BN + r];
        uint4 lo, hi;
        lo.x = pack_bf16(f[0] * sc, f[1] * sc);
        lo.y = pack_bf16(f[2] * sc, f[3] * sc);
        lo.z = pack_bf16(f[4] * sc, f[5] * sc);
        lo.w = pack_bf16(f[6] * sc, f[7] * sc);
        hi.x = pack_bf16(f[8] * sc, f[9] * sc);
        hi.y = pack_bf16(f[10] * sc, f[11] * sc);
        hi.z = pack_bf16(f[12] * sc, f[13] * sc);
        hi.w = pack_bf16(f[14] * sc, f[15] * sc);
        __nv_bfloat16* dst = which ? vd_s : kd_s;
        *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(dst + swz<D>(r, 2 * c + 1)) = hi;
      }
      __syncthreads();
      ks = kd_s;
      vs = vd_s;
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(st);
      vs = reinterpret_cast<const __nv_bfloat16*>(st + St::RAW);
    }

    if (wrow >= tl.nvalid) continue;        // the warp's rows are padding
                                            // (it still copies its share)
    float s[BN / 8][4];
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[4];
      load_a<D>(qa, q_s, wrow, kk);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        unsigned bf[4];
        load_bt<D>(bf, ks, np * 16, kk);
        mma16816(s[2 * np], qa, bf[0], bf[1]);
        mma16816(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }

    // mask a tile that crosses the warp's first row's causal frontier or
    // the end of the range: masked scores become -inf, the others are
    // scaled here; a full tile stays raw and takes the scale in the
    // exponent's FFMA (the scale is positive, so the max commutes with it)
    const int kcol0 = tl.t_begin + kt * BN;
    const bool masked = kcol0 + BN > tl.t_end ||
                        kcol0 + BN - 1 > tl.frontier(wrow, rep);
    if (masked) {
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kcol0 + 8 * jn + 2 * t + (e & 1);
          const int row = wrow + g + 8 * (e >> 1);
          const bool ok = col < tl.t_end && col <= tl.frontier(row, rep);
          s[jn][e] = ok ? s[jn][e] * scale2 : -INFINITY;
        }
    }
    const float sc = masked ? 1.f : scale2;
    float mu[2];                            // the max the exponents use
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        mx = fmaxf(mx, fmaxf(s[jn][2 * r], s[jn][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx * sc);
      // a row with nothing visible yet keeps m = -inf; its exponents use 0
      // so that exp2(-inf - m) is 0, not NaN
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[jn][e], sc, -mu[e >> 1]));
        l[e >> 1] += p;
        s[jn][e] = p;
      }

    // O += P V with P as hi + lo bf16 pairs, the A operand straight from
    // the score fragments
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned bf[4];
        load_b<D>(bf, vs, kk * 16, dp);
        mma16816(acc[2 * dp], ph, bf[0], bf[1]);
        mma16816(acc[2 * dp + 1], ph, bf[2], bf[3]);
        mma16816(acc[2 * dp], pl, bf[0], bf[1]);
        mma16816(acc[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // rows g, g + 8 of the warp: out (one split) or the partial state
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = wrow + g + 8 * r;
    if (row >= tl.nrows) continue;
    const int rg = tl.row0 + row;
    if (!split) {
      const float inv = row < tl.nvalid && l[r] > 0.f ? 1.f / l[r] : 0.f;
      TO* o = out + lay.out_row(tl.s, tl.h, rg) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        store2(o + 8 * n + 2 * t, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    } else if (row < tl.nvalid) {
      const long long p = lay.partial(blockIdx.x, tl.s, tl.h, rg);
      if (t == 0) ml[p] = make_float2(l[r] > 0.f ? m[r] : kNegInf, l[r]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(acc_ws + p * D + 8 * n + 2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// -- the splits' merge ---------------------------------------------------------
// One warp per output row (slot, query, q head), in a fixed split order;
// splits with l = 0 (nothing visible there) are skipped without reading
// their accumulator; rows past q_len come out as zeros.
template <typename TO, int D>
__global__ void __launch_bounds__(256)
ragged_paged_attention_combine_kernel(const float2* __restrict__ ml,
                                      const float* __restrict__ acc_ws,
                                      const int* __restrict__ q_len,
                                      TO* __restrict__ out, int s_slots,
                                      int qmax, int hq, int hkv,
                                      int n_splits) {
  constexpr int DPL = D / 32;
  const long long o = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (o >= (long long)s_slots * qmax * hq) return;
  const int lane = threadIdx.x % 32;
  const int head = o % hq, qi = (o / hq) % qmax, s = o / ((long long)hq * qmax);
  const int rep = hq / hkv;
  const Layout lay{qmax, hq, hkv, rep, s_slots};
  const int h = head / rep, rg = qi * rep + head % rep;
  float res[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) res[e] = 0.f;
  if (qi < q_len[s]) {
    float mx = -INFINITY, den = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float2 v = ml[lay.partial(sp, s, h, rg)];
      if (v.y > 0.f) mx = fmaxf(mx, v.x);
    }
    for (int sp = 0; sp < n_splits; ++sp) {
      const long long p = lay.partial(sp, s, h, rg);
      const float2 v = ml[p];
      if (v.y > 0.f) {
        const float w = exp2f(v.x - mx);
        den = fmaf(v.y, w, den);
        float a[DPL];
        load_f32<float, DPL>(acc_ws + p * D + lane * DPL, a);
#pragma unroll
        for (int e = 0; e < DPL; ++e) res[e] = fmaf(a[e], w, res[e]);
      }
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) res[e] *= inv;
  }
  TO* po = out + o * D + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) store(po + e, res[e]);
}

// -- host side -----------------------------------------------------------------
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
  float2* ml;                               // partials: null with one split
  float* acc;
  int s_slots, qmax, hq, hkv, num_pages, page_size, table_width;
  int row_tile, n_splits, split_len;
  float sm_scale;
  cudaStream_t stream;
};

template <typename TO, int D>
cudaError_t launch_combine(const Args& a) {
  const long long rows = (long long)a.s_slots * a.qmax * a.hq;
  ragged_paged_attention_combine_kernel<TO, D>
      <<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
          a.ml, a.acc, a.q_len, static_cast<TO*>(a.out), a.s_slots, a.qmax,
          a.hq, a.hkv, a.n_splits);
  return cudaGetLastError();
}

template <typename T, typename S, typename TO, int D, int R>
cudaError_t launch_core(const Args& a, dim3 grid) {
  constexpr int smem = core_smem<T, S, D, RPA_WARPS, RPA_STAGES, R>();
  const auto kernel =
      ragged_paged_attention_kernel<T, S, TO, D, RPA_WARPS, RPA_STAGES, R>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(done, kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, RPA_WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.k_scales, a.v_scales, a.page_table,
      a.q_start, a.q_len, a.kv_len, static_cast<TO*>(a.out), a.ml, a.acc,
      a.qmax, a.hq, a.hkv, a.num_pages, a.page_size, a.table_width,
      a.split_len, a.n_splits, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, typename S, typename TO, int D>
cudaError_t launch_mma(const Args& a, dim3 grid) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int smem = mma_smem<S, D, RPA_STAGES>();
    const auto kernel = ragged_paged_attention_mma_kernel<S, TO, D, RPA_STAGES>;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t err = allow_smem(done, kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaWarps * 32, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const S*>(a.k),
        static_cast<const S*>(a.v), a.k_scales, a.v_scales, a.page_table,
        a.q_start, a.q_len, a.kv_len, static_cast<TO*>(a.out), a.ml, a.acc,
        a.qmax, a.hq, a.hkv, a.num_pages, a.page_size, a.table_width,
        a.split_len, a.n_splits, a.sm_scale);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;           // the tensor-core tile takes bf16 q
  }
}

// row_tile: kMmaRows (tensor cores, bf16 q), kRows or 1 (CUDA cores)
template <typename T, typename S, typename TO, int D>
cudaError_t launch(const Args& a) {
  const int rows = a.qmax * (a.hq / a.hkv);
  const dim3 grid(a.n_splits, (rows + a.row_tile - 1) / a.row_tile * a.hkv,
                  a.s_slots);
  cudaError_t err;
  if (a.row_tile == kMmaRows) err = launch_mma<T, S, TO, D>(a, grid);
  else if (a.row_tile == kRows) err = launch_core<T, S, TO, D, kRows>(a, grid);
  else if (a.row_tile == 1) err = launch_core<T, S, TO, D, 1>(a, grid);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess || a.n_splits == 1) return err;
  return launch_combine<TO, D>(a);
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

// the checks every entry makes before it launches anything: the splits
// (split_len tokens each, a multiple of 8 and of the page) cover the table
inline bool valid_geometry(const Args& a) {
  return a.hkv > 0 && a.hq % a.hkv == 0 && a.page_size > 0 &&
         a.page_size % 8 == 0 && a.n_splits >= 1 && a.split_len > 0 &&
         a.split_len % a.page_size == 0 &&
         (long long)a.n_splits * a.split_len >=
             (long long)a.table_width * a.page_size &&
         (a.n_splits == 1 || (a.ml != nullptr && a.acc != nullptr));
}

}  // namespace
