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
//   * Pages staged through shared memory.  Where page_size is a multiple
//     of 8 (the AL = true instantiations), tokens go in chunks of aligned
//     8-token groups, each inside one page, so the page-table entry is read
//     once per group (once per page at page 16) and each group's K and V
//     rows are one contiguous run fetched with 16-byte cp.async,
//     neighbouring lanes on neighbouring addresses.  A warp reads the
//     entries of its next 32 groups at once, a batch ahead and without
//     waiting for kv_len (entries inside the table are always readable), so
//     no copy waits on the table.  Any other page size (AL = false, the
//     sizes 1-7, 12, 20, ... that the TPU kernel takes too) resolves every
//     staged token row through the table on its own (pt[t / ps] * ps + t %
//     ps, one lane a token, two chunks a batch ahead), since the rows of a
//     group may then lie in two pages; the row copies stay 16-byte (a row
//     is whole in its page), the scales of one-byte pages go 4 bytes at a
//     time (a page's scale rows are only 4 * ps-byte aligned).  A ring of
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
//     each lane owns W / 32 output dims of P V.  A quantized element
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
//
// Head dims: as the TPU kernel, any D that is a multiple of 8 up to 256.
// The bodies are compiled at a padded width W (rpa_width: D rounded up to
// a multiple of 32, 224 to 256; a CUDA-core lane owns W / 32 output dims)
// and take the true D at run time: rows are read D elements long from the
// pages, q and out, staged rows are zero-filled from D to W in shared
// memory (scores and P V run over W; the zeros add nothing), and only D
// columns are stored.  A row of one-byte codes whose D is not a multiple
// of 16 is only 8-byte aligned in the pool, so its copies go 8 bytes at a
// time.  Staged rows whose 16-byte chunk count is not a multiple of 8 (nor
// 1, 2 or 4) are padded by one chunk instead of XOR-swizzled, so that no
// chunk leaves its row (sm90_mma.cuh swz for the tensor-core tiles,
// KeyRows for the CUDA-core K stages).  A D that is not a multiple of 8
// would break the 16-byte q and bf16 row copies and is refused.

// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().  A translation unit defines RPA_TU_WIDTHS (its
// widths) and RPA_PLAIN_ENTRIES or RPA_QUANT_ENTRIES, then includes this
// header: ragged_paged_attention{,_quant}.cu hold W 64 and 128, and built
// with -DRPA_TU_WIDTHS=<W> one other width each (ops/_build.py
// WIDTH_LIBRARIES), so that the widths build in parallel.

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

// One element of S as f32
__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float elem_f32(__nv_fp8_e4m3 x) { return float(x); }

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

// N elements of S at p -> f32, with no local array in memory: one vector
// load when N * sizeof(S) is 2, 4, 8 or 16 bytes (p aligned to it), 16-byte
// loads when it is a multiple of 16, else one element at a time
template <typename S, int N>
__device__ __forceinline__ void load_f32(const S* p, float* o) {
  constexpr int B = N * (int)sizeof(S);
  constexpr int PW = 4 / (int)sizeof(S);    // elements of a 32-bit word
  if constexpr (B > 16 && B % 16 == 0) {
    constexpr int V = 16 / (int)sizeof(S);
#pragma unroll
    for (int i = 0; i < N / V; ++i) load_f32<S, V>(p + i * V, o + i * V);
  } else if constexpr (B != 16 && B != 8 && B != 4 && B != 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = elem_f32(p[i]);
  } else {
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
}

// the first n of N elements (n may pass N) as load_f32, zeros after them
template <typename S, int N>
__device__ __forceinline__ void load_f32_n(const S* p, float* o, int n) {
  if (n >= N) {
    load_f32<S, N>(p, o);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = i < n ? elem_f32(p[i]) : 0.f;
}

// the width the bodies are compiled at for a head dim d (a multiple of 8
// up to 256; 0 for any other d)
inline constexpr int rpa_width(int d) {
  return d <= 0 || d % 8 != 0 || d > 256 ? 0
         : d > 192                       ? 256
                                         : (d + 31) / 32 * 32;
}

// The XOR swizzle of a K row's 16-byte chunks in a CUDA-core stage: chunk
// c of token row j sits at chunk c ^ key_swizzle(j), so that the 8 lanes of
// a phase (tokens j .. j + 7, the same logical chunk) hit 8 bank groups.
// It keeps a chunk inside its row when the row has 1, 2 or 4 chunks or a
// multiple of 8; other rows (6, 10, 12, 14 or 20 chunks) are padded by one
// chunk instead, an odd stride that spreads 8 rows over 8 bank groups.
template <int NCH>
constexpr bool kKeyXor = NCH % 8 == 0 || NCH == 1 || NCH == 2 || NCH == 4;
template <int NCH>
__host__ __device__ constexpr int key_ld() {
  return kKeyXor<NCH> ? NCH : NCH + 1;
}

template <int NCH>
__device__ __forceinline__ int key_swizzle(int j) {
  constexpr int rpl = NCH >= 8 ? 1 : 8 / NCH;    // rows per 128-byte line
  constexpr int mask = (NCH >= 8 ? 8 : NCH) - 1;
  return (j / rpl) & mask;
}

// Where chunk c of row r of a staged tile sits, in 16-byte chunks: plain;
// a CUDA-core K stage (key_swizzle, or a padded row); a tensor-core tile
// of width W (swz<W>, as ldmatrix reads it)
template <int NCH>
struct PlainRows {
  __device__ int operator()(int r, int c) const { return r * NCH + c; }
};
template <int NCH>
struct KeyRows {
  __device__ int operator()(int r, int c) const {
    if constexpr (kKeyXor<NCH>) return r * NCH + (c ^ key_swizzle<NCH>(r));
    else return r * (NCH + 1) + c;
  }
};
template <int W>
struct MmaRows {
  __device__ int operator()(int r, int c) const { return swz<W>(r, c) / 8; }
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

// GroupRows for a page size that is not a multiple of 8: the rows of an
// 8-token group may lie in two pages, so each token row is resolved
// through the table on its own.  Lane l holds the pool row of token l % 16
// of chunk 2 b + l / 16 for the current batch b (cur) and for batch b + 1
// (next); a row is fetched from its lane by a shuffle in the copy loop,
// which every lane of the warp runs the same number of times.  Entries
// are read as GroupRows reads them: inside the split's part of the table
// (t_table), without waiting for kv_len.
struct TokenRows {
  const int* pt;
  int page_size, first, stride, t_table, batch;
  long long cur, next;

  __device__ long long load(int b) const {
    const int lane = threadIdx.x % 32;
    const int t = first + (2 * b + lane / 16) * stride + lane % 16;
    return t < t_table
        ? (long long)pt[t / page_size] * page_size + t % page_size : 0;
  }
  __device__ TokenRows(const int* pt_, int page_size_, int first_,
                       int stride_, int t_table_)
      : pt(pt_), page_size(page_size_), first(first_), stride(stride_),
        t_table(t_table_), batch(0) {
    cur = load(0);
    next = load(1);
  }
  struct Pick {
    long long cur;
    int base;
    __device__ long long operator()(int r) const {
      return __shfl_sync(kFull, cur, base + r);
    }
  };
  __device__ Pick rows(int i) {
    if (i / 2 != batch) {
      cur = next;
      next = load(++batch + 1);
    }
    return Pick{cur, 16 * (i % 2)};
  }
};

// the table walk of a kernel instantiation: aligned groups (AL) or rows
template <bool AL>
using RowsOf = typename std::conditional<AL, GroupRows, TokenRows>::type;

// One warp copies token rows [t0, t0 + 16) (the groups at pool rows g0 and
// g1) of the block's kv head into shared memory by 16-byte cp.async: chunk
// c of K row r at chunk kswz(r, c), of V row r at vswz(r, c), and (quant)
// the two scales of each row.  A pool row holds d elements; rows at or
// past t_end, and the chunks of a staged row past d, are zero-filled.
// One-byte rows whose d is not a multiple of 16 are 8-byte aligned only,
// and go by two 8-byte copies a chunk.
template <typename S, int W, typename KSwz, typename VSwz>
__device__ __forceinline__ void copy_chunk16(
    unsigned char* k_dst, unsigned char* v_dst, float* ks_dst, float* vs_dst,
    const S* k_head, const S* v_head, const float* ks_head,
    const float* vs_head, long long g0, long long g1, int t0, int t_end,
    int d, KSwz kswz, VSwz vswz) {
  constexpr int NCH = W * (int)sizeof(S) / 16;   // 16-byte chunks of a row
  const int lane = threadIdx.x % 32;
  const int row_bytes = d * (int)sizeof(S);
  const unsigned char* kh = reinterpret_cast<const unsigned char*>(k_head);
  const unsigned char* vh = reinterpret_cast<const unsigned char*>(v_head);
  if (sizeof(S) == 1 && (row_bytes & 15)) {
#pragma unroll 4
    for (int i = lane; i < 16 * NCH; i += 32) {
      const int r = i / NCH, c = i % NCH;
      const bool ok = t0 + r < t_end;
      const size_t row = (size_t)((r < 8 ? g0 : g1) + (r & 7)) * row_bytes;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = c * 16 + 8 * hh;
        const bool in = at < row_bytes;
        cp_async8(k_dst + kswz(r, c) * 16 + 8 * hh, kh + row + (in ? at : 0),
                  ok && in);
        cp_async8(v_dst + vswz(r, c) * 16 + 8 * hh, vh + row + (in ? at : 0),
                  ok && in);
      }
    }
  } else {
#pragma unroll 8
    for (int i = lane; i < 16 * NCH; i += 32) {
      const int r = i / NCH, c = i % NCH;
      const bool ok = t0 + r < t_end;
      const bool in = c * 16 < row_bytes;
      const size_t off = (size_t)((r < 8 ? g0 : g1) + (r & 7)) * row_bytes +
                         (in ? c * 16 : 0);
      cp_async16(k_dst + kswz(r, c) * 16, kh + off, ok && in);
      cp_async16(v_dst + vswz(r, c) * 16, vh + off, ok && in);
    }
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

// copy_chunk16 for the per-row table walk (TokenRows): row r of the chunk
// sits at pool row pick(r), one shuffle a pass (every lane runs the same
// 16 NCH / 32 passes), and the scales of one-byte pages go one 4-byte
// copy a row (lanes 0-15 the K scales of rows 0-15, 16-31 the V scales),
// since a page's scale rows are only 4 ps-byte aligned.
template <typename S, int W, typename KSwz, typename VSwz>
__device__ __forceinline__ void copy_chunk16_rows(
    unsigned char* k_dst, unsigned char* v_dst, float* ks_dst, float* vs_dst,
    const S* k_head, const S* v_head, const float* ks_head,
    const float* vs_head, TokenRows::Pick pick, int t0, int t_end, int d,
    KSwz kswz, VSwz vswz) {
  constexpr int NCH = W * (int)sizeof(S) / 16;   // 16-byte chunks of a row
  static_assert(NCH % 2 == 0, "a warp's passes over 16 rows are uniform");
  const int lane = threadIdx.x % 32;
  const int row_bytes = d * (int)sizeof(S);
  const unsigned char* kh = reinterpret_cast<const unsigned char*>(k_head);
  const unsigned char* vh = reinterpret_cast<const unsigned char*>(v_head);
  if (sizeof(S) == 1 && (row_bytes & 15)) {
#pragma unroll 4
    for (int i = lane; i < 16 * NCH; i += 32) {
      const int r = i / NCH, c = i % NCH;
      const bool ok = t0 + r < t_end;
      const size_t row = (size_t)pick(r) * row_bytes;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = c * 16 + 8 * hh;
        const bool in = at < row_bytes;
        cp_async8(k_dst + kswz(r, c) * 16 + 8 * hh, kh + row + (in ? at : 0),
                  ok && in);
        cp_async8(v_dst + vswz(r, c) * 16 + 8 * hh, vh + row + (in ? at : 0),
                  ok && in);
      }
    }
  } else {
#pragma unroll 8
    for (int i = lane; i < 16 * NCH; i += 32) {
      const int r = i / NCH, c = i % NCH;
      const bool ok = t0 + r < t_end;
      const bool in = c * 16 < row_bytes;
      const size_t off = (size_t)pick(r) * row_bytes + (in ? c * 16 : 0);
      cp_async16(k_dst + kswz(r, c) * 16, kh + off, ok && in);
      cp_async16(v_dst + vswz(r, c) * 16, vh + off, ok && in);
    }
  }
  if constexpr (sizeof(S) == 1) {
    const int r = lane & 15;
    const long long row = pick(r);
    const bool ok = t0 + r < t_end;
    if (lane < 16) cp_async4(ks_dst + r, ks_head + row, ok);
    else cp_async4(vs_dst + r, vs_head + row, ok);
  }
}

// -- few rows, CUDA cores ----------------------------------------------------
// T: q element type; S: page element type (T itself, or a one-byte code
// dequantized by k_scales / v_scales); TO: output element type.  R query
// rows a block (kRows, or 1 when a group has one row, so that decode keeps
// no registers for rows it does not have); NW warps, rings of NS 16-token
// stages, one ring a warp.
template <typename S, int W>
struct CoreStage {
  static constexpr int NCH = W * (int)sizeof(S) / 16;     // chunks of a row
  static constexpr int KB = kChunk * key_ld<NCH>() * 16;  // K rows
  static constexpr int VB = kChunk * W * (int)sizeof(S);  // V rows
  static constexpr int BYTES = KB + VB + (sizeof(S) == 1 ? 2 * kChunk * 4 : 0);
};

// the warps of a CUDA-core block: RPA_WARPS, halved while their rings
// would pass 192 KB of shared memory (f32 pages at W 256)
template <typename S, int W>
constexpr int core_warps() {
  int nw = RPA_WARPS;
  while (nw > 1 && nw * RPA_STAGES * CoreStage<S, W>::BYTES > 192 * 1024)
    nw /= 2;
  return nw;
}

template <typename T, typename S, int W, int NW, int NS, int R>
constexpr int core_smem() {
  constexpr int ring = NW * NS * CoreStage<S, W>::BYTES;
  constexpr int merge = NW * R * (W + 2) * 4;
  return R * W * (int)sizeof(T) + NW * R * kChunk * 4 +
         (ring > merge ? ring : merge);
}

template <typename T, typename S, typename TO, int W, int NW, int NS, int R,
          bool AL>
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
                              float sm_scale, int d) {
  using St = CoreStage<S, W>;
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int DPL = W / 32;               // output dims owned by a lane
  constexpr int NCH = St::NCH;
  constexpr int E = 16 / (int)sizeof(S);    // elements of a 16-byte chunk
  constexpr int QV = 16 / (int)sizeof(T);   // q elements of a 16-byte load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);                 // [R][W]
  float* p_s = reinterpret_cast<float*>(q_s + R * W);  // [NW][R][16]
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
  const S* k_head = k_pages + scale_base * d;
  const S* v_head = v_pages + scale_base * d;
  const float* ks_head = kQuant ? k_scales + scale_base : nullptr;
  const float* vs_head = kQuant ? v_scales + scale_base : nullptr;
  const int* pt = page_table + (size_t)tl.s * table_width;
  const int n_chunks = (tl.t_end - tl.t_begin + kChunk - 1) / kChunk;
  const int mine = n_chunks > warp ? (n_chunks - warp + NW - 1) / NW : 0;
  unsigned char* wring = ring + warp * NS * St::BYTES;
  auto chunk_t0 = [&](int i) { return tl.t_begin + (warp + i * NW) * kChunk; };
  RowsOf<AL> groups(pt, page_size, chunk_t0(0), NW * kChunk, tl.t_table);
  auto fetch = [&](int i) {
    unsigned char* st = wring + (i % NS) * St::BYTES;
    float* sc = reinterpret_cast<float*>(st + St::KB + St::VB);
    if constexpr (AL) {
      long long g0, g1;
      groups.rows(i, g0, g1);
      copy_chunk16<S, W>(st, st + St::KB, sc, sc + kChunk, k_head, v_head,
                         ks_head, vs_head, g0, g1, chunk_t0(i), tl.t_end, d,
                         KeyRows<NCH>(), PlainRows<NCH>());
    } else {
      copy_chunk16_rows<S, W>(st, st + St::KB, sc, sc + kChunk, k_head,
                              v_head, ks_head, vs_head, groups.rows(i),
                              chunk_t0(i), tl.t_end, d, KeyRows<NCH>(),
                              PlainRows<NCH>());
    }
  };
  // the K / V copies go first: the q rows' load overlaps them
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < mine) fetch(i);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < tl.nvalid * (W / QV); i += NW * 32) {
    const int r = i / (W / QV), c = i % (W / QV);
    *reinterpret_cast<uint4*>(q_s + r * W + c * QV) =
        c * QV < d ? *reinterpret_cast<const uint4*>(
                         q + lay.out_row(tl.s, tl.h, tl.row0 + r) * d +
                         c * QV)
                   : make_uint4(0u, 0u, 0u, 0u);
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
    const float* k_sc = reinterpret_cast<const float*>(st + St::KB + St::VB);
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
      load_f32<S, E>(ks + KeyRows<NCH>()(j, c) * E, kv);
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
            load_f32<T, QV>(q_s + r * W + c * E + e0, qv);
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
    // P V: this lane's W / 32 dims of each token's V row (zero-filled
    // past the range, where p is 0, and past d)
#pragma unroll 4
    for (int v = 0; v < kChunk; ++v) {
      float vv[DPL];
      load_f32<S, DPL>(vs + v * W + lane * DPL, vv);
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
  float* red_acc = red_l + NW * R;                    // [NW][R][W]
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
        red_acc[(warp * R + r) * W + lane * DPL + e] = acc[r][e];
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
          res[e] = fmaf(red_acc[(w * R + r) * W + lane * DPL + e], scale,
                        res[e]);
      }
    }
    if (!split) {
      const float inv = den > 0.f ? 1.f / den : 0.f;
      TO* o = out + lay.out_row(tl.s, tl.h, rg) * d + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (lane * DPL + e < d) store(o + e, res[e] * inv);
    } else if (r < tl.nvalid) {
      const long long p = lay.partial(blockIdx.x, tl.s, tl.h, rg);
      if (lane == 0) ml[p] = make_float2(mx, den);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (lane * DPL + e < d) acc_ws[p * d + lane * DPL + e] = res[e];
    }
  }
}

// -- 64-row tiles, tensor cores (bf16 q) -------------------------------------
// a staged K (or V) tile: one-byte codes land in plain rows of W codes,
// bf16 rows in the tensor-core layout of width W (swz<W>)
template <typename S, int W>
struct MmaStage {
  static constexpr int ROW = sizeof(S) == 1 ? W : tile_ld<W>() * 2;  // bytes
  static constexpr int RAW = kKeyTile * ROW;                // K (or V) tile
  static constexpr int BYTES = 2 * RAW + (sizeof(S) == 1 ? 2 * kKeyTile * 4 : 0);
};

// blocks sharing the output columns of one tensor-core tile: above W 128
// the O accumulator of the whole width would not fit the registers (it
// spilled at W 256), so block h of a pair recomputes the scores and takes
// columns [h W / 2, (h + 1) W / 2) of P V
template <int W>
__host__ __device__ constexpr int mma_split() { return W > 128 ? 2 : 1; }

template <typename S, int W, int NS>
constexpr int mma_smem() {
  return kMmaRows * tile_ld<W>() * 2 + NS * MmaStage<S, W>::BYTES +
         (sizeof(S) == 1 ? 2 * kKeyTile * tile_ld<W>() * 2 : 0);
}

// one block per SM at least: without the minimum, ptxas aims at 3 blocks
// per SM (168 registers) and spills at W 160 / 192 over one-byte pages
template <typename S, typename TO, int W, int NS, bool AL>
__global__ void __launch_bounds__(kMmaWarps * 32, 1)
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
                                  float sm_scale, int d) {
  using St = MmaStage<S, W>;
  constexpr bool kQuant = sizeof(S) == 1;
  constexpr int NTHR = kMmaWarps * 32, BN = kKeyTile;
  constexpr int LD = tile_ld<W>();          // row stride of a bf16 tile
  constexpr int KS = W / 16;                // k-steps of Q K^T
  constexpr int NH = mma_split<W>();        // blocks sharing the columns
  constexpr int WO = W / NH;                // output columns of a block
  constexpr int NO = WO / 8;                // its n-tiles of O
  constexpr int NC = W / 8;                 // 16-byte chunks of a bf16 row
  constexpr int NCH = W * (int)sizeof(S) / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][W]
  unsigned char* ring = smem_raw + kMmaRows * LD * 2;               // NS stages
  // quant: the stage's codes dequantized to bf16, [BN][W] K then V
  __nv_bfloat16* kd_s = reinterpret_cast<__nv_bfloat16*>(ring + NS * St::BYTES);
  __nv_bfloat16* vd_s = kd_s + BN * LD;

  const int rep = hq / hkv;
  // grid x: the KV split, and with NH > 1 the block's half of the columns
  const int sp = NH > 1 ? blockIdx.x / NH : blockIdx.x;
  const int c0 = NH > 1 ? (blockIdx.x % NH) * WO : 0;
  const Tile tl(sp, kMmaRows, qmax, rep, hkv, q_start, q_len, kv_len,
                table_width, page_size, split_len);
  const Layout lay{qmax, hq, hkv, rep, (int)gridDim.z};
  const bool split = n_splits > 1;
  if (split && tl.t_begin >= tl.t_end) {    // nothing here: an empty partial
    for (int r = threadIdx.x; r < tl.nvalid; r += NTHR)
      ml[lay.partial(sp, tl.s, tl.h, tl.row0 + r)] =
          make_float2(kNegInf, 0.f);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;               // the warp's first row of the tile

  const size_t scale_base = (size_t)tl.h * num_pages * page_size;
  const S* k_head = k_pages + scale_base * d;
  const S* v_head = v_pages + scale_base * d;
  const float* ks_head = kQuant ? k_scales + scale_base : nullptr;
  const float* vs_head = kQuant ? v_scales + scale_base : nullptr;
  const int* pt = page_table + (size_t)tl.s * table_width;
  const int n_kt = (tl.t_end - tl.t_begin + BN - 1) / BN;
  // warp w copies tokens 16 w .. 16 w + 15 of a key tile (16 w is a
  // multiple of 8, so its rows keep the tile's swizzle phase)
  RowsOf<AL> groups(pt, page_size, tl.t_begin + 16 * warp, BN, tl.t_table);
  auto fetch = [&](int kt) {
    unsigned char* st = ring + (kt % NS) * St::BYTES;
    float* sc = reinterpret_cast<float*>(st + 2 * St::RAW) + 16 * warp;
    const int off = 16 * warp * St::ROW;
    const int t0 = tl.t_begin + kt * BN + 16 * warp;
    // codes land plain (the dequant pass swizzles); bf16 rows swizzled,
    // as ldmatrix reads them
    using Rows = typename std::conditional<kQuant, PlainRows<NCH>,
                                           MmaRows<W>>::type;
    if constexpr (AL) {
      long long g0, g1;
      groups.rows(kt, g0, g1);
      copy_chunk16<S, W>(st + off, st + St::RAW + off, sc, sc + BN, k_head,
                         v_head, ks_head, vs_head, g0, g1, t0, tl.t_end, d,
                         Rows(), Rows());
    } else {
      copy_chunk16_rows<S, W>(st + off, st + St::RAW + off, sc, sc + BN,
                              k_head, v_head, ks_head, vs_head,
                              groups.rows(kt), t0, tl.t_end, d, Rows(),
                              Rows());
    }
  };

  // group 0: Q (rows past the real ones zero-filled) and key tile 0;
  // groups 1 .. NS - 2: key tiles 1 .. NS - 2
  for (int i = threadIdx.x; i < kMmaRows * NC; i += NTHR) {
    const int r = i / NC, c = i % NC;
    const bool ok = r < tl.nvalid && c * 8 < d;
    cp_async16(q_s + swz<W>(r, c),
               q + lay.out_row(tl.s, tl.h, tl.row0 + (ok ? r : 0)) * d +
                   (ok ? c * 8 : 0),
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
      for (int i = threadIdx.x; i < 2 * BN * (W / 16); i += NTHR) {
        const int which = i / (BN * (W / 16)), ii = i % (BN * (W / 16));
        const int r = ii / (W / 16), c = ii % (W / 16);
        float f[16];
        load_f32<S, 16>(reinterpret_cast<const S*>(st + which * St::RAW) +
                            r * W + c * 16, f);
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
        *reinterpret_cast<uint4*>(dst + swz<W>(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(dst + swz<W>(r, 2 * c + 1)) = hi;
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
      load_a<W>(qa, q_s, wrow, kk);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        unsigned bf[4];
        load_bt<W>(bf, ks, np * 16, kk);
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
      for (int dp = 0; dp < WO / 16; ++dp) {
        unsigned bf[4];
        load_b<W>(bf, vs, kk * 16, c0 / 16 + dp);
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
      TO* o = out + lay.out_row(tl.s, tl.h, rg) * d + c0;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (c0 + 8 * n < d)
          store2(o + 8 * n + 2 * t, acc[n][2 * r] * inv,
                 acc[n][2 * r + 1] * inv);
    } else if (row < tl.nvalid) {
      // both halves of a column pair write the same (m, l)
      const long long p = lay.partial(sp, tl.s, tl.h, rg);
      if (t == 0) ml[p] = make_float2(l[r] > 0.f ? m[r] : kNegInf, l[r]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        if (c0 + 8 * n < d)
          *reinterpret_cast<float2*>(acc_ws + p * d + c0 + 8 * n + 2 * t) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// -- the splits' merge ---------------------------------------------------------
// One warp per output row (slot, query, q head), in a fixed split order;
// splits with l = 0 (nothing visible there) are skipped without reading
// their accumulator; rows past q_len come out as zeros.
template <typename TO, int W>
__global__ void __launch_bounds__(256)
ragged_paged_attention_combine_kernel(const float2* __restrict__ ml,
                                      const float* __restrict__ acc_ws,
                                      const int* __restrict__ q_len,
                                      TO* __restrict__ out, int s_slots,
                                      int qmax, int hq, int hkv,
                                      int n_splits, int d) {
  constexpr int DPL = W / 32;
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
        load_f32_n<float, DPL>(acc_ws + p * d + lane * DPL, a,
                               d - lane * DPL);
#pragma unroll
        for (int e = 0; e < DPL; ++e) res[e] = fmaf(a[e], w, res[e]);
      }
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) res[e] *= inv;
  }
  TO* po = out + o * d + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e)
    if (lane * DPL + e < d) store(po + e, res[e]);
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
  int d;                                    // head dim
};

template <typename TO, int W>
cudaError_t launch_combine(const Args& a) {
  const long long rows = (long long)a.s_slots * a.qmax * a.hq;
  ragged_paged_attention_combine_kernel<TO, W>
      <<<(unsigned)((rows + 7) / 8), 256, 0, a.stream>>>(
          a.ml, a.acc, a.q_len, static_cast<TO*>(a.out), a.s_slots, a.qmax,
          a.hq, a.hkv, a.n_splits, a.d);
  return cudaGetLastError();
}

template <typename T, typename S, typename TO, int W, int R, bool AL>
cudaError_t launch_core(const Args& a, dim3 grid) {
  constexpr int NW = core_warps<S, W>();
  constexpr int smem = core_smem<T, S, W, NW, RPA_STAGES, R>();
  const auto kernel =
      ragged_paged_attention_kernel<T, S, TO, W, NW, RPA_STAGES, R, AL>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(done, kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.k_scales, a.v_scales, a.page_table,
      a.q_start, a.q_len, a.kv_len, static_cast<TO*>(a.out), a.ml, a.acc,
      a.qmax, a.hq, a.hkv, a.num_pages, a.page_size, a.table_width,
      a.split_len, a.n_splits, a.sm_scale, a.d);
  return cudaGetLastError();
}

template <typename T, typename S, typename TO, int W, bool AL>
cudaError_t launch_mma(const Args& a, dim3 grid) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int smem = mma_smem<S, W, RPA_STAGES>();
    const auto kernel =
        ragged_paged_attention_mma_kernel<S, TO, W, RPA_STAGES, AL>;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t err = allow_smem(done, kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaWarps * 32, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const S*>(a.k),
        static_cast<const S*>(a.v), a.k_scales, a.v_scales, a.page_table,
        a.q_start, a.q_len, a.kv_len, static_cast<TO*>(a.out), a.ml, a.acc,
        a.qmax, a.hq, a.hkv, a.num_pages, a.page_size, a.table_width,
        a.split_len, a.n_splits, a.sm_scale, a.d);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;           // the tensor-core tile takes bf16 q
  }
}

// row_tile: kMmaRows (tensor cores, bf16 q), kRows or 1 (CUDA cores);
// AL: the page size is a multiple of 8 (aligned 8-token groups)
template <typename T, typename S, typename TO, int W, bool AL>
cudaError_t launch_tile(const Args& a, dim3 grid) {
  if (a.row_tile == kMmaRows)
    return launch_mma<T, S, TO, W, AL>(
        a, dim3(grid.x * mma_split<W>(), grid.y, grid.z));
  if (a.row_tile == kRows) return launch_core<T, S, TO, W, kRows, AL>(a, grid);
  if (a.row_tile == 1) return launch_core<T, S, TO, W, 1, AL>(a, grid);
  return cudaErrorInvalidValue;
}

template <typename T, typename S, typename TO, int W>
cudaError_t launch(const Args& a) {
  const int rows = a.qmax * (a.hq / a.hkv);
  const dim3 grid(a.n_splits, (rows + a.row_tile - 1) / a.row_tile * a.hkv,
                  a.s_slots);
  const cudaError_t err = a.page_size % 8 == 0
                              ? launch_tile<T, S, TO, W, true>(a, grid)
                              : launch_tile<T, S, TO, W, false>(a, grid);
  if (err != cudaSuccess || a.n_splits == 1) return err;
  return launch_combine<TO, W>(a);
}

// f(integral_constant<W>) at whichever of this unit's widths Ws (its
// RPA_TU_WIDTHS) holds head dim d (rpa_width); an error for any other d
template <int... Ws, typename F>
cudaError_t at_width(int d, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((rpa_width(d) == Ws &&
          ((err = f(std::integral_constant<int, Ws>{})), true)) ||
         ...);
  return err;
}

template <typename T, typename S, typename TO>
cudaError_t launch_width(const Args& a) {
  return at_width<RPA_TU_WIDTHS>(
      a.d, [&](auto w) { return launch<T, S, TO, decltype(w)::value>(a); });
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <typename T, typename S>
cudaError_t launch_out(int out_dtype, const Args& a) {
  if (out_dtype == 0) return launch_width<T, S, float>(a);
  if (out_dtype == 1) return launch_width<T, S, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

// the checks every entry makes before it launches anything: the splits
// (split_len tokens each, whole pages) cover the table; any page size
inline bool valid_geometry(const Args& a) {
  return rpa_width(a.d) != 0 && a.hkv > 0 && a.hq % a.hkv == 0 &&
         a.page_size > 0 && a.n_splits >= 1 && a.split_len > 0 &&
         a.split_len % a.page_size == 0 &&
         (long long)a.n_splits * a.split_len >=
             (long long)a.table_width * a.page_size &&
         (a.n_splits == 1 || (a.ml != nullptr && a.acc != nullptr));
}

}  // namespace

// The C entries, compiled by the translation units that define
// RPA_PLAIN_ENTRIES (f32 / bf16 pages, and the split merge) or
// RPA_QUANT_ENTRIES (int8 / fp8 pages), each at its RPA_TU_WIDTHS.
#ifdef RPA_PLAIN_ENTRIES
// dtype codes: 0 = float32, 1 = bfloat16; q, k and v share in_dtype.
// head_dim: a multiple of 8 up to 256 (rpa_width) whose width this library
// holds; row_tile: 8 or 1 (CUDA cores) or 64 (tensor cores, bf16 q); the
// splits: n splits of split_len tokens, partials in ml [n, S, Hkv,
// Qmax * rep] x 2 and acc [n, S, Hkv, Qmax * rep, D] f32 (unused, may be
// null, with one split).
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_len, void* ml, void* acc, void* out, int s_slots,
    int qmax, int hq, int hkv, int num_pages, int page_size, int table_width,
    int head_dim, int in_dtype, int out_dtype, int row_tile, int n_splits,
    int split_len, float sm_scale, void* stream) {
  if (s_slots <= 0 || qmax <= 0) return cudaSuccess;
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(q_start),
               static_cast<const int*>(q_len),
               static_cast<const int*>(kv_len), out,
               static_cast<float2*>(ml), static_cast<float*>(acc), s_slots,
               qmax, hq, hkv, num_pages, page_size, table_width, row_tile,
               n_splits, split_len, sm_scale,
               static_cast<cudaStream_t>(stream), head_dim};
  if (!valid_geometry(a)) return cudaErrorInvalidValue;
  if (in_dtype == 0) return launch_out<float, float>(out_dtype, a);
  if (in_dtype == 1)
    return launch_out<__nv_bfloat16, __nv_bfloat16>(out_dtype, a);
  return cudaErrorInvalidValue;
}

// The merge of n_splits partials (as above) into out [S, Qmax, Hq, D].
extern "C" int ragged_paged_attention_combine_launch(
    const void* ml, const void* acc, const void* q_len, void* out,
    int s_slots, int qmax, int hq, int hkv, int n_splits, int head_dim,
    int out_dtype, void* stream) {
  if (s_slots <= 0 || qmax <= 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || n_splits < 1) return cudaErrorInvalidValue;
  Args a{};
  a.ml = static_cast<float2*>(const_cast<void*>(ml));
  a.acc = static_cast<float*>(const_cast<void*>(acc));
  a.q_len = static_cast<const int*>(q_len);
  a.out = out;
  a.s_slots = s_slots;
  a.qmax = qmax;
  a.hq = hq;
  a.hkv = hkv;
  a.n_splits = n_splits;
  a.stream = static_cast<cudaStream_t>(stream);
  a.d = head_dim;
  if (out_dtype != 0 && out_dtype != 1) return cudaErrorInvalidValue;
  return at_width<RPA_TU_WIDTHS>(head_dim, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return out_dtype == 0 ? launch_combine<float, W>(a)
                          : launch_combine<__nv_bfloat16, W>(a);
  });
}
#endif  // RPA_PLAIN_ENTRIES

#ifdef RPA_QUANT_ENTRIES
namespace {

template <typename S>
cudaError_t launch_in(int in_dtype, int out_dtype, const Args& a) {
  if (in_dtype == 0) return launch_out<float, S>(out_dtype, a);
  if (in_dtype == 1) return launch_out<__nv_bfloat16, S>(out_dtype, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q and out); kv_dtype codes:
// 0 = int8, 1 = float8_e4m3fn (both page arrays); head_dim, row_tile and
// the splits as in ragged_paged_attention_launch.
extern "C" int ragged_paged_attention_quant_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* q_start, const void* q_len, const void* kv_len, void* ml,
    void* acc, void* out, int s_slots, int qmax, int hq, int hkv,
    int num_pages, int page_size, int table_width, int head_dim,
    int in_dtype, int out_dtype, int kv_dtype, int row_tile, int n_splits,
    int split_len, float sm_scale, void* stream) {
  if (s_slots <= 0 || qmax <= 0) return cudaSuccess;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(page_table),
               static_cast<const int*>(q_start),
               static_cast<const int*>(q_len),
               static_cast<const int*>(kv_len), out,
               static_cast<float2*>(ml), static_cast<float*>(acc), s_slots,
               qmax, hq, hkv, num_pages, page_size, table_width, row_tile,
               n_splits, split_len, sm_scale,
               static_cast<cudaStream_t>(stream), head_dim};
  if (!valid_geometry(a)) return cudaErrorInvalidValue;
  if (kv_dtype == 0) return launch_in<int8_t>(in_dtype, out_dtype, a);
  if (kv_dtype == 1) return launch_in<__nv_fp8_e4m3>(in_dtype, out_dtype, a);
  return cudaErrorInvalidValue;
}
#endif  // RPA_QUANT_ENTRIES
