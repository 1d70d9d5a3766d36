// FlashAttention-2 forward and backward for NVIDIA Hopper (sm_90a): the
// kernel bodies, their host launchers and the C entries, compiled by
// flash_attention.cu at each head width (one library each, built in
// parallel: W = 64 and 128 with the lse repack, and each other width with
// -DFA_TU_WIDTHS=<W>; ops/_build.py WIDTH_LIBRARIES).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_attention_fwd_kernel_call -> _fwd_kernel    (fa_fwd_wgmma_kernel,
//                                                       fa_fwd_kernel)
//   _pack_lse                                          (the forward's lse
//        epilogue, and pack_lse_kernel for 3-D [BH, S, 1] stats)
//   _bwd_call -> _bwd_dkv_kernel                (fa_bwd_dkv_wgmma_kernel,
//                                                fa_bwd_dkv_mma_kernel,
//                                                fa_bwd_dkv_kernel)
//   _bwd_call -> _bwd_dq_kernel                 (fa_bwd_dq_wgmma_kernel,
//                                                fa_bwd_dq_kernel)
//
// Layout: q, o, dq are [B, S_q, Hq, D]; k, v, dk, dv are [B, S_k, Hkv, D];
// each is read or written through its (batch, seq, head) strides with unit
// stride along D, so the [B, S, H, D] tensors of the model are used as they
// are (the TPU wrapper transposed them to [B*H, S, D] first).  lse and
// delta are compact [B*Hq, S_q] f32 rows: on Hopper device memory has no
// 128-lane tile padding, so this is byte for byte the TPU's packed
// [B*Hq, S_q/128, 128] layout, and the forward writes it directly.
//
// Head dims: the TPU kernels take any D that is a multiple of 8 up to 256.
// Here every body is compiled at a padded width W (fa_width: 32, 48, 64,
// 80, 96, 128, 160, 192 or 256, the narrowest that holds D) and takes the
// true D at run time: tiles load D columns and zero-fill D .. W in shared
// memory (D is a multiple of 8, so a whole number of 16-byte bf16 chunks),
// products run over W, and only D columns are stored.  Zero columns of q
// and k add nothing to q . k, and zero columns of v and dO give output
// columns that are never stored; the scale stays 1 / sqrt(D), which the
// caller passes.  W is a multiple of 16 (an mma.sync k-step), and D 40 runs
// at W 48, not 64.  The bf16 bodies take a flag PART: PART = false is the
// full-width body (D = W, no run-time column test), compiled only at
// W = 64 and 128, where it is the kernel tuned in PRs of the port before
// the head dims came; every other (W, D) runs PART = true.  Shared tiles of
// W 48, 80, 96 and 160 are padded rows, not XOR-swizzled ones
// (sm90_mma.cuh swz).  At W > 160 the bf16 dK / dV and dQ bodies split the
// output columns between two blocks (each recomputes the scores), so that
// their accumulators fit the registers; the f32 bodies take 32-row tiles
// at W 256, so that their staged tiles fit the 227 KB of shared memory a
// block may have.
//
// Semantics kept from the TPU kernels: s = (q . k) * sm_scale in f32;
// causal masking is bottom-right aligned (query row i sees key j iff
// i + S_k - S_q >= j) with masked scores set to NEG_INF = -1e30, not -inf;
// the online softmax walks the key tiles in order from the first, so a
// row's running max is finite after tile 0 and later fully masked tiles add
// exactly zero; the finalize step writes o = acc / l where l > 0 (else 0)
// and lse = m + log(max(l, 1e-30)).  GQA: q head h reads kv head
// h / (Hq / Hkv), never a repeated copy.  The backward recomputes
// p = exp(s - lse) from the saved lse, takes dO in f32, uses
// delta = rowsum(dO * O) computed by the caller, and sums dK, dV over the
// Hq / Hkv q heads of a kv head inside one block (no atomics, so the
// result is deterministic, as the TPU grid's sequential axes were).
// S_q and S_k need not be multiples of a tile: a partial tile's
// missing rows load as zeros, are never written, and its missing key
// columns score -inf, so they add nothing.
//
// What bounds it on this card: at the train shape (S = 2048, D = 64) each
// (q tile, key tile) pair does 2 products (forward), 4 plus the hi / lo
// repeats (dK / dV, see below) or 3 plus repeats (dQ) of tile x tile x D
// multiply-adds for 2 tiles of rows loaded, so the kernels are bound by
// operations, not by bytes: 989 TFLOP/s of bf16 tensor-core products
// against 3.35 TB/s.  What keeps a kernel from that rate is what stands
// between the products: the softmax's exponentials, block barriers, and
// loads that the products wait for.  The TPU's 512 x 1024 blocks do not fit
// Hopper's 227 KB of shared memory; the tiles here are 64 to 128 rows.
// Three kinds of body:
//   * bf16 wgmma (every forward and dQ launch, and dK / dV but below):
//     warp-specialised blocks, a producer warp feeding consumer warpgroups
//     by TMA, wgmma products with the scores in registers (the section
//     "The wgmma bodies" below).  The forward fits its grid and tiles to
//     the launch (fwd_design: a block per q tile, or a persistent grid of
//     a block an SM; 64 or 128 keys a tile).
//   * bf16 mma.sync (fa_bwd_dkv_mma_kernel: dK / dV without segments at
//     kMmaSyncDkvWidth alone): mma.sync.m16n8k16 fed by ldmatrix, with every
//     score, p, dP, ds and accumulator in registers, and Q / dO arriving
//     through a cp.async ring while the previous tile's products run, one
//     block barrier per tile.
//   * f32 inputs run their products on the CUDA cores in f32, which keeps
//     f32 inputs exact to f32 rounding (a TF32 tensor-core product would
//     not): tiles staged in shared memory as f32 (rows padded to W + 1
//     floats so that the threads of a warp hit distinct banks), each of the
//     256 threads owning a 4 x 4 (2 x 2 at 32-row tiles) micro-tile of the
//     score block and a slice of the accumulator kept in registers.
// The bf16 forward rounds p to bf16 for P V, as the TPU kernel does
// (`pd.astype(v.dtype)`).  The TPU backward keeps p and ds in f32; here each
// enters its product as hi = bf16(x) and lo = bf16(x - hi), which carry x to
// 2^-16 relative, with two products into one f32 accumulator.  Which bf16
// launch takes which body (kWgmmaFwd, kWgmmaDkv; the C entry
// flash_attention_body reports it per launch, flash_attention_fwd_design
// the forward's design):
//   forward and dQ: every launch the wgmma bodies, with or without
//     segments or dropout, causal or not, at every width;
//   dK / dV: likewise, but without segments at W 160 (kMmaSyncDkvWidth),
//     with or without dropout, where mma.sync measured faster.
//
// Attention dropout (the TPU kernels' dropout_rate > 0 branch) is the
// template flag DROP of all seven bodies; the DROP = false instantiations
// are the kernels as they were.  Each score's keep word is drawn in
// registers from Philox4x32-10 keyed by the seed and counted by the
// score's global (q-head row, q row, key) coordinates (philox.cuh), so
// every kernel rebuilds the same mask from the seed whatever its tiling,
// and the mask never reaches device memory (the TPU kernel reseeds its core
// PRNG per block to the same end).  As on the TPU: l and lse sum the
// undropped p, P V takes p * keep / (1 - rate) (rounded to bf16 in the bf16
// forward), dK / dV and dQ take dP * keep / (1 - rate) into
// ds = p (dP' - delta) sm_scale, and dV the dropped p.  The bf16 bodies
// draw one call per 4 scores: a forward or dQ thread's 4 scores of a
// 16-key group in one q row are one call's 4 words, and dK / dV's
// transposed fragment splits each call between a lane pair that swaps
// halves by one shuffle.  The wgmma bodies draw a tile's words once its
// score wgmmas (S; S and dP; S^T and dP^T) are issued and before they are
// waited for, since a word depends on the coordinates alone: the Philox
// rounds run on the integer pipe while the tensor cores work, and each word
// is compared with the threshold at once and kept as one bit (32 scores of
// a 64-key tile in one register, not 32 words).  The f32 bodies draw one call per score.  The
// mask costs integer work (some 100 operations per call), not bytes; a
// fully masked causal tile draws nothing.
//
// Segment ids (the TPU kernels' has_segments branch: the varlen mask, and
// the padding of an untileable sequence, which takes a segment of its own)
// are the template flag SEG beside DROP of the three f32 bodies and of the
// three bf16 wgmma bodies, which take every bf16 segment launch of rows 3,
// 5 and 6; the SEG = false instantiations are the kernels without the
// mask (of the wgmma bodies, they run every bf16 launch without
// segments, but dK / dV's at kMmaSyncDkvWidth).
// The ids of one batch row,
// f32 [S] (S = S_q = S_k), are read from device memory where a score is
// masked, and a score whose q row and key lie in different segments is
// NEG_INF, as on the TPU: it composes with the causal mask and the dropout
// mask, and l, lse and delta keep their forms.  A row whose first key
// tiles hold no key of its segment runs its max at NEG_INF until one
// arrives, whose rescale exp(NEG_INF - m) then clears what those tiles
// summed (the TPU kernel's behaviour; a true -inf there would give NaN).
// The bf16 forward, dK / dV and dQ of the segment branch are their own
// bodies (fa_fwd_wgmma_kernel, fa_bwd_dkv_wgmma_kernel,
// fa_bwd_dq_wgmma_kernel), written for what bounded the mma.sync ones
// there (11.8%, 13.3% and 12.2% of their bound at ViT-L/16's shape, slower
// than SDPA): every tile masked per score from ids read out of device
// memory, no tile ever skipped (23x the pairs a packed varlen row needs),
// mma.sync products with a block barrier per tile.  They class each (q
// tile, key tile) pair before its tile is loaded — skipped, full (the
// unmasked path) or masked from ids staged in shared memory beside the tile
// (tile_class; the TPU kernel skips none, and skipping changes no value) —
// and run wgmma on TMA-loaded tiles, a producer warp feeding consumer
// warpgroups.  Without segments the same classes are the causal frontier
// and the end of the keys, so the three bodies take those launches too
// (on mma.sync dK / dV and dQ were 2.2-2.5x slower than SDPA's backward
// at the UNet's and the LLaMA step's shapes, and 2.2x at ERNIE's with
// dropout; the forward 1.3-1.9x slower than SDPA's forward at the LLaMA
// step's, ERNIE's and the UNet's).  The f32 bodies mask every tile with
// SEG.
//
// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().  flash_attention.cu defines FA_TU_WIDTHS (its widths;
// 64, 128 unless the build passes one other) and includes this header,
// which then defines the entries for them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>
#include <utility>

#include "philox.cuh"
#include "sm90_mma.cuh"
#include "sm90_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;      // the Pallas kernels' NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// the head widths the kernels are compiled at, and the narrowest that holds
// a head dim d (a multiple of 8 up to 256; 0 for any other d)
inline constexpr int fa_width(int d) {
  return d <= 0 || d % 8 != 0 || d > 256 ? 0
         : d <= 32                       ? 32
         : d <= 48                       ? 48
         : d <= 64                       ? 64
         : d <= 80                       ? 80
         : d <= 96                       ? 96
         : d <= 128                      ? 128
         : d <= 160                      ? 160
         : d <= 192                      ? 192
                                         : 256;
}

// the widths whose full-width (PART = false) bf16 bodies are compiled: the
// tuned kernels of the head dims the port first took
constexpr bool kTunedWidth(int w) { return w == 64 || w == 128; }

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// strides (in elements) of a [B, S, H, D] tensor with unit stride along D
struct View {
  long long sb, ss, sh;
  __device__ __forceinline__ long long at(int b, int s, int h) const {
    return b * sb + s * ss + h * sh;
  }
};

// ---------------------------------------------------------------------------
// f32 bodies (CUDA cores).  TR is the rows of a q tile and of a k tile: 64,
// or 32 at W = 256, whose four staged 64-row tiles would not fit a block's
// shared memory.  Thread (tx, ty) = (tid % 16, tid / 16) owns score rows
// ty + 16 i and columns tx + 16 j (i, j < TR / 16) and accumulator columns
// tx + 16 j (j < W / 16).
template <int W>
__host__ __device__ constexpr int f32_rows() { return W > 192 ? 32 : 64; }

// rows [row0, row0 + TR) of one (batch, head) -> dst [TR][W + 1] f32; rows
// past `rows` and columns past d are zero
template <typename T, int W, int TR>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int row0, int rows,
                                          int d) {
  constexpr int LD = W + 1;
  for (int i = threadIdx.x; i < TR * W; i += kThreads) {
    const int r = i / W, c = i % W;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < rows && c < d ? to_f32(src[(long long)row * ss + c]) : 0.f;
  }
}

// c[i][j] = sum_d A[r][d] * B[c][d],  r = ty + 16 i,  c = tx + 16 j
template <int W, int TR>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float c[TR / 16][TR / 16]) {
  constexpr int LD = W + 1, MI = TR / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MI; ++j) c[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < W; ++d) {
    float a[MI], b[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < MI; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// acc[i][j] += sum_k P[r][k] * B[k][e],  r = ty + 16 i,  e = tx + 16 j;
// P is a [TR][TR + 1] score tile, B a [TR][W + 1] row tile
template <int W, int TR>
__device__ __forceinline__ void mm_ab(const float* P, const float* B,
                                      float acc[TR / 16][W / 16]) {
  constexpr int LD = W + 1, LDS = TR + 1, MI = TR / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < TR; ++k) {
    float a[MI], b[W / 16];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = P[(ty + 16 * i) * LDS + k];
#pragma unroll
    for (int j = 0; j < W / 16; ++j) b[j] = B[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < W / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[r][c] * B[r][e],  c = ty + 16 i,  e = tx + 16 j
template <int W, int TR>
__device__ __forceinline__ void mm_atb(const float* P, const float* B,
                                       float acc[TR / 16][W / 16]) {
  constexpr int LD = W + 1, LDS = TR + 1, MI = TR / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < TR; ++r) {
    float a[MI], b[W / 16];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = P[r * LDS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < W / 16; ++j) b[j] = B[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < W / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// number of k tiles a q tile starting at row0 visits: all of them, or up to
// its causal frontier (the TPU kernel's `run` condition per tile)
template <int TR>
__device__ __forceinline__ int k_tiles_for(int row0, int s_q, int s_k,
                                           int causal) {
  const int n = (s_k + TR - 1) / TR;
  if (!causal) return n;
  const int last = row0 + TR - 1 + (s_k - s_q);
  return last < 0 ? 0 : min(n, last / TR + 1);
}

// one score of a (q tile, k tile) pair, scaled and causally masked.  Key
// columns at or past s_k (the zero rows of a partial last k tile) score
// -inf, so that they add exactly nothing to a row's sum and to the
// backward's p and ds; the causal mask keeps the TPU kernel's NEG_INF, and
// so does the segment mask with SEG (segb: the batch row's ids; rows past
// S read the last id, and are never written).
template <bool SEG>
__device__ __forceinline__ float masked_score(float s, float sm_scale,
                                              int qrow, int kcol, int offset,
                                              int causal, int s_k,
                                              const float* segb) {
  if (kcol >= s_k) return __int_as_float(0xff800000);   // -inf
  s *= sm_scale;
  if (causal && qrow + offset < kcol) return kNegInf;
  if constexpr (SEG)
    if (segb[min(qrow, s_k - 1)] != segb[kcol]) return kNegInf;
  return s;
}

// One online-softmax step over a TR x TR score tile (raw q . k products in
// s, row stride LDS): scale and mask, update each row's running max m and
// denominator l (warp w owns rows TR/8 w .. TR/8 w + TR/8 - 1, lanes own
// columns lane + 32 cc), write p = exp(s - m_new) to p (row stride LDP; may
// alias s) and the row's rescale factor exp(m_old - m_new) to alpha_s.
// With DROP the p written for P V is the dropped one; l sums the undropped
// p.
template <int TR, int LDS, int LDP, bool SEG, bool DROP, typename P>
__device__ __forceinline__ void softmax_step(const float* s, P* p,
                                             float* alpha_s, float m[TR / 8],
                                             float l[TR / 8], int row0,
                                             int col0, int offset, int causal,
                                             int s_k, float sm_scale,
                                             const Dropout& dr, unsigned bhq,
                                             const float* segb) {
  constexpr int RW = TR / 8, NCOL = TR / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp * RW + rr;
    float sv[NCOL];
    float mx = __int_as_float(0xff800000);
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) {
      sv[cc] = masked_score<SEG>(s[r * LDS + lane + 32 * cc], sm_scale,
                                 row0 + r, col0 + lane + 32 * cc, offset,
                                 causal, s_k, segb);
      mx = fmaxf(mx, sv[cc]);
    }
    const float m_new = fmaxf(m[rr], warp_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) {
      sv[cc] = expf(sv[cc] - m_new);
      sum += sv[cc];
    }
    const float alpha = expf(m[rr] - m_new);
    l[rr] = alpha * l[rr] + warp_sum(sum);
    m[rr] = m_new;
#pragma unroll
    for (int cc = 0; cc < NCOL; ++cc) {
      float pv = sv[cc];
      if constexpr (DROP)
        pv = dropped(dr, dropout_word_at(dr, row0 + r, col0 + lane + 32 * cc,
                                         bhq),
                     pv);
      store(p + r * LDP + lane + 32 * cc, pv);
    }
    if (lane == 0) alpha_s[r] = alpha;
  }
}

template <typename T, int W, bool SEG, bool DROP>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, View qv, View kv, View vv, View ov,
              int hq, int hkv, int s_q, int s_k, int causal, float sm_scale,
              Dropout dr, const float* __restrict__ seg, int d) {
  constexpr int TR = f32_rows<W>();
  constexpr int LD = W + 1, LDS = TR + 1, MI = TR / 16, RW = TR / 8;
  constexpr int JD = W / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [TR][W + 1]
  float* k_s = q_s + TR * LD;
  float* v_s = k_s + TR * LD;
  float* p_s = v_s + TR * LD;               // [TR][TR + 1] scores, then p
  float* alpha_s = p_s + TR * LDS;          // [TR] per-row rescale
  float* m_s = alpha_s + TR;
  float* l_s = m_s + TR;

  const int row0 = blockIdx.x * TR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = k + kv.at(b, 0, hk);
  const T* vb = v + vv.at(b, 0, hk);
  const float* segb = SEG ? seg + (long long)b * s_k : nullptr;

  load_tile<T, W, TR>(q_s, q + qv.at(b, 0, h), qv.ss, row0, s_q, d);

  float acc[MI][JD];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  float m[RW], l[RW];                       // rows warp * RW + rr
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) { m[rr] = kNegInf; l[rr] = 0.f; }

  const int n_kt = k_tiles_for<TR>(row0, s_q, s_k, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();                        // last tile's readers are done
    load_tile<T, W, TR>(k_s, kb, kv.ss, kt * TR, s_k, d);
    load_tile<T, W, TR>(v_s, vb, vv.ss, kt * TR, s_k, d);
    __syncthreads();
    float sc[MI][MI];
    mm_abt<W, TR>(q_s, k_s, sc);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MI; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        p_s[r * LDS + c] = sc[i][j];
      }
    __syncthreads();
    softmax_step<TR, LDS, LDS, SEG, DROP>(
        p_s, p_s, alpha_s, m, l, row0, kt * TR, offset, causal, s_k,
        sm_scale, dr, (unsigned)(b * hq + h), segb);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float a = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= a;
    }
    mm_ab<W, TR>(p_s, v_s, acc);
  }

  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      m_s[warp * RW + rr] = m[rr];
      l_s[warp * RW + rr] = l[rr];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + 16 * i, row = row0 + r;
    if (row < s_q) {
      const float lr = l_s[r];
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      T* orow = o + ov.at(b, row, h);
#pragma unroll
      for (int j = 0; j < JD; ++j)
        if (tx + 16 * j < d) store(orow + tx + 16 * j, acc[i][j] * inv);
    }
  }
  // the lse epilogue writes the compact (= TPU-packed) [B*Hq, S_q] row
  if (threadIdx.x < TR && row0 + threadIdx.x < s_q) {
    const int r = threadIdx.x;
    lse[((long long)b * hq + h) * s_q + row0 + r] =
        m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

// per-row stats of one (batch, q head) q tile -> shared memory
template <int TR>
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta,
                                           long long row_base, int row0,
                                           int s_q) {
  if (threadIdx.x < TR) {
    const int row = row0 + threadIdx.x;
    lse_s[threadIdx.x] = row < s_q ? lse[row_base + row] : 0.f;
    delta_s[threadIdx.x] = row < s_q ? delta[row_base + row] : 0.f;
  }
}

// p = exp(s - lse) and ds = p * (dp - delta) * sm_scale of a tile pair
// (q rows ty + 16 i, k cols tx + 16 j); writes ds, and p when p_s is set.
// With DROP, dp and the p written (dV's) are the dropped ones.
template <int W, int TR, bool SEG, bool DROP>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* delta_s, float* p_s,
                                         float* ds_s, int qrow0, int kcol0,
                                         int offset, int causal, int s_k,
                                         float sm_scale, const Dropout& dr,
                                         unsigned bhq, const float* segb) {
  constexpr int MI = TR / 16, LDS = TR + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[MI][MI], dp[MI][MI];
  mm_abt<W, TR>(q_s, k_s, sc);
  mm_abt<W, TR>(do_s, v_s, dp);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MI; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const float s = masked_score<SEG>(sc[i][j], sm_scale, qrow0 + r,
                                        kcol0 + c, offset, causal, s_k, segb);
      const float p = expf(s - lse_s[r]);
      float pd = p, dpd = dp[i][j];
      if constexpr (DROP) {
        const unsigned word = dropout_word_at(dr, qrow0 + r, kcol0 + c, bhq);
        pd = dropped(dr, word, p);
        dpd = dropped(dr, word, dpd);
      }
      if (p_s != nullptr) p_s[r * LDS + c] = pd;
      ds_s[r * LDS + c] = p * (dpd - delta_s[r]) * sm_scale;
    }
}

template <typename T, int W, bool SEG, bool DROP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, View qv, View kv, View vv, View dov,
                  View dkv, View dvv, int hq, int hkv, int s_q, int s_k,
                  int causal, float sm_scale, Dropout dr,
                  const float* __restrict__ seg, int d) {
  constexpr int TR = f32_rows<W>();
  constexpr int LD = W + 1, LDS = TR + 1, MI = TR / 16;
  constexpr int JD = W / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [TR][W + 1] each
  float* v_s = k_s + TR * LD;
  float* q_s = v_s + TR * LD;
  float* do_s = q_s + TR * LD;
  float* p_s = do_s + TR * LD;              // [TR][TR + 1] each
  float* ds_s = p_s + TR * LDS;
  float* lse_s = ds_s + TR * LDS;           // [TR] each
  float* delta_s = lse_s + TR;

  const int col0 = blockIdx.x * TR;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv;
  const int offset = s_k - s_q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* segb = SEG ? seg + (long long)b * s_k : nullptr;

  load_tile<T, W, TR>(k_s, k + kv.at(b, 0, hk), kv.ss, col0, s_k, d);
  load_tile<T, W, TR>(v_s, v + vv.at(b, 0, hk), vv.ss, col0, s_k, d);

  float dk_acc[MI][JD], dv_acc[MI][JD];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) { dk_acc[i][j] = 0.f; dv_acc[i][j] = 0.f; }

  const int n_qt = (s_q + TR - 1) / TR;
  for (int rr = 0; rr < rep; ++rr) {        // the q heads of this kv head
    const int h = hk * rep + rr;
    const long long row_base = ((long long)b * hq + h) * s_q;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int row0 = qt * TR;
      // tiles wholly before the causal frontier add nothing
      if (causal && row0 + TR - 1 + offset < col0) continue;
      __syncthreads();
      load_tile<T, W, TR>(q_s, q + qv.at(b, 0, h), qv.ss, row0, s_q, d);
      load_tile<T, W, TR>(do_s, dout + dov.at(b, 0, h), dov.ss, row0, s_q,
                          d);
      load_stats<TR>(lse_s, delta_s, lse, delta, row_base, row0, s_q);
      __syncthreads();
      p_and_ds<W, TR, SEG, DROP>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s,
                                 ds_s, row0, col0, offset, causal, s_k,
                                 sm_scale, dr, (unsigned)(b * hq + h), segb);
      __syncthreads();
      mm_atb<W, TR>(p_s, do_s, dv_acc);     // dv += p^T do
      mm_atb<W, TR>(ds_s, q_s, dk_acc);     // dk += ds^T q
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = col0 + ty + 16 * i;
    if (row < s_k) {
      T* dkr = dk + dkv.at(b, row, hk);
      T* dvr = dv + dvv.at(b, row, hk);
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        if (tx + 16 * j >= d) continue;
        store(dkr + tx + 16 * j, dk_acc[i][j]);
        store(dvr + tx + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int W, bool SEG, bool DROP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 View qv, View kv, View vv, View dov, View dqv, int hq,
                 int hkv, int s_q, int s_k, int causal, float sm_scale,
                 Dropout dr, const float* __restrict__ seg, int d) {
  constexpr int TR = f32_rows<W>();
  constexpr int LD = W + 1, LDS = TR + 1, MI = TR / 16;
  constexpr int JD = W / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [TR][W + 1] each
  float* do_s = q_s + TR * LD;
  float* k_s = do_s + TR * LD;
  float* v_s = k_s + TR * LD;
  float* ds_s = v_s + TR * LD;              // [TR][TR + 1]
  float* lse_s = ds_s + TR * LDS;
  float* delta_s = lse_s + TR;

  const int row0 = blockIdx.x * TR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + kv.at(b, 0, hk);
  const T* vb = v + vv.at(b, 0, hk);
  const float* segb = SEG ? seg + (long long)b * s_k : nullptr;

  load_tile<T, W, TR>(q_s, q + qv.at(b, 0, h), qv.ss, row0, s_q, d);
  load_tile<T, W, TR>(do_s, dout + dov.at(b, 0, h), dov.ss, row0, s_q, d);
  load_stats<TR>(lse_s, delta_s, lse, delta, ((long long)b * hq + h) * s_q,
                 row0, s_q);

  float acc[MI][JD];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  const int n_kt = k_tiles_for<TR>(row0, s_q, s_k, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, W, TR>(k_s, kb, kv.ss, kt * TR, s_k, d);
    load_tile<T, W, TR>(v_s, vb, vv.ss, kt * TR, s_k, d);
    __syncthreads();
    p_and_ds<W, TR, SEG, DROP>(q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr,
                               ds_s, row0, kt * TR, offset, causal, s_k,
                               sm_scale, dr, (unsigned)(b * hq + h), segb);
    __syncthreads();
    mm_ab<W, TR>(ds_s, k_s, acc);           // dq += ds k
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < s_q) {
      T* dqr = dq + dqv.at(b, row, h);
#pragma unroll
      for (int j = 0; j < JD; ++j)
        if (tx + 16 * j < d) store(dqr + tx + 16 * j, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK / dV through mma.sync.m16n8k16 (bf16 operands, f32
// accumulators; since the wgmma bodies came, the launches without segments
// at kMmaSyncDkvWidth alone).  Every score, p, dP, ds and output
// accumulator lives in registers: a warp owns 16 key rows, an S^T = K . Q^T
// product comes out as accumulator fragments (thread (g, t) = (lane / 4,
// lane % 4) holds rows g and g + 8, columns 2t and 2t + 1 of each 8-column
// n-tile), and those fragments are, with no data movement, the A operand
// of the next products (p^T . dO and ds^T . Q).  Row statistics reduce over
// the 4 lanes of a row by shuffles.  Q / dO tiles reach shared memory by
// cp.async through a ring of stages (the copy of tile j + 1 runs while the
// products of tile j do), with one block barrier per tile; their rows are
// stored swizzled or padded (sm90_mma.cuh swz), so that every ldmatrix
// phase reads 8 distinct bank groups.  The softmax runs in base 2 (scores
// times sm_scale * log2 e, ex2.approx), which is the same function.
// ---------------------------------------------------------------------------
// Compile-time settings, measured on phase 5b of chip_smoke.py (which
// builds variants of them for that measurement only; the port loads the
// defaults).  At D = 64 dK / dV holds 12 warps on an SM: the register cap
// of the launch bounds is what lets more than one block in, and
// occupancy, more than the ring's depth, hides the loads.  The D = 64
// settings also hold for the narrower widths (32, 48); the wider ones, and
// W = 64 with D < 64, take no cap (one block per SM at least), so that
// nothing there spills for want of registers.
#ifndef FA_STAGES
#define FA_STAGES 2            // depth of the Q / dO ring; 1 = no copy
#endif                         // overlaps
#ifndef FA_DKV_WARPS
#define FA_DKV_WARPS 4         // dK / dV key rows per block = 16 x warps
#endif
#ifndef FA_DKV_MINB
#define FA_DKV_MINB 3          // dK / dV blocks per SM at D = 64
#endif
#ifndef FA_DKV_BQ64
#define FA_DKV_BQ64 64         // dK / dV q tile at D = 64 (32 at D = 128)
#endif

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeyTile = 64;           // keys a k tile (but the forward's
                                       // 128-key designs)

// the (W, PART) bodies that take the D = 64 occupancy settings
__host__ __device__ constexpr bool fa_narrow(int w, bool part) {
  return w < 64 || (w == 64 && !part);
}

// blocks sharing the output columns of one dK / dV tile: two above W 160,
// where dK and dV would not fit the registers
template <int W>
__host__ __device__ constexpr int dkv_split() { return W > 160 ? 2 : 1; }

// rows [row0, row0 + R) of a [.., d] row tile (row stride ss) -> the
// [R][W] shared tile, 16 bytes per cp.async; rows at or past `rows`, and
// with PART the chunks at or past d, are zeros
template <int W, int R, int NTHR, bool PART>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int rows,
                                          int d) {
  constexpr int NC = W / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * NC; i += NTHR) {
    const int r = i / NC, c = i % NC, row = row0 + r;
    if constexpr (PART) {
      const bool in = c * 8 < d;
      cp_async16(dst + swz<W>(r, c),
                 src + (long long)min(row, rows - 1) * ss + (in ? c * 8 : 0),
                 row < rows && in);
    } else {
      cp_async16(dst + swz<W>(r, c),
                 src + (long long)min(row, rows - 1) * ss + c * 8,
                 row < rows);
    }
  }
}

// number of bn-key tiles that a q tile of rows [row0, row0 + R) visits
__device__ __forceinline__ int key_tiles(int row0, int R, int s_q, int s_k,
                                         int causal, int bn = kKeyTile) {
  const int n = (s_k + bn - 1) / bn;
  if (!causal) return n;
  const int last = min(row0 + R, s_q) - 1 + (s_k - s_q);
  return last < 0 ? 0 : min(n, last / bn + 1);
}

// dK / dV, bf16.  A block takes 16 x NW key rows of one (batch, kv head)
// and keeps them (K, V) in shared memory; warp w owns keys 16 w .. 16 w + 15
// and their dK, dV accumulators in registers, across every (q head of the
// GQA group, q tile) pair, so the sum over the group needs no atomics.  Per
// q tile of BQ rows it computes the transposed tiles S^T = K Q^T and
// dP^T = V dO^T, whose fragments (rows = keys) are already the A operand of
// dV += p^T dO and dK += ds^T Q; lse and delta index q rows, so they are
// read per fragment column.  p and ds enter those products as hi + lo bf16
// pairs (2^-16 relative, as the TPU kernel's f32).  Q, dO, lse and delta
// tiles stream through the cp.async ring.  The key blocks with the most q
// tiles (the first ones, when causal) are launched first.  Above W 160,
// grid z splits the output columns: block z accumulates columns
// [z W / 2, (z + 1) W / 2) of dK and dV.  (The segment branch is the
// wgmma dK / dV's.)
template <int W, bool PART, int NW, int BQ, int NS, bool DROP>
__global__ void __launch_bounds__(NW * 32,
                                  (fa_narrow(W, PART) ? FA_DKV_MINB : 1))
fa_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, View qv, View kv,
                      View vv, View dov, View dkv, View dvv, int hq, int hkv,
                      int s_q, int s_k, int causal, float sm_scale,
                      Dropout dr, int d) {
  constexpr int BK = 16 * NW, NTHR = NW * 32;
  constexpr int LD = tile_ld<W>();
  constexpr int KS = W / 16;                // k-steps of K Q^T
  constexpr int NQ = BQ / 8;                // n-tiles of S^T (q columns)
  constexpr int WO = W / dkv_split<W>();    // output columns of a block
  constexpr int NO = WO / 8;                // its n-tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][W]
  __nv_bfloat16* v_s = k_s + BK * LD;
  __nv_bfloat16* ring = v_s + BK * LD;      // NS x {Q, dO} [BQ][W]
  float* stats = reinterpret_cast<float*>(ring + NS * 2 * BQ * LD);
                                            // NS x {lse, delta} [BQ]

  const int col0 = blockIdx.y * BK;
  const int hk = blockIdx.x % hkv, b = blockIdx.x / hkv;
  const int c0 = dkv_split<W>() > 1 ? blockIdx.z * WO : 0;  // first column
  const int rep = hq / hkv;
  const int offset = s_k - s_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = col0 + warp * 16;         // the warp's first key

  // q tiles wholly before the block's causal frontier add nothing
  const int n_qt = (s_q + BQ - 1) / BQ;
  int qt0 = 0;
  if (causal) {
    const int x = col0 - offset - BQ + 1;   // first row0 that can see col0
    qt0 = x <= 0 ? 0 : (x + BQ - 1) / BQ;
  }
  const int nq = max(n_qt - qt0, 0);
  const int n_it = rep * nq;
  auto load_q = [&](int it) {
    const int st = it % NS;
    const int h = hk * rep + it / nq, row0 = (qt0 + it % nq) * BQ;
    __nv_bfloat16* qs = ring + st * 2 * BQ * LD;
    copy_rows<W, BQ, NTHR, PART>(qs, q + qv.at(b, 0, h), qv.ss, row0, s_q,
                                 d);
    copy_rows<W, BQ, NTHR, PART>(qs + BQ * LD, dout + dov.at(b, 0, h),
                                 dov.ss, row0, s_q, d);
    if (threadIdx.x < BQ) {
      const int row = row0 + threadIdx.x;
      const long long at = ((long long)b * hq + h) * s_q + min(row, s_q - 1);
      float* ls = stats + st * 2 * BQ;
      cp_async4(ls + threadIdx.x, lse + at, row < s_q);
      cp_async4(ls + BQ + threadIdx.x, delta + at, row < s_q);
    }
  };

  // group 0: K, V and q tile 0; groups 1 .. NS - 2: q tiles 1 .. NS - 2
  copy_rows<W, BK, NTHR, PART>(k_s, k + kv.at(b, 0, hk), kv.ss, col0, s_k,
                               d);
  copy_rows<W, BK, NTHR, PART>(v_s, v + vv.at(b, 0, hk), vv.ss, col0, s_k,
                               d);
#pragma unroll
  for (int s = 0; s < (NS > 1 ? NS - 1 : 1); ++s) {
    if (s < n_it) load_q(s);
    cp_async_commit();
  }

  const float scale2 = sm_scale * kLog2e;
  const float neg2 = kNegInf * kLog2e;
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk_acc[n][e] = 0.f; dv_acc[n][e] = 0.f; }

  for (int it = 0; it < n_it; ++it) {
    if constexpr (NS == 1) {
      if (it > 0) {
        __syncthreads();
        load_q(it);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (it + NS - 1 < n_it) load_q(it + NS - 1);
      cp_async_commit();
    }
    const int row0 = (qt0 + it % nq) * BQ;
    // a warp whose keys no row of this tile can see adds nothing
    if (causal && row0 + BQ - 1 + offset < wk0) continue;
    const int st = it % NS;
    const __nv_bfloat16* qs = ring + st * 2 * BQ * LD;
    const __nv_bfloat16* dos = qs + BQ * LD;
    const float* ls = stats + st * 2 * BQ;

    float sc[NQ][4], dp[NQ][4];             // S^T and dP^T: keys x q rows
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) { sc[j][e] = 0.f; dp[j][e] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ka[4], va[4];
      load_a<W>(ka, k_s, warp * 16, kk);
      load_a<W>(va, v_s, warp * 16, kk);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        unsigned bf[4];
        load_bt<W>(bf, qs, np * 16, kk);
        mma16816(sc[2 * np], ka, bf[0], bf[1]);
        mma16816(sc[2 * np + 1], ka, bf[2], bf[3]);
        load_bt<W>(bf, dos, np * 16, kk);
        mma16816(dp[2 * np], va, bf[0], bf[1]);
        mma16816(dp[2 * np + 1], va, bf[2], bf[3]);
      }
    }

    // p = exp(s - lse) and ds = p (dP - delta) sm_scale; only a tile that
    // crosses the warp's causal frontier is masked (NEG_INF, as the TPU).
    // With DROP, dV takes the dropped p and ds the dropped dP.  The
    // fragment is transposed (rows = keys), so a thread's scores of one q
    // column lie in one call, but use 2 of its words: lanes g and g ^ 1
    // (lane ^ 4) hold the same q columns and the other 2 words, so each
    // draws the call of one of their 2 columns and they swap halves.
    const unsigned bhq = b * hq + hk * rep + it / nq;
    const unsigned kcell = (unsigned)(wk0 >> 4) * 4u + (g >> 1);
    const bool odd = g & 1;
    const bool masked = causal && row0 + offset < wk0 + 15;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 =
          *reinterpret_cast<const float2*>(ls + BQ + 8 * j + 2 * t);
      unsigned kw[4];                       // element e's word: q column
      if constexpr (DROP) {                 // 2t + (e & 1), key g + 8 (e >> 1)
        const uint4 w =
            dropout_words(dr, kcell, row0 + 8 * j + 2 * t + odd, bhq);
        const unsigned ra = __shfl_xor_sync(kFull, odd ? w.x : w.y, 4);
        const unsigned rb = __shfl_xor_sync(kFull, odd ? w.z : w.w, 4);
        const unsigned ma = odd ? w.y : w.x, mb = odd ? w.w : w.z;
        kw[0] = odd ? ra : ma;
        kw[1] = odd ? ma : ra;
        kw[2] = odd ? rb : mb;
        kw[3] = odd ? mb : rb;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = ((e & 1) ? l2.y : l2.x) * kLog2e;
        const float dl = (e & 1) ? d2.y : d2.x;
        float x = sc[j][e] * scale2;
        if (masked && row0 + 8 * j + 2 * t + (e & 1) + offset <
                          wk0 + g + 8 * (e >> 1))
          x = neg2;
        const float p = fast_exp2(x - lse2);
        if constexpr (DROP) {
          sc[j][e] = dropped(dr, kw[e], p);
          dp[j][e] = p * (dropped(dr, kw[e], dp[j][e]) - dl) * sm_scale;
        } else {
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl) * sm_scale;
        }
      }
    }

    // dV += p^T dO and dK += ds^T Q, each factor as hi + lo, over this
    // block's output columns
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      unsigned ph[4], pl[4], dh[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kq + (i >> 1), e = 2 * (i & 1);
        split_pair(sc[j][e], sc[j][e + 1], ph[i], pl[i]);
        split_pair(dp[j][e], dp[j][e + 1], dh[i], dl[i]);
      }
#pragma unroll
      for (int np = 0; np < WO / 16; ++np) {
        unsigned bf[4];
        load_b<W>(bf, dos, kq * 16, c0 / 16 + np);
        mma16816(dv_acc[2 * np], ph, bf[0], bf[1]);
        mma16816(dv_acc[2 * np], pl, bf[0], bf[1]);
        mma16816(dv_acc[2 * np + 1], ph, bf[2], bf[3]);
        mma16816(dv_acc[2 * np + 1], pl, bf[2], bf[3]);
        load_b<W>(bf, qs, kq * 16, c0 / 16 + np);
        mma16816(dk_acc[2 * np], dh, bf[0], bf[1]);
        mma16816(dk_acc[2 * np], dl, bf[0], bf[1]);
        mma16816(dk_acc[2 * np + 1], dh, bf[2], bf[3]);
        mma16816(dk_acc[2 * np + 1], dl, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wk0 + g + 8 * r;
    if (row >= s_k) continue;
    __nv_bfloat16* dkr = dk + dkv.at(b, row, hk) + c0;
    __nv_bfloat16* dvr = dv + dvv.at(b, row, hk) + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (PART && c0 + 8 * n >= d) continue;
      *reinterpret_cast<unsigned*>(dkr + 8 * n + 2 * t) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<unsigned*>(dvr + 8 * n + 2 * t) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The wgmma bodies: the bf16 forward and dQ of every launch, and the bf16
// dK / dV of every launch but those without segments at W 160, written
// for Hopper's warpgroups (sm90_wgmma.cuh). A block holds consumer warpgroups
// of 64 rows each (q rows in the forward and dQ, keys in dK / dV) and one
// producer warp that keeps the block's ring of tiles full by TMA. The
// products are wgmma: S = Q K^T (and S^T = K Q^T, dP^T = V dO^T, dP = dO V^T)
// from two shared tiles, then O += P V (and dV += p^T dO, dK += ds^T Q, dQ +=
// ds K, p and ds as hi + lo) with the score fragments in registers as the A
// operand. The output columns run in 64-column panels, so W 32, 48, 80, 96
// and 160 carry zero columns up to the next panel (W 160 runs three). Above
// two panels, dK / dV splits its output panels between two blocks (grid z),
// each with at most two, and dQ between the two consumers of a 64-row block.
//
// Per-tile segment classes (tile_class): before the producer loads a
// streamed tile it reads the tile's ids (one warp, from L2), takes their
// [min, max] and compares it with the block's own rows (the forward: its
// q rows, for both consumers; dQ likewise) or with each consumer's keys
// (dK / dV):
//   disjoint ranges: no pair shares an id, and the tile is skipped (never
//     loaded when every consumer skips it, never computed);
//   both ranges one and the same value: the unmasked path;
//   otherwise masked per score, from the ids staged beside the tile.
// The causal frontier (a tile wholly past it is skipped, one that crosses
// it masked) and the end of the keys mask as before.  A skipped tile's
// scores would all be NEG_INF for rows that always meet their own key
// (s_q = s_k with equal ids), so skipping changes no value: after a row's
// first real score exp(NEG_INF - m) is 0 in f32, and before it the
// rescale by exp(NEG_INF - m_real) clears whatever masked tiles summed.
// Without segments only the causal frontier skips (and the end of the keys
// masks).  ops/flash_attention.py segment_tile_plan is the same rule in
// PyTorch.
//
// The producer streams one entry per loaded tile through the ring: the
// tile (TMA, counted in bytes on the stage's full barrier), its ids (and,
// in dK / dV, the q rows' lse and delta), and a record of which tile it is
// and each consumer's class; a last record with no tile ends the stream.
// Each consumer warp releases a stage (its empty barrier counts them) once
// its products on it are done.
// A block: two consumer warpgroups and a producer warpgroup, of which one
// warp works.  ptxas allocates 168 registers a thread at launch (three
// warps share an SM sub-partition's 16,384), and the producer's 128 x
// (168 - 40) equal the consumers' 256 x (232 - 168), so that
// setmaxnreg.inc, which waits for the block's own released registers,
// always completes.
constexpr int kHpThreads = 384;
constexpr int kHpConsumerRegs = 232, kHpProducerRegs = 40;
enum TileClass : int { kTileSkip = 0, kTileFull = 1, kTileMasked = 2 };
// 64-column panels of a width-W tile
template <int W>
__host__ __device__ constexpr int hp_panels() { return (W + 63) / 64; }
// blocks sharing the output panels of a dK / dV key block, the panels each
// takes (at most), its streamed q tile and its ring depth.  A consumer
// holds dK and dV of its panels (64 registers a panel), S^T and dP^T of
// the tile it scores and the hi + lo p and ds of the tile whose products
// are in flight (BQ registers each): 192 of its 232 at one panel with
// 64-row q tiles (FA_DKV_HP_BQ) and at two with 32-row ones.  It holds two
// stages, so the ring loads FA_DKV_HP_STAGES - 2 tiles ahead, or as many
// as fit the 227 KB beside K and V.
#ifndef FA_DKV_HP_BQ
#define FA_DKV_HP_BQ 64
#endif
#ifndef FA_DKV_HP_STAGES
#define FA_DKV_HP_STAGES 4
#endif
// 0 builds dK / dV without the pipelining (each tile's products issued
// after its exponentials), for the design step that times the two
#ifndef FA_DKV_HP_PIPELINE
#define FA_DKV_HP_PIPELINE 1
#endif
template <int W>
__host__ __device__ constexpr int hp_dkv_split() {
  return hp_panels<W>() > 2 ? 2 : 1;
}
template <int W>
__host__ __device__ constexpr int hp_dkv_panels() {
  return (hp_panels<W>() + hp_dkv_split<W>() - 1) / hp_dkv_split<W>();
}
template <int W>
__host__ __device__ constexpr int hp_dkv_bq() {
  return hp_dkv_panels<W>() > 1 ? 32 : FA_DKV_HP_BQ;
}
template <int W>
__host__ __device__ constexpr int hp_dkv_stages() {
  constexpr int NP = hp_panels<W>(), BQ = hp_dkv_bq<W>();
  constexpr int fit = (232448 - 1024 - 64 - 2 * NP * 128 * 128) /
                      (2 * NP * BQ * 128 + 3 * BQ * 4 + 48);
  return fit < FA_DKV_HP_STAGES ? fit : FA_DKV_HP_STAGES;
}
// dQ: the q rows of a block and the output panels of each consumer.  Up to
// two panels a block takes 128 rows, 64 per consumer, each with every
// output panel; above, the resident Q and dO of 128 rows would leave no
// room for a ring, so a block takes 64 rows, both consumers compute their
// S and dP, and each accumulates half of the output panels.  The ring
// holds as many K / V stages as fit the 227 KB, at most FA_DQ_HP_STAGES.
#ifndef FA_DQ_HP_STAGES
#define FA_DQ_HP_STAGES 4
#endif
template <int W>
__host__ __device__ constexpr int hp_dq_rows() {
  return hp_panels<W>() <= 2 ? 128 : 64;
}
template <int W>
__host__ __device__ constexpr int hp_dq_panels() {
  return hp_panels<W>() <= 2 ? hp_panels<W>() : 2;
}
template <int W>
__host__ __device__ constexpr int hp_dq_stages() {
  constexpr int NP = hp_panels<W>();
  constexpr int fit = (232448 - 4096 - 2 * NP * hp_dq_rows<W>() * 128) /
                      (2 * NP * kKeyTile * 128 + 288);
  return fit < FA_DQ_HP_STAGES ? fit : FA_DQ_HP_STAGES;
}

// the tensor maps of a launch: q, k, v and, for dK / dV, dO
struct HpMaps {
  CUtensorMap q, k, v, dout;
};

// The class of a (q tile, key tile) pair: q rows [r0, r_last] that lie
// inside S_q (none when r_last < r0), keys [c0, c0 + nk), and with seg the
// [min, max] of the rows' ids and of the keys' (those inside S_k)
__device__ __forceinline__ int tile_class(int r0, int r_last, int c0, int nk,
                                          int s_k, int offset, int causal,
                                          bool seg, float rlo, float rhi,
                                          float klo, float khi) {
  if (r_last < r0 || c0 >= s_k) return kTileSkip;
  if (causal && c0 > r_last + offset) return kTileSkip;
  if (seg && (khi < rlo || klo > rhi)) return kTileSkip;
  const bool crossing = causal && c0 + nk - 1 > r0 + offset;
  const bool partial = c0 + nk > s_k;
  const bool uniform = !seg || (rlo == rhi && klo == khi && rlo == klo);
  return crossing || partial || !uniform ? kTileMasked : kTileFull;
}

// the [min, max] of the ids at [r0, min(r0 + R, n)) by one warp
// (+inf, -inf when the range is empty), into dst[0], dst[1] by lane 0
template <int R>
__device__ __forceinline__ void seg_range(float* dst, const float* segb,
                                          int r0, int n) {
  const int lane = threadIdx.x % 32;
  float lo = __int_as_float(0x7f800000), hi = -lo;
#pragma unroll
  for (int i = 0; i < R; i += 32)
    if (r0 + i + lane < n) {
      const float x = segb[r0 + i + lane];
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
  lo = -warp_max(-lo);
  hi = warp_max(hi);
  if (lane == 0) {
    dst[0] = lo;
    dst[1] = hi;
  }
}

// the ids of `n` streamed rows or keys [r0, r0 + n) (n = 32 or 64) by one
// warp: each lane's (n / 32) ids, clamped to the last one inside `len`,
// and the [min, max] of those inside it
template <int N>
__device__ __forceinline__ void tile_ids(float (&id)[N / 32], float& lo,
                                         float& hi, const float* segb, int r0,
                                         int len) {
  const int lane = threadIdx.x % 32;
  lo = __int_as_float(0x7f800000);
  hi = -lo;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const int r = r0 + 32 * i + lane;
    id[i] = segb[min(r, len - 1)];
    if (r < len) {
      lo = fminf(lo, id[i]);
      hi = fmaxf(hi, id[i]);
    }
  }
  lo = -warp_max(-lo);
  hi = warp_max(hi);
}

// The producer warp's stream of the key tiles that q rows [row0, row0 + BM)
// need, in order (the forward's and dQ's): each BN-key tile classed for
// those rows (tile_class against their ids' [min, max] in range_s; a
// skipped tile is never loaded), the others loaded into ring stage `stage`
// once every consumer warp has released it (empty[stage]): the K and V
// panels by TMA, counted on full[stage], the tile's ids in ids_s and a
// {kt, class, end} record in meta; then a record with the end flag.
// `stage` and `phase` carry the ring's position from one call to the next
// (the persistent forward streams one q tile after another).
template <int BM, int BN, int NP, int NS, bool SEG>
__device__ __forceinline__ void stream_key_tiles(
    const HpMaps& maps, __nv_bfloat16* k_s, __nv_bfloat16* v_s,
    float* ids_s, int* meta, uint64_t* full, uint64_t* empty,
    const float* segb, const float* range_s, int row0, int hk, int b,
    int s_q, int s_k, int causal, int& stage, unsigned& phase) {
  constexpr int PK = BN * 64;
  const int lane = threadIdx.x % 32;
  const int offset = s_k - s_q;
  const float rlo = SEG ? range_s[0] : 0.f, rhi = SEG ? range_s[1] : 0.f;
  const int n_kt = key_tiles(row0, BM, s_q, s_k, causal, BN);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int c0 = kt * BN;
    float id[BN / 32] = {}, klo = 0.f, khi = 0.f;
    if constexpr (SEG) tile_ids<BN>(id, klo, khi, segb, c0, s_k);
    const int cls = tile_class(row0, min(row0 + BM, s_q) - 1, c0, BN, s_k,
                               offset, causal, SEG, rlo, rhi, klo, khi);
    if (cls == kTileSkip) continue;
    mbar_wait(&empty[stage], phase ^ 1);
    if constexpr (SEG)
#pragma unroll
      for (int i = 0; i < BN / 32; ++i)
        ids_s[stage * BN + 32 * i + lane] = id[i];
    if (lane == 0) {
      int* mt = meta + 4 * stage;
      mt[0] = kt;
      mt[1] = cls;
      mt[2] = 0;
      mbar_arrive_tx(&full[stage], 2 * NP * PK * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_s + (stage * NP + p) * PK, &maps.k, &full[stage], 64 * p,
                 c0, hk, b);
        tma_load(v_s + (stage * NP + p) * PK, &maps.v, &full[stage], 64 * p,
                 c0, hk, b);
      }
    } else {
      mbar_arrive(&full[stage]);
    }
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&empty[stage], phase ^ 1);
  if (lane == 0) meta[4 * stage + 2] = 1;   // the end of the stream
  mbar_arrive(&full[stage]);
  if (++stage == NS) {
    stage = 0;
    phase ^= 1;
  }
}

// The forward's block shapes.  A block holds two consumer warpgroups of 64
// q rows each (BM = 128 q rows of one (batch, q head)) and a producer
// warpgroup, and streams BN-key tiles through a ring; with PERSIST the
// grid holds one block per SM, which walks q tiles (fa_fwd_wgmma_kernel).
// The ring holds as many stages as fit the 227 KB, at most
// FA_FWD_HP_STAGES (a build setting for timing deeper rings against the
// shipped 4: chip_smoke.py's FWD_VARIANTS); a consumer holds two of them
// (the tile it scores and the one whose P V is in flight), so the producer
// loads NS - 2 tiles ahead.
// With PERSIST the Q tile is double buffered, so that the next q tile's Q
// loads during this one's products.
#ifndef FA_FWD_HP_STAGES
#define FA_FWD_HP_STAGES 4
#endif
template <int W, int BN, bool PERSIST>
struct HpFwd {
  static constexpr int NP = hp_panels<W>(), BM = 128;
  static constexpr int QB = PERSIST ? 2 : 1;         // Q buffers
  // alignment slack, Q, the rows' ids and the Q barriers; then per stage K,
  // V, the keys' ids, the record and the two barriers
  static constexpr int FIXED = 1024 + QB * NP * BM * 128 + 16 + 2 * QB * 8;
  static constexpr int STAGE = 2 * NP * BN * 128 + BN * 4 + 16 + 2 * 8;
  static constexpr int FIT = (232448 - FIXED) / STAGE;
  static constexpr int NS = FIT < FA_FWD_HP_STAGES ? FIT : FA_FWD_HP_STAGES;
  static constexpr int SMEM = FIXED + NS * STAGE;
};

// Forward.  A block takes 128 q rows of one (batch, q head) at a time;
// consumer warpgroup w owns rows 64 w .. 64 w + 63 of them, and its warp v
// rows 16 v .. 16 v + 15, with their S, P and O accumulators in registers.
// The tiles are classed for the block's 128 rows (both consumers take
// every streamed tile, each K / V tile feeds 128 rows), and the producer
// streams the key tiles that the rows need, in order, so the online
// softmax sees them as the TPU kernel does.  Each consumer pipelines them:
// it issues S = Q K^T of a tile and then P V of the tile before, so that
// its softmax of the one runs while the tensor cores work on the other,
// and rescales O once that P V is done.  Every wgmma is issued on every
// pass (where no tile is pending, P is zero against the K tile at hand),
// so that none sits on a branch, where the compiler would serialise them.
// With DROP each tile's keep bits, one a score, are drawn once its S and
// the pending P V are issued and before they are waited for (a keep word
// depends only on the score's coordinates), and applied where p is packed;
// and the two consumer groups take turns to issue their products.
// q tiles run longest first: tile i of the order is q tile n_qt - 1 -
// i / BH of (batch, q head) row i % BH (BH = batch x q heads).  Without
// PERSIST block i takes tile i; with PERSIST block i takes tiles i, i +
// grid, i + 2 grid, .., and the producer loads the next tile's Q and K / V
// while the consumers finish this one.
template <int W, int BN, bool PERSIST, bool SEG, bool DROP>
__global__ void __launch_bounds__(kHpThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ HpMaps maps,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    View ov, int hq, int hkv, int s_q, int s_k, int causal,
                    float sm_scale, Dropout dr, const float* __restrict__ seg,
                    int d, int n_tiles) {
  using F = HpFwd<W, BN, PERSIST>;
  static_assert(!(SEG && PERSIST), "segments take a block per q tile");
  constexpr int NP = F::NP, NS = F::NS, BM = F::BM, QB = F::QB;
  constexpr int KS = W / 16;
  static_assert(NS >= 2, "a consumer holds two stages of the ring");
  constexpr int PQ = BM * 64, PK = BN * 64;  // elements of a Q / K panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base);  // QB x NP x PQ
  __nv_bfloat16* k_s = q_s + QB * NP * PQ;  // NS x NP x PK
  __nv_bfloat16* v_s = k_s + NS * NP * PK;  // NS x NP x PK
  float* ids_s = reinterpret_cast<float*>(v_s + NS * NP * PK);  // NS x BN
  float* range_s = ids_s + NS * BN;         // the rows' ids [2]
  int* meta = reinterpret_cast<int*>(range_s + 4);  // NS x {kt, class, end}
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + 4 * NS);
  uint64_t* empty = full + NS;
  uint64_t* qfull = empty + NS;             // QB
  uint64_t* qempty = qfull + QB;            // QB

  const int n_qt = (s_q + BM - 1) / BM, n_bh = n_tiles / n_qt;
  const int offset = s_k - s_q;
  auto tile_at = [&](int tile, int& row0, int& h, int& b) {
    row0 = (n_qt - 1 - tile / n_bh) * BM;
    h = tile % n_bh % hq;
    b = tile % n_bh / hq;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 8);
    }
    for (int q = 0; q < QB; ++q) {
      mbar_init(&qfull[q], 1);
      mbar_init(&qempty[q], 8);
    }
    mbar_fence_init();
  }
  if constexpr (SEG)
    if (threadIdx.x < 32) {
      int row0, h, b;
      tile_at(blockIdx.x, row0, h, b);
      seg_range<BM>(range_s, seg + (long long)b * s_k, row0, s_q);
    }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one warp loads each q tile's Q, then classifies and
    // streams the key tiles that its rows need
    regs_dealloc<kHpProducerRegs>();
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x % 32;
    int stage = 0;
    unsigned phase = 0;
    for (int it = 0, tile = blockIdx.x; tile < n_tiles;
         ++it, tile += gridDim.x) {
      int row0, h, b;
      tile_at(tile, row0, h, b);
      const int qb = it % QB;
      mbar_wait(&qempty[qb], ((it / QB) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(&qfull[qb], NP * PQ * 2);
        for (int p = 0; p < NP; ++p)
          tma_load(q_s + (qb * NP + p) * PQ, &maps.q, &qfull[qb], 64 * p,
                   row0, h, b);
      }
      stream_key_tiles<BM, BN, NP, NS, SEG>(
          maps, k_s, v_s, ids_s, meta, full, empty,
          SEG ? seg + (long long)b * s_k : nullptr, range_s, row0,
          h / (hq / hkv), b, s_q, s_k, causal, stage, phase);
    }
  } else {
    regs_alloc<kHpConsumerRegs>();
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const float scale2 = sm_scale * kLog2e;
    const float neg2 = kNegInf * kLog2e;
    // Under DROP the two groups take turns to issue their products (named
    // barriers 1 and 2), so that one group's keep bits and softmax run
    // while the other's products do: 7% off 3d's forward at rate 0.1; at
    // rate 0 turns measured within 1.5% either way (PERF.md §6)
    constexpr bool kTurns = DROP;
    if (kTurns && wg == 1) bar_arrive(1, 256);   // group 0 issues first
    int stage = 0;
    unsigned phase = 0;
    for (int it = 0, tile = blockIdx.x; tile < n_tiles;
         ++it, tile += gridDim.x) {
      int row0, h, b;
      tile_at(tile, row0, h, b);
      const int qb = it % QB;
      const int wrow = row0 + 64 * wg + 16 * warp;  // the warp's first q row
      const unsigned bhq = (unsigned)(b * hq + h);
      float rid[2] = {0.f, 0.f};              // ids of rows g, g + 8
      if constexpr (SEG)
        for (int r = 0; r < 2; ++r)
          rid[r] = seg[(long long)b * s_k + min(wrow + g + 8 * r, s_k - 1)];
      float acc[NP][8][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
      float m[2] = {neg2, neg2}, l[2] = {0.f, 0.f};
      // the pending tile: its P (zero while none is) and its V panels (while
      // none is, the K tile at hand, or any tile when the rows see no key:
      // their l stays 0 and the epilogue writes zeros)
      unsigned pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = 0u;
      const __nv_bfloat16* qw = q_s + qb * NP * PQ + 64 * 64 * wg;
      const __nv_bfloat16* vp = k_s;
      int pend = -1;                          // its stage (-1: none)
      auto issue_pv = [&]() {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NP; ++p)
            wgmma_rs(acc[p], pa[kk], desc_mn(vp + p * PK, kk));
      };
      mbar_wait(&qfull[qb], (it / QB) & 1);

      for (;;) {
        mbar_wait(&full[stage], phase);
        const int* mt = meta + 4 * stage;
        const bool end = mt[2] != 0;
        const int kcol0 = mt[0] * BN;
        const bool masked = mt[1] == kTileMasked;
        __syncwarp();
        if (end) {                            // release the end record
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == NS) {
            stage = 0;
            phase ^= 1;
          }
          break;
        }
        const __nv_bfloat16* ks = k_s + stage * NP * PK;
        if (pend < 0) vp = ks;
        float s[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        fence_acc(s);
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
        if (kTurns) bar_sync(1 + wg, 256);    // this group's turn
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss(s, desc_k(qw + (kk / 4) * PQ, kk % 4),
                   desc_k(ks + (kk / 4) * PK, kk % 4), kk > 0);
        wgmma_commit();
        issue_pv();                           // the pending tile's P V
        wgmma_commit();
        if (kTurns) bar_arrive(2 - wg, 256);  // the other group's turn
        // the tile's keep bits (DROP), drawn while S and the pending P V
        // run: bit 4 (j % 8) + e of kb[j / 8] is element e of n-tile j
        unsigned kb[BN / 64];
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          kb[c] = 0u;
          if constexpr (DROP) {
            kb[c] = keep_bits_rows<4>(dr, (unsigned)(kcol0 / 16 + 4 * c) * 4u +
                                              t,
                                      wrow + g, bhq);
            fence_reg(kb[c]);
          }
        }
        wgmma_wait<1>();                      // S has landed, P V runs on
        fence_acc(s);

        // a masked tile's scores are scaled here (a masked one is NEG_INF
        // exactly, -inf past the keys); a full tile stays raw and takes the
        // scale in the exponent's FFMA
        if (masked) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            float2 kid = make_float2(0.f, 0.f);
            if constexpr (SEG)
              kid = *reinterpret_cast<const float2*>(ids_s + stage * BN +
                                                     8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kcol0 + 8 * j + 2 * t + (e & 1);
              const int row = wrow + g + 8 * (e >> 1);
              float x = s[j][e] * scale2;
              if (col >= s_k) x = __int_as_float(0xff800000);
              else if (causal && row + offset < col) x = neg2;
              else if (SEG && rid[e >> 1] != ((e & 1) ? kid.y : kid.x))
                x = neg2;
              s[j][e] = x;
            }
          }
        }
        float mx[2] = {s[0][0], s[0][2]};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
        }
        const float sc = masked ? 1.f : scale2;
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
          mx[r] = fmaxf(m[r], mx[r] * sc);
          alpha[r] = fast_exp2(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(fmaf(s[j][e], sc, -m[e >> 1]));
            l[e >> 1] += p;
            s[j][e] = DROP ? kept(dr, kb[j / 8], 4 * (j % 8) + e, p) : p;
          }
        wgmma_wait<0>();                      // the pending P V is done
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
        fence_frag(pa);
        __syncwarp();
        if (pend >= 0 && lane == 0) mbar_arrive(&empty[pend]);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              acc[p][j][2 * r] *= alpha[r];
              acc[p][j][2 * r + 1] *= alpha[r];
            }
        // P (dropped, then rounded to bf16, as the TPU kernel does) is the
        // A operand of this tile's P V, straight from the score fragments
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        pend = stage;
        vp = v_s + stage * NP * PK;
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
      wgmma_fence();
      issue_pv();                             // the last tile's P V
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_acc(acc[p]);
      fence_frag(pa);
      // the last V tile and the Q tile are free for the producer's next ones
      __syncwarp();
      if (lane == 0) {
        if (pend >= 0) mbar_arrive(&empty[pend]);
        mbar_arrive(&qempty[qb]);
      }

      // finalize: o = acc / l where l > 0 (else 0), lse = m + log(max(l,
      // 1e-30)) into the compact (= TPU-packed) [B*Hq, S_q] row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
        const int row = wrow + g + 8 * r;
        if (row >= s_q) continue;
        const bool any = l[r] > 0.f;
        const float inv = any ? 1.f / l[r] : 0.f;
        __nv_bfloat16* orow = o + ov.at(b, row, h);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * p + 8 * j + 2 * t;
            if (col < d)
              *reinterpret_cast<unsigned*>(orow + col) =
                  any ? pack_bf16(acc[p][j][2 * r] * inv,
                                  acc[p][j][2 * r + 1] * inv)
                      : 0u;
          }
        if (t == 0)
          lse[((long long)b * hq + h) * s_q + row] =
              m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

template <int W>
constexpr int hp_dkv_smem() {
  constexpr int NC = 2;
  constexpr int NP = hp_panels<W>(), NS = hp_dkv_stages<W>();
  constexpr int BQ = hp_dkv_bq<W>();
  return 1024 + (2 * NP * 64 * NC * 64 + 2 * NS * NP * BQ * 64) * 2 +
         NS * 3 * BQ * 4 + 16 + NS * 32 + (2 * NS + 1) * 8;
}

// dK / dV.  A block takes 128 keys of one (batch, kv head) and keeps K
// and V in shared memory; consumer warpgroup w owns keys 64 w .. 64 w + 63
// and their dK, dV accumulators in registers (its output panels), across
// every (q head of the GQA group, q tile) pair that the producer streams,
// so the sum over the group needs no atomics.  Per q tile of BQ rows it
// computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, whose
// fragments (rows = keys) are the A operand of dV += p^T dO and dK +=
// ds^T Q, p and ds each as hi + lo (2^-16 relative, as the TPU kernel's
// f32).  The streamed record carries the tile's lse (in base 2), delta and
// ids beside its Q and dO tiles.  Each consumer pipelines the tiles as the
// forward and dQ do: it issues S^T and dP^T of a tile, then dV and dK of
// the tile before, so that its exponentials of the one run while the
// tensor cores work on the other.  The dropout branch draws the tile's keep
// bits (keep_bits_cols: one register for the tile's mask) once S^T and
// dP^T are issued and before they are waited for, and issues each tile's
// products after its exponentials.  Where no tile is pending (the first
// of a stream, or after a skipped one) a pass issues S^T and dP^T alone:
// each branch waits for the wgmma groups it committed, so that none is in
// flight across a branch (ptxas would serialise every wgmma of the kernel,
// C7520); where a block has fewer panels than NPB it repeats its last and
// stores it once.  A tile that none of a consumer's keys meets (its class
// skip: past the causal frontier, or no id in common) is released at once,
// after the pending tile's products, so that a consumer never holds more
// than the tile it scores and the one before.  dK is scaled by sm_scale in
// the epilogue.  Above two panels grid z splits the output panels.
template <int W, bool SEG, bool DROP>
__global__ void __launch_bounds__(kHpThreads, 1)
fa_bwd_dkv_wgmma_kernel(const __grid_constant__ HpMaps maps,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, View dkv, View dvv,
                        int hq, int hkv, int s_q, int s_k, int causal,
                        float sm_scale, Dropout dr,
                        const float* __restrict__ seg, int d) {
  constexpr int NP = hp_panels<W>(), NS = hp_dkv_stages<W>();
  constexpr int NPB = hp_dkv_panels<W>(), BQ = hp_dkv_bq<W>();
  constexpr int NC = 2, BK = 64 * NC, KS = W / 16, NQ = BQ / 8;
  constexpr int PK = BK * 64, PQ = BQ * 64;  // elements of a K / Q panel
  static_assert(NS >= 3, "a consumer holds two stages: the ring needs three");
  // the dropout branch does not pipeline: its keep bits, drawn while the
  // pending tile's products run, need their Philox registers beside all
  // 192 of the two tiles', which spilled 4-132 B at W 64-256 (PERF.md §6)
  constexpr bool PIPE = FA_DKV_HP_PIPELINE && !DROP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(base);  // NP x PK
  __nv_bfloat16* v_s = k_s + NP * PK;        // NP x PK
  __nv_bfloat16* q_s = v_s + NP * PK;        // NS x NP x PQ
  __nv_bfloat16* do_s = q_s + NS * NP * PQ;  // NS x NP x PQ
  float* stats = reinterpret_cast<float*>(do_s + NS * NP * PQ);
                                            // NS x {lse, delta, ids} [BQ]
  float* range_s = stats + NS * 3 * BQ;     // the consumers' key ids [2][2]
  int* meta = reinterpret_cast<int*>(range_s + 4);
                                            // NS x {h, row0, cls 0, 1, end}
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + 8 * NS);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;

  const int col0 = blockIdx.y * BK;
  const int hk = blockIdx.x % hkv, b = blockIdx.x / hkv;
  const int pz0 = blockIdx.z * NPB;          // the block's first out panel
  const int npb = min(NPB, NP - pz0);
  const int rep = hq / hkv;
  const int offset = s_k - s_q;
  const float* segb = SEG ? seg + (long long)b * s_k : nullptr;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 4 * NC);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  if constexpr (SEG)
    if (threadIdx.x < 32 * NC)
      seg_range<64>(range_s + 2 * (threadIdx.x / 32), segb,
                    col0 + 64 * (threadIdx.x / 32), s_k);
  __syncthreads();

  if (wg == NC) {
    // producer: warp 8 loads K and V, then classifies and streams the
    // (q head, q tile) pairs
    regs_dealloc<kHpProducerRegs>();
    if (threadIdx.x >= 128 * NC + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * NP * PK * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_s + p * PK, &maps.k, kvbar, 64 * p, col0, hk, b);
        tma_load(v_s + p * PK, &maps.v, kvbar, 64 * p, col0, hk, b);
      }
    }
    float klo[NC], khi[NC];
    for (int w = 0; w < NC; ++w) {
      klo[w] = SEG ? range_s[2 * w] : 0.f;
      khi[w] = SEG ? range_s[2 * w + 1] : 0.f;
    }
    // q tiles wholly before the block's causal frontier add nothing
    const int n_qt = (s_q + BQ - 1) / BQ;
    int qt0 = 0;
    if (causal) {
      const int x = col0 - offset - BQ + 1;   // first row0 that can see col0
      qt0 = x <= 0 ? 0 : (x + BQ - 1) / BQ;
    }
    const int nq = max(n_qt - qt0, 0);
    int stage = 0;
    unsigned phase = 0;
    for (int it = 0; it < rep * nq; ++it) {
      const int h = hk * rep + it / nq, row0 = (qt0 + it % nq) * BQ;
      float id[BQ / 32], qlo = 0.f, qhi = 0.f;
      if constexpr (SEG) tile_ids<BQ>(id, qlo, qhi, segb, row0, s_q);
      int cls[NC];
      bool any = false;
      for (int w = 0; w < NC; ++w) {
        cls[w] = tile_class(row0, min(row0 + BQ, s_q) - 1, col0 + 64 * w, 64,
                            s_k, offset, causal, SEG, qlo, qhi, klo[w],
                            khi[w]);
        any |= cls[w] != kTileSkip;
      }
      if (!any) continue;
      mbar_wait(&empty[stage], phase ^ 1);
      float* st = stats + stage * 3 * BQ;
#pragma unroll
      for (int i = 0; i < BQ / 32; ++i) {
        const int row = row0 + 32 * i + lane;
        const long long at = ((long long)b * hq + h) * s_q + row;
        st[32 * i + lane] = row < s_q ? lse[at] * kLog2e : 0.f;
        st[BQ + 32 * i + lane] = row < s_q ? delta[at] : 0.f;
        if constexpr (SEG) st[2 * BQ + 32 * i + lane] = id[i];
      }
      if (lane == 0) {
        int* mt = meta + 8 * stage;
        mt[0] = h;
        mt[1] = row0;
        for (int w = 0; w < NC; ++w) mt[2 + w] = cls[w];
        mt[4] = 0;
        mbar_arrive_tx(&full[stage], 2 * NP * PQ * 2);
        for (int p = 0; p < NP; ++p) {
          tma_load(q_s + (stage * NP + p) * PQ, &maps.q, &full[stage],
                   64 * p, row0, h, b);
          tma_load(do_s + (stage * NP + p) * PQ, &maps.dout, &full[stage],
                   64 * p, row0, h, b);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&empty[stage], phase ^ 1);
    if (lane == 0) meta[8 * stage + 4] = 1;   // the end of the stream
    mbar_arrive(&full[stage]);
  } else {
    regs_alloc<kHpConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wk = col0 + 64 * wg + 16 * warp;   // the warp's first key
    const float scale2 = sm_scale * kLog2e;
    const float neg2 = kNegInf * kLog2e;
    float kid[2] = {0.f, 0.f};                // ids of keys g, g + 8
    if constexpr (SEG)
      for (int r = 0; r < 2; ++r) kid[r] = segb[min(wk + g + 8 * r, s_k - 1)];
    float dk_acc[NPB][8][4], dv_acc[NPB][8][4];
#pragma unroll
    for (int p = 0; p < NPB; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk_acc[p][j][e] = 0.f;
          dv_acc[p][j][e] = 0.f;
        }
    const __nv_bfloat16* kw = k_s + 64 * 64 * wg;  // the group's keys
    const __nv_bfloat16* vw = v_s + 64 * 64 * wg;
    const unsigned kcell = (unsigned)(wk >> 4) * 4u + (g >> 1);
    const bool odd = g & 1;
    // the pending tile: its stage (-1: none), its p and ds as hi + lo and
    // its Q and dO panels
    unsigned ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dlo[BQ / 16][4];
    const __nv_bfloat16* qp = q_s;
    const __nv_bfloat16* dop = do_s;
    int pend = -1;
    auto fence_accs = [&]() {
#pragma unroll
      for (int p = 0; p < NPB; ++p) {
        fence_acc(dk_acc[p]);
        fence_acc(dv_acc[p]);
      }
    };
    auto fence_pending = [&]() {
      fence_frag(ph);
      fence_frag(pl);
      fence_frag(dh);
      fence_frag(dlo);
    };
    // dV += p^T dO and dK += ds^T Q of the pending tile, each factor as
    // hi + lo, over the block's output panels
    auto issue_products = [&]() {
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq)
#pragma unroll
        for (int p = 0; p < NPB; ++p) {
          const int pz = min(pz0 + p, NP - 1);
          const uint64_t bo = desc_mn(dop + pz * PQ, kq);
          const uint64_t bq = desc_mn(qp + pz * PQ, kq);
          wgmma_rs(dv_acc[p], ph[kq], bo);
          wgmma_rs(dv_acc[p], pl[kq], bo);
          wgmma_rs(dk_acc[p], dh[kq], bq);
          wgmma_rs(dk_acc[p], dlo[kq], bq);
        }
    };
    // the pending tile's products alone, waited for
    auto finish_pending = [&]() {
      fence_accs();
      wgmma_fence();
      issue_products();
      wgmma_commit();
      wgmma_wait<0>();
      fence_accs();
      fence_pending();
    };
    mbar_wait(kvbar, 0);

    int stage = 0;
    unsigned phase = 0;
    for (;;) {
      mbar_wait(&full[stage], phase);
      const int* mt = meta + 8 * stage;
      if (mt[4]) break;
      const int cls = mt[2 + wg];
      if (cls == kTileSkip) {
        // none of the group's keys meets the tile: release it, and the
        // pending tile once its products are done
        if (pend >= 0) {
          finish_pending();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[pend]);
          pend = -1;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
        continue;
      }
      const int h = mt[0], row0 = mt[1];
      const __nv_bfloat16* qs = q_s + stage * NP * PQ;
      const __nv_bfloat16* dos = do_s + stage * NP * PQ;
      const float* st = stats + stage * 3 * BQ;
      float sc[NQ][4], dp[NQ][4];           // S^T and dP^T: keys x q rows
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      auto issue_scores = [&]() {
        fence_acc(sc);
        fence_acc(dp);
        fence_accs();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss(sc, desc_k(kw + (kk / 4) * PK, kk % 4),
                   desc_k(qs + (kk / 4) * PQ, kk % 4), kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_ss(dp, desc_k(vw + (kk / 4) * PK, kk % 4),
                   desc_k(dos + (kk / 4) * PQ, kk % 4), kk > 0);
        wgmma_commit();
      };
      // the tile's keep bits (DROP), one a score: drawn once S^T and dP^T
      // are issued and before they are waited for, since a keep word
      // depends only on the score's coordinates, so that the Philox rounds
      // run on the integer pipe while the tensor cores work
      unsigned kb = 0;
      auto draw_keep = [&]() {
        if constexpr (DROP) {
          kb = keep_bits_cols<NQ>(dr, kcell, row0 + 2 * t, odd, b * hq + h);
          fence_reg(kb);
        }
      };
      auto p_and_ds = [&]() {
        // p = exp(s - lse) and ds = p (dP - delta) (the epilogue scales dK
        // by sm_scale).  With DROP, dV takes the dropped p and ds the
        // dropped dP: element e of n-tile j is keep bit 4 j + e
        const bool masked = cls == kTileMasked;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
          const float2 d2 =
              *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * t);
          float2 qid = make_float2(0.f, 0.f);
          if constexpr (SEG)
            qid = *reinterpret_cast<const float2*>(st + 2 * BQ + 8 * j +
                                                   2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse2 = (e & 1) ? l2.y : l2.x;
            const float dl = (e & 1) ? d2.y : d2.x;
            float x;
            if (masked) {
              const int qrow = row0 + 8 * j + 2 * t + (e & 1);
              const int key = wk + g + 8 * (e >> 1);
              x = sc[j][e] * scale2;
              if (key >= s_k) x = __int_as_float(0xff800000);
              else if (causal && qrow + offset < key) x = neg2;
              else if (SEG && kid[e >> 1] != ((e & 1) ? qid.y : qid.x))
                x = neg2;
              x -= lse2;
            } else {
              x = fmaf(sc[j][e], scale2, -lse2);
            }
            const float p = fast_exp2(x);
            if constexpr (DROP) {
              // one factor, 1 / (1 - rate) where kept, else 0, for both
              const float f = (kb >> (4 * j + e)) & 1u ? dr.scale : 0.f;
              sc[j][e] = p * f;
              dp[j][e] = p * (dp[j][e] * f - dl);
            } else {
              sc[j][e] = p;
              dp[j][e] = p * (dp[j][e] - dl);
            }
          }
        }
      };
      // each branch closes its wgmma groups: with a pending tile, its
      // products run while this tile's exponentials do; without one (the
      // first tile of a stream, or after a skipped one, and every tile
      // without PIPE), no product is issued
      if (PIPE && pend >= 0) {
        issue_scores();
        issue_products();                     // the pending tile's dV, dK
        wgmma_commit();
        wgmma_wait<1>();                      // S^T and dP^T have landed
        fence_acc(sc);
        fence_acc(dp);
        p_and_ds();
        wgmma_wait<0>();                      // the pending products are done
        fence_accs();
        fence_pending();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[pend]);
      } else {
        issue_scores();
        draw_keep();
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);
        p_and_ds();
      }
      // p and ds (hi + lo) of this tile are the A operands of its products
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 2 * kq + (i >> 1), e = 2 * (i & 1);
          split_pair(sc[j][e], sc[j][e + 1], ph[kq][i], pl[kq][i]);
          split_pair(dp[j][e], dp[j][e + 1], dh[kq][i], dlo[kq][i]);
        }
      pend = stage;
      qp = qs;
      dop = dos;
      if constexpr (!PIPE) {
        finish_pending();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[pend]);
        pend = -1;
      }
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (pend >= 0) finish_pending();          // the last tile's products

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wk + g + 8 * r;
      if (row >= s_k) continue;
      __nv_bfloat16* dkr = dk + dkv.at(b, row, hk);
      __nv_bfloat16* dvr = dv + dvv.at(b, row, hk);
#pragma unroll
      for (int p = 0; p < NPB; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * (pz0 + p) + 8 * j + 2 * t;
          if (p >= npb || col >= d) continue;
          *reinterpret_cast<unsigned*>(dkr + col) =
              pack_bf16(dk_acc[p][j][2 * r] * sm_scale,
                        dk_acc[p][j][2 * r + 1] * sm_scale);
          *reinterpret_cast<unsigned*>(dvr + col) =
              pack_bf16(dv_acc[p][j][2 * r], dv_acc[p][j][2 * r + 1]);
        }
    }
  }
}


template <int W>
constexpr int hp_dq_smem() {
  constexpr int NP = hp_panels<W>(), NS = hp_dq_stages<W>();
  return 1024 +
         (2 * NP * hp_dq_rows<W>() * 64 + 2 * NS * NP * kKeyTile * 64) * 2 +
         NS * kKeyTile * 4 + 16 + NS * 16 + (2 * NS + 1) * 8;
}

// dQ.  A block takes BM q rows of one (batch, q head) and keeps their Q and
// dO tiles resident (loaded once by TMA); consumer warpgroup w computes S =
// Q K^T and dP = dO V^T for its 64 rows (rows 64 w .. at BM 128, the
// block's rows at BM 64) and accumulates dQ += ds K over its output panels
// in registers, with ds = p (dP - delta) as hi + lo (2^-16 relative, as the
// TPU kernel's f32), the A operand straight from the score fragments, and
// K read MN-major as the forward reads V.  The rows' lse and delta sit in
// registers.  The producer classes the key tiles for the block's rows, as
// the forward does, and streams the K / V tiles the rows need.  Each
// consumer pipelines them: it issues S and dP of a tile, then ds K of the
// tile before, so that its exponentials of the one run while the tensor
// cores work on the other.  Every wgmma is issued on every pass (while no
// tile is pending, ds is zero against the resident Q tile), so that none
// sits on a branch; where a consumer has fewer panels than NPB (W 160 /
// 192) it repeats its last and stores it once.  dQ is scaled by sm_scale
// and rounded to bf16 once in the epilogue.  The q tiles with the most key
// tiles are launched first.
template <int W, bool SEG, bool DROP>
__global__ void __launch_bounds__(kHpThreads, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ HpMaps maps,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, View dqv, int hq,
                       int hkv, int s_q, int s_k, int causal, float sm_scale,
                       Dropout dr, const float* __restrict__ seg, int d) {
  constexpr int NP = hp_panels<W>(), NS = hp_dq_stages<W>();
  constexpr int BM = hp_dq_rows<W>(), NPB = hp_dq_panels<W>();
  constexpr int BN = kKeyTile, KS = W / 16;
  constexpr int PQ = BM * 64, PK = BN * 64;  // elements of a Q / K panel
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base);  // NP x PQ
  __nv_bfloat16* do_s = q_s + NP * PQ;      // NP x PQ
  __nv_bfloat16* k_s = do_s + NP * PQ;      // NS x NP x PK
  __nv_bfloat16* v_s = k_s + NS * NP * PK;  // NS x NP x PK
  float* ids_s = reinterpret_cast<float*>(v_s + NS * NP * PK);  // NS x BN
  float* range_s = ids_s + NS * BN;         // the rows' ids [2]
  int* meta = reinterpret_cast<int*>(range_s + 4);  // NS x {kt, class, end}
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + 4 * NS);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int n_qt = (s_q + BM - 1) / BM;
  const int row0 = (n_qt - 1 - blockIdx.y) * BM;
  const int h = blockIdx.x % hq, b = blockIdx.x / hq;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const float* segb = SEG ? seg + (long long)b * s_k : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  if constexpr (SEG)
    if (threadIdx.x < 32) seg_range<BM>(range_s, segb, row0, s_q);
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: warp 8 loads Q and dO, then classifies and streams the key
    // tiles that the rows need
    regs_dealloc<kHpProducerRegs>();
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * NP * PQ * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load(q_s + p * PQ, &maps.q, qbar, 64 * p, row0, h, b);
        tma_load(do_s + p * PQ, &maps.dout, qbar, 64 * p, row0, h, b);
      }
    }
    int stage = 0;
    unsigned phase = 0;
    stream_key_tiles<BM, BN, NP, NS, SEG>(maps, k_s, v_s, ids_s, meta, full,
                                          empty, segb, range_s, row0, hk, b,
                                          s_q, s_k, causal, stage, phase);
  } else {
    regs_alloc<kHpConsumerRegs>();
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
    const int rg = BM == 128 ? wg : 0;        // the group's 64 rows
    const int pz0 = BM == 128 ? 0 : NPB * wg; // its first output panel
    const int wrow = row0 + 64 * rg + 16 * warp;   // the warp's first q row
    const float scale2 = sm_scale * kLog2e;
    const float neg2 = kNegInf * kLog2e;
    // rows g, g + 8: ids, lse in base 2 and delta; rows past s_q read 0
    // (their q and dO rows are zeros, so their ds is 0) and are not written
    float rid[2] = {0.f, 0.f}, lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      const long long at = ((long long)b * hq + h) * s_q + row;
      lse2[r] = row < s_q ? lse[at] * kLog2e : 0.f;
      dlt[r] = row < s_q ? delta[at] : 0.f;
      if constexpr (SEG) rid[r] = segb[min(row, s_k - 1)];
    }
    float acc[NPB][8][4];
#pragma unroll
    for (int p = 0; p < NPB; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
    // the pending tile: its ds as hi + lo (zero while none is) and its K
    // panels (the Q tile while none is: any finite tile of that shape)
    unsigned dh[BN / 16][4], dl[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dh[kk][i] = 0u;
        dl[kk][i] = 0u;
      }
    const __nv_bfloat16* qw = q_s + 64 * 64 * rg;   // the group's rows
    const __nv_bfloat16* dow = do_s + 64 * 64 * rg;
    const __nv_bfloat16* kp = q_s;
    int kpanel = PQ;                          // elements between its panels
    int pend = -1;                            // its stage (-1: none)
    auto issue_dq = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NPB; ++p) {
          const uint64_t db =
              desc_mn(kp + min(pz0 + p, NP - 1) * kpanel, kk);
          wgmma_rs(acc[p], dh[kk], db);
          wgmma_rs(acc[p], dl[kk], db);
        }
    };
    mbar_wait(qbar, 0);

    int stage = 0;
    unsigned phase = 0;
    for (;;) {
      mbar_wait(&full[stage], phase);
      const int* mt = meta + 4 * stage;
      if (mt[2]) break;
      const int kcol0 = mt[0] * BN;
      const bool masked = mt[1] == kTileMasked;
      const __nv_bfloat16* ks = k_s + stage * NP * PK;
      const __nv_bfloat16* vs = v_s + stage * NP * PK;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      fence_acc(s);
      fence_acc(dp);
#pragma unroll
      for (int p = 0; p < NPB; ++p) fence_acc(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(s, desc_k(qw + (kk / 4) * PQ, kk % 4),
                 desc_k(ks + (kk / 4) * PK, kk % 4), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(dp, desc_k(dow + (kk / 4) * PQ, kk % 4),
                 desc_k(vs + (kk / 4) * PK, kk % 4), kk > 0);
      wgmma_commit();
      issue_dq();                             // the pending tile's ds K
      wgmma_commit();
      // the tile's keep bits (DROP), one a score, drawn while S, dP and the
      // pending ds K run: a keep word depends only on the score's
      // coordinates, so the Philox rounds need nothing that is in flight
      unsigned kb = 0;
      if constexpr (DROP) {
        kb = keep_bits_rows<BN / 16>(dr, (unsigned)(kcol0 / 16) * 4u + t,
                                     wrow + g, (unsigned)(b * hq + h));
        fence_reg(kb);
      }
      wgmma_wait<1>();                        // S and dP have landed
      fence_acc(s);
      fence_acc(dp);

      // p = exp(s - lse): a masked tile's scores are masked per score
      // (NEG_INF exactly, -inf past the keys), a full tile's take the scale
      // in the exponent's FFMA; then ds = p (dP - delta), which the
      // epilogue scales by sm_scale, with DROP of the dropped dP (element e
      // of n-tile j is keep bit 4 j + e)
      if (masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 kid = make_float2(0.f, 0.f);
          if constexpr (SEG)
            kid = *reinterpret_cast<const float2*>(ids_s + stage * BN + 8 * j +
                                                   2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kcol0 + 8 * j + 2 * t + (e & 1);
            const int row = wrow + g + 8 * (e >> 1);
            float x = s[j][e] * scale2;
            if (col >= s_k) x = __int_as_float(0xff800000);
            else if (causal && row + offset < col) x = neg2;
            else if (SEG && rid[e >> 1] != ((e & 1) ? kid.y : kid.x))
              x = neg2;
            s[j][e] = fast_exp2(x - lse2[e >> 1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = fast_exp2(fmaf(s[j][e], scale2, -lse2[e >> 1]));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dpk =
              DROP ? kept(dr, kb, 4 * j + e, dp[j][e]) : dp[j][e];
          dp[j][e] = s[j][e] * (dpk - dlt[e >> 1]);
        }
      wgmma_wait<0>();                        // the pending ds K is done
#pragma unroll
      for (int p = 0; p < NPB; ++p) fence_acc(acc[p]);
      fence_frag(dh);
      fence_frag(dl);
      __syncwarp();
      if (pend >= 0 && lane == 0) mbar_arrive(&empty[pend]);
      // ds (hi + lo) is the A operand of this tile's ds K as it lies
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        split_pair(dp[2 * kk][0], dp[2 * kk][1], dh[kk][0], dl[kk][0]);
        split_pair(dp[2 * kk][2], dp[2 * kk][3], dh[kk][1], dl[kk][1]);
        split_pair(dp[2 * kk + 1][0], dp[2 * kk + 1][1], dh[kk][2],
                   dl[kk][2]);
        split_pair(dp[2 * kk + 1][2], dp[2 * kk + 1][3], dh[kk][3],
                   dl[kk][3]);
      }
      pend = stage;
      kp = ks;
      kpanel = PK;
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int p = 0; p < NPB; ++p) fence_acc(acc[p]);
    wgmma_fence();
    issue_dq();                               // the last tile's ds K
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NPB; ++p) fence_acc(acc[p]);
    fence_frag(dh);
    fence_frag(dl);

    // epilogue: dQ sm_scale, rounded once to bf16, over the group's panels
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      if (row >= s_q) continue;
      __nv_bfloat16* dqr = dq + dqv.at(b, row, h);
#pragma unroll
      for (int p = 0; p < NPB; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * (pz0 + p) + 8 * j + 2 * t;
          if (pz0 + p >= NP || col >= d) continue;
          *reinterpret_cast<unsigned*>(dqr + col) =
              pack_bf16(acc[p][j][2 * r] * sm_scale,
                        acc[p][j][2 * r + 1] * sm_scale);
        }
    }
  }
}


// ---------------------------------------------------------------------------
// host side
struct Geometry {
  int batch, hq, hkv, s_q, s_k, causal, d;
  float sm_scale;
};

inline View view_at(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <int W>
constexpr int fwd_smem() {
  constexpr int TR = f32_rows<W>();
  return (3 * TR * (W + 1) + TR * (TR + 1) + 3 * TR) * 4;
}
template <int W>
constexpr int dkv_smem() {
  constexpr int TR = f32_rows<W>();
  return (4 * TR * (W + 1) + 2 * TR * (TR + 1) + 2 * TR) * 4;
}
template <int W>
constexpr int dq_smem() {
  constexpr int TR = f32_rows<W>();
  return (4 * TR * (W + 1) + TR * (TR + 1) + 2 * TR) * 4;
}

template <int W>
constexpr int dkv_bq() { return W <= 64 ? FA_DKV_BQ64 : 32; }
template <int W>
constexpr int dkv_mma_smem() {
  return (2 * 16 * FA_DKV_WARPS + FA_STAGES * 2 * dkv_bq<W>()) *
             tile_ld<W>() * 2 +
         FA_STAGES * 2 * dkv_bq<W>() * 4;
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// dK / dV without segments keeps mma.sync at W 160 (FA_DKV_MMA_SYNC_W):
// above two 64-column panels the wgmma body splits the output panels
// between two blocks that each recompute S^T and dP^T, and at W 160 it
// repeats a panel, which left it slower than mma.sync at the UNet's level
// 2 ([8, 256, 8, 160]); at W 192 and 256 it was the faster one at that
// sequence.  Its dropout branch likewise (the wgmma body's two blocks
// each draw every keep word): 15% slower at W 160, faster at W 192 and 256
// (chip_smoke.py phase 5e, WIDE_VARIANTS, which build this at each width
// and at 0, none, and time them at rate 0 and 0.1; PERF.md §6 has the
// times).
#ifndef FA_DKV_MMA_SYNC_W
#define FA_DKV_MMA_SYNC_W 160
#endif
constexpr bool kMmaSyncDkvWidth(int w) { return w == FA_DKV_MMA_SYNC_W; }

// the SMs of the current device (the persistent forward's grid), read once
// per device
inline int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = cached[dev & 63].load(std::memory_order_relaxed);
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess)
    cached[dev & 63].store(n, std::memory_order_relaxed);
  return n;
}

// The forward's designs (HpFwd), numbered by two bits: 1 = 128 keys a tile
// (else 64), 2 = a persistent grid (else a block per q tile).  The segment
// branch takes design 0 at every launch; a launch without segments takes
// the one that fwd_design picks from its shape.
constexpr int kFwdKeys128 = 1, kFwdPersistent = 2, kFwdDesigns = 4;
constexpr int fwd_keys(int ds) { return ds & kFwdKeys128 ? 128 : 64; }
constexpr bool fwd_persistent(int ds) { return (ds & kFwdPersistent) != 0; }
// whether design ds can run at width W: a ring of two stages at least (a
// consumer holds two), and 128-key tiles only up to one 64-column panel,
// where a consumer's 64 scores, 32 of O and 32 of packed P fit its
// registers beside the pending tile's
template <int W, int DS>
constexpr bool fwd_fits() {
  return (fwd_keys(DS) == 64 || W <= 64) &&
         HpFwd<W, fwd_keys(DS), fwd_persistent(DS)>::NS >= 2;
}
// -1: fwd_design picks; a design's number: every launch without segments
// takes it where it fits (a build for timing the designs against each
// other; the port loads the default)
#ifndef FA_FWD_HP_DESIGN
#define FA_FWD_HP_DESIGN -1
#endif
// the persistent design at width W: 128-key tiles where they fit
template <int W>
constexpr int kFwdPersistentAt =
    fwd_fits<W, kFwdPersistent | kFwdKeys128>() ? kFwdPersistent | kFwdKeys128
                                                : kFwdPersistent;
// the designs that fwd_design may pick at width W, and so are compiled
template <int W, int DS>
constexpr bool fwd_built() {
  if (DS == 0) return true;
  if (FA_FWD_HP_DESIGN >= 0) return DS == FA_FWD_HP_DESIGN && fwd_fits<W, DS>();
  return DS == kFwdPersistentAt<W> && fwd_fits<W, DS>();
}
template <int W, int... DS>
bool fwd_built_at(int ds, std::integer_sequence<int, DS...>) {
  return ((ds == DS && fwd_built<W, DS>()) || ...);
}
// The design of a forward launch at width W without segments: the
// persistent grid (128-key tiles up to W 64) where the launch has more q
// tiles than the card has SMs and its ring fits (not at W 256, where two
// Q buffers leave room for one stage), else a block per q tile.
template <int W>
int fwd_design(const Geometry& g, bool seg) {
  constexpr auto all = std::make_integer_sequence<int, kFwdDesigns>{};
  if (seg) return 0;
  if (FA_FWD_HP_DESIGN >= 0 && fwd_built_at<W>(FA_FWD_HP_DESIGN, all))
    return FA_FWD_HP_DESIGN;
  const long long tiles = (long long)g.batch * g.hq * ((g.s_q + 127) / 128);
  return fwd_built<W, kFwdPersistentAt<W>>() && tiles > sm_count()
             ? kFwdPersistentAt<W>
             : 0;
}

// The launches that take the wgmma bodies, per row: every bf16 forward and
// dQ launch; every bf16 dK / dV launch but, without segments, the widths
// of kMmaSyncDkvWidth.  The other bf16 launches take mma.sync.
template <typename T>
constexpr bool kWgmmaFwd = kTensorCores<T>;
template <typename T, int W, bool SEG>
constexpr bool kWgmmaDkv = kTensorCores<T> && (SEG || !kMmaSyncDkvWidth(W));

// one instantiation of the bodies: element type, width, PART and the flags
template <typename T, int W, bool PART, bool SEG, bool DROP>
struct Variant {};

template <int W, int BN, bool PERSIST, bool SEG, bool DROP>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                      float* lse, const long long* st, const Geometry& g,
                      const Dropout& dr, const float* seg,
                      cudaStream_t stream) {
  using F = HpFwd<W, BN, PERSIST>;
  HpMaps maps{};
  cudaError_t err =
      tile_map(&maps.q, q, st, g.batch, g.s_q, g.hq, g.d, F::BM);
  if (err == cudaSuccess)
    err = tile_map(&maps.k, k, st + 3, g.batch, g.s_k, g.hkv, g.d, BN);
  if (err == cudaSuccess)
    err = tile_map(&maps.v, v, st + 6, g.batch, g.s_k, g.hkv, g.d, BN);
  if (err != cudaSuccess) return err;
  const auto kernel = fa_fwd_wgmma_kernel<W, BN, PERSIST, SEG, DROP>;
  static std::atomic<unsigned long long> done{0};
  err = allow_smem(done, kernel, F::SMEM);
  if (err != cudaSuccess) return err;
  const int n_tiles = g.batch * g.hq * ((g.s_q + F::BM - 1) / F::BM);
  const int sms = PERSIST ? sm_count() : 0;
  const int grid = PERSIST && sms < n_tiles ? sms : n_tiles;
  if (grid <= 0) return cudaErrorInvalidValue;
  kernel<<<grid, kHpThreads, F::SMEM, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), lse, view_at(st, 3), g.hq, g.hkv,
      g.s_q, g.s_k, g.causal, g.sm_scale, dr, seg, g.d, n_tiles);
  return cudaGetLastError();
}

template <int W, bool SEG, bool DROP>
cudaError_t bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv,
                          const long long* st, const Geometry& g,
                          const Dropout& dr, const float* seg,
                          cudaStream_t stream) {
  constexpr int keys = 128, BQ = hp_dkv_bq<W>();
  HpMaps maps{};
  cudaError_t err = tile_map(&maps.q, q, st, g.batch, g.s_q, g.hq, g.d, BQ);
  if (err == cudaSuccess)
    err = tile_map(&maps.k, k, st + 3, g.batch, g.s_k, g.hkv, g.d, keys);
  if (err == cudaSuccess)
    err = tile_map(&maps.v, v, st + 6, g.batch, g.s_k, g.hkv, g.d, keys);
  if (err == cudaSuccess)
    err = tile_map(&maps.dout, dout, st + 9, g.batch, g.s_q, g.hq, g.d, BQ);
  if (err != cudaSuccess) return err;
  constexpr int smem = hp_dkv_smem<W>();
  const auto kernel = fa_bwd_dkv_wgmma_kernel<W, SEG, DROP>;
  static std::atomic<unsigned long long> done{0};
  err = allow_smem(done, kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.hkv * g.batch, (g.s_k + keys - 1) / keys,
                  hp_dkv_split<W>());
  kernel<<<grid, kHpThreads, smem, stream>>>(
      maps, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), view_at(st, 4), view_at(st, 5), g.hq,
      g.hkv, g.s_q, g.s_k, g.causal, g.sm_scale, dr, seg, g.d);
  return cudaGetLastError();
}

template <int W, bool SEG, bool DROP>
cudaError_t bwd_dq_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, const long long* st,
                         const Geometry& g, const Dropout& dr,
                         const float* seg, cudaStream_t stream) {
  constexpr int rows = hp_dq_rows<W>();
  HpMaps maps{};
  cudaError_t err = tile_map(&maps.q, q, st, g.batch, g.s_q, g.hq, g.d, rows);
  if (err == cudaSuccess)
    err = tile_map(&maps.k, k, st + 3, g.batch, g.s_k, g.hkv, g.d, kKeyTile);
  if (err == cudaSuccess)
    err = tile_map(&maps.v, v, st + 6, g.batch, g.s_k, g.hkv, g.d, kKeyTile);
  if (err == cudaSuccess)
    err = tile_map(&maps.dout, dout, st + 9, g.batch, g.s_q, g.hq, g.d, rows);
  if (err != cudaSuccess) return err;
  constexpr int smem = hp_dq_smem<W>();
  const auto kernel = fa_bwd_dq_wgmma_kernel<W, SEG, DROP>;
  static std::atomic<unsigned long long> done{0};
  err = allow_smem(done, kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.hq * g.batch, (g.s_q + rows - 1) / rows);
  kernel<<<grid, kHpThreads, smem, stream>>>(
      maps, lse, delta, static_cast<__nv_bfloat16*>(dq), view_at(st, 4), g.hq,
      g.hkv, g.s_q, g.s_k, g.causal, g.sm_scale, dr, seg, g.d);
  return cudaGetLastError();
}

// the launch of design DS of the forward, where it is built (the segment
// branch: design 0 alone)
template <int W, bool SEG, bool DROP, int DS>
cudaError_t fwd_design_launch(const void* q, const void* k, const void* v,
                              void* o, float* lse, const long long* st,
                              const Geometry& g, const Dropout& dr,
                              const float* seg, cudaStream_t stream) {
  if constexpr (fwd_built<W, DS>() && (!SEG || DS == 0))
    return fwd_wgmma<W, fwd_keys(DS), fwd_persistent(DS), SEG, DROP>(
        q, k, v, o, lse, st, g, dr, seg, stream);
  else
    return cudaErrorInvalidValue;
}

template <int W, bool SEG, bool DROP, int... DS>
cudaError_t fwd_any_design(int ds, std::integer_sequence<int, DS...>,
                           const void* q, const void* k, const void* v,
                           void* o, float* lse, const long long* st,
                           const Geometry& g, const Dropout& dr,
                           const float* seg, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((ds == DS &&
          ((err = fwd_design_launch<W, SEG, DROP, DS>(q, k, v, o, lse, st, g,
                                                      dr, seg, stream)),
           true)) ||
         ...);
  return err;
}

template <typename T, int W, bool PART, bool SEG, bool DROP>
cudaError_t fwd(Variant<T, W, PART, SEG, DROP>, const void* q, const void* k,
                const void* v, void* o, float* lse, const long long* st,
                const Geometry& g, const Dropout& dr, const float* seg,
                cudaStream_t stream) {
  if constexpr (kWgmmaFwd<T>) {
    return fwd_any_design<W, SEG, DROP>(
        fwd_design<W>(g, SEG), std::make_integer_sequence<int, kFwdDesigns>{},
        q, k, v, o, lse, st, g, dr, seg, stream);
  } else {
    constexpr int TR = f32_rows<W>();
    const dim3 grid((g.s_q + TR - 1) / TR, g.hq, g.batch);
    constexpr int smem = fwd_smem<W>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_fwd_kernel<T, W, SEG, DROP>, smem);
    if (err != cudaSuccess) return err;
    fa_fwd_kernel<T, W, SEG, DROP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), g.hq, g.hkv, g.s_q,
        g.s_k, g.causal, g.sm_scale, dr, seg, g.d);
    return cudaGetLastError();
  }
}

template <typename T, int W, bool PART, bool SEG, bool DROP>
cudaError_t bwd_dkv(Variant<T, W, PART, SEG, DROP>, const void* q,
                    const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv,
                    const long long* st, const Geometry& g, const Dropout& dr,
                    const float* seg, cudaStream_t stream) {
  if constexpr (kWgmmaDkv<T, W, SEG>) {
    return bwd_dkv_wgmma<W, SEG, DROP>(q, k, v, dout, lse, delta, dk, dv, st,
                                       g, dr, seg, stream);
  } else if constexpr (kTensorCores<T>) {
    constexpr int keys = 16 * FA_DKV_WARPS;
    constexpr int smem = dkv_mma_smem<W>();
    const auto kernel = fa_bwd_dkv_mma_kernel<W, PART, FA_DKV_WARPS,
                                              dkv_bq<W>(), FA_STAGES, DROP>;
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(g.hkv * g.batch, (g.s_k + keys - 1) / keys,
                    dkv_split<W>());
    kernel<<<grid, 32 * FA_DKV_WARPS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
        view_at(st, 5), g.hq, g.hkv, g.s_q, g.s_k, g.causal, g.sm_scale, dr,
        g.d);
    return cudaGetLastError();
  } else {
    constexpr int TR = f32_rows<W>();
    const dim3 grid((g.s_k + TR - 1) / TR, g.hkv, g.batch);
    constexpr int smem = dkv_smem<W>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err =
        allow_smem(done, fa_bwd_dkv_kernel<T, W, SEG, DROP>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dkv_kernel<T, W, SEG, DROP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
        view_at(st, 5), g.hq, g.hkv, g.s_q, g.s_k, g.causal, g.sm_scale, dr,
        seg, g.d);
    return cudaGetLastError();
  }
}

template <typename T, int W, bool PART, bool SEG, bool DROP>
cudaError_t bwd_dq(Variant<T, W, PART, SEG, DROP>, const void* q,
                   const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq,
                   const long long* st, const Geometry& g, const Dropout& dr,
                   const float* seg, cudaStream_t stream) {
  if constexpr (kTensorCores<T>) {
    return bwd_dq_wgmma<W, SEG, DROP>(q, k, v, dout, lse, delta, dq, st, g,
                                      dr, seg, stream);
  } else {
    constexpr int TR = f32_rows<W>();
    const dim3 grid((g.s_q + TR - 1) / TR, g.hq, g.batch);
    constexpr int smem = dq_smem<W>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err =
        allow_smem(done, fa_bwd_dq_kernel<T, W, SEG, DROP>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dq_kernel<T, W, SEG, DROP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), view_at(st, 0), view_at(st, 1), view_at(st, 2),
        view_at(st, 3), view_at(st, 4), g.hq, g.hkv, g.s_q, g.s_k, g.causal,
        g.sm_scale, dr, seg, g.d);
    return cudaGetLastError();
  }
}

// segment ids need one sequence length for the q rows and the keys
inline bool valid(const Geometry& g, const void* seg) {
  return g.batch > 0 && g.hkv > 0 && g.hq % g.hkv == 0 && g.s_q > 0 &&
         g.s_k > 0 && (seg == nullptr || g.s_q == g.s_k);
}

// the body that a launch of `which` (0 forward, 1 dK / dV, 2 dQ) takes at
// this instantiation: 0 the f32 CUDA-core body, 1 mma.sync, 2 wgmma
template <typename T, int W, bool PART, bool SEG, bool DROP>
int body_of(int which, Variant<T, W, PART, SEG, DROP>) {
  if constexpr (!kTensorCores<T>) return 0;
  const bool wgmma = which == 0   ? kWgmmaFwd<T>
                     : which == 1 ? kWgmmaDkv<T, W, SEG>
                                  : true;
  return wgmma ? 2 : 1;
}

template <typename T, int W, bool PART, bool SEG, bool DROP>
int fwd_design_of(Variant<T, W, PART, SEG, DROP>, const Geometry& g,
                  bool seg) {
  return fwd_design<W>(g, seg);
}

// f(Variant<...>{}) for the instantiation a launch at width W takes: dtype
// codes 0 = float32 (the f32 bodies, which take d at run time whatever it
// is), 1 = bfloat16 (PART = false only at a tuned width with d = W); a
// dropout threshold of 0 takes the instantiation without the dropout
// branch, and a null segment pointer the one without the segment branch
template <typename T, int W, bool PART, typename F>
cudaError_t with_flags(bool seg, bool drop, F& f) {
  if (seg)
    return drop ? f(Variant<T, W, PART, true, true>{})
                : f(Variant<T, W, PART, true, false>{});
  return drop ? f(Variant<T, W, PART, false, true>{})
              : f(Variant<T, W, PART, false, false>{});
}

template <int W, typename F>
cudaError_t with_variant(int dtype, int d, bool seg, bool drop, F& f) {
  if (dtype == 0) return with_flags<float, W, true>(seg, drop, f);
  if (dtype == 1) {
    if constexpr (kTunedWidth(W))
      if (d == W) return with_flags<__nv_bfloat16, W, false>(seg, drop, f);
    return with_flags<__nv_bfloat16, W, true>(seg, drop, f);
  }
  return cudaErrorInvalidValue;
}

// the launch at whichever of this unit's widths Ws holds d; an error for a
// d that none of them takes
template <int... Ws, typename F>
cudaError_t at_width(int d, int dtype, bool seg, bool drop, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((fa_width(d) == Ws &&
          ((err = with_variant<Ws>(dtype, d, seg, drop, f)), true)) ||
         ...);
  return err;
}

}  // namespace

// strides: q, k, v, o as (batch, seq, head) element strides, 12 values.
// head_dim: a multiple of 8 up to 256 whose width (fa_width) this library
// holds.  Every entry ends with the dropout arguments: the keep threshold
// (uint32(rate * 2^32); 0 = no dropout), 1 / (1 - rate) and the seed's low
// and high words; then the segment ids, f32 [B, S] with S = s_q = s_k, or
// null for none.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int batch, int hq, int hkv, int s_q, int s_k,
    int head_dim, int dtype, int causal, float sm_scale, unsigned thresh,
    float drop_scale, unsigned seed_lo, unsigned seed_hi, const void* seg,
    void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, head_dim, sm_scale};
  if (!valid(g, seg)) return cudaErrorInvalidValue;
  const Dropout dr{thresh, drop_scale, seed_lo, seed_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(seg);
  float* l = static_cast<float*>(lse);
  return at_width<FA_TU_WIDTHS>(
      head_dim, dtype, sg != nullptr, thresh != 0, [&](auto var) {
        return fwd(var, q, k, v, o, l, strides, g, dr, sg, s);
      });
}

// strides: q, k, v, dout, dk, dv, 18 values; lse / delta compact [B*Hq, S_q].
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int batch, int hq, int hkv, int s_q, int s_k,
    int head_dim, int dtype, int causal, float sm_scale, unsigned thresh,
    float drop_scale, unsigned seed_lo, unsigned seed_hi, const void* seg,
    void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, head_dim, sm_scale};
  if (!valid(g, seg)) return cudaErrorInvalidValue;
  const Dropout dr{thresh, drop_scale, seed_lo, seed_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(seg);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return at_width<FA_TU_WIDTHS>(
      head_dim, dtype, sg != nullptr, thresh != 0, [&](auto var) {
        return bwd_dkv(var, q, k, v, dout, l, dl, dk, dv, strides, g, dr, sg,
                       s);
      });
}

// strides: q, k, v, dout, dq, 15 values.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int batch, int hq, int hkv, int s_q, int s_k, int head_dim, int dtype,
    int causal, float sm_scale, unsigned thresh, float drop_scale,
    unsigned seed_lo, unsigned seed_hi, const void* seg, void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, head_dim, sm_scale};
  if (!valid(g, seg)) return cudaErrorInvalidValue;
  const Dropout dr{thresh, drop_scale, seed_lo, seed_hi};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sg = static_cast<const float*>(seg);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return at_width<FA_TU_WIDTHS>(
      head_dim, dtype, sg != nullptr, thresh != 0, [&](auto var) {
        return bwd_dq(var, q, k, v, dout, l, dl, dq, strides, g, dr, sg, s);
      });
}

// the design (kFwdKeys128 | kFwdPersistent bits) that a bf16 forward
// launch of this geometry takes, -1 for a head dim this library does not
// hold
extern "C" int flash_attention_fwd_design(int batch, int hq, int s_q,
                                          int s_k, int head_dim, int causal,
                                          int seg) {
  const Geometry g{batch, hq, hq, s_q, s_k, causal, head_dim, 1.f};
  int design = -1;
  at_width<FA_TU_WIDTHS>(head_dim, 1, seg != 0, false, [&](auto var) {
    design = fwd_design_of(var, g, seg != 0);
    return cudaSuccess;
  });
  return design;
}

// which body a launch of `which` (0 forward, 1 dK / dV, 2 dQ) takes
// (body_of's codes), -1 for a `which`, head dim or dtype this library does
// not hold
extern "C" int flash_attention_body(int which, int head_dim, int dtype,
                                    int seg, int drop) {
  int body = -1;
  if (which < 0 || which > 2) return body;
  at_width<FA_TU_WIDTHS>(head_dim, dtype, seg != 0, drop != 0,
                         [&](auto var) {
                           body = body_of(which, var);
                           return cudaSuccess;
                         });
  return body;
}
