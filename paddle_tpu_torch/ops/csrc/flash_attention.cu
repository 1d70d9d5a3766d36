// FlashAttention-2 forward and backward for NVIDIA Hopper (sm_90a), plus the
// lse repack.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_attention_fwd_kernel_call -> _fwd_kernel      (fa_fwd_kernel)
//   _pack_lse                                            (the forward's lse
//        epilogue, and pack_lse_kernel for 3-D [BH, S, 1] stats)
//   _bwd_call -> _bwd_dkv_kernel                         (fa_bwd_dkv_kernel)
//   _bwd_call -> _bwd_dq_kernel                          (fa_bwd_dq_kernel)
//
// Layout: q, o, dq are [B, S_q, Hq, D]; k, v, dk, dv are [B, S_k, Hkv, D];
// each is read or written through its (batch, seq, head) strides with unit
// stride along D, so the [B, S, H, D] tensors of the model are used as they
// are (the TPU wrapper transposed them to [B*H, S, D] first).  lse and
// delta are compact [B*Hq, S_q] f32 rows: on Hopper device memory has no
// 128-lane tile padding, so this is byte for byte the TPU's packed
// [B*Hq, S_q/128, 128] layout, and the forward writes it directly.
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
// S_q and S_k need not be multiples of the 64-row tile: a partial tile's
// missing rows load as zeros, are never written, and its missing key
// columns score -inf, so they add nothing.
//
// What bounds it on this card: at the train shape (S = 2048, D = 64) each
// (q tile, k tile) pair does 2-4 products (4-6 in the bf16 backward, see
// below) of 64 x 64 x D multiply-adds for
// 2 x 64 x D elements loaded, so the kernels are bound by operations, not
// by bytes.  The TPU's 512 x 1024 blocks do not fit Hopper's 227 KB of
// shared memory; 64 x 64 tiles keep every kernel under 170 KB at D = 128
// and give 4,096 forward blocks at the train shape.  Two bodies share the
// tiling, the masking and the softmax code:
//   * bf16 inputs (the train step) run their products on the tensor cores
//     (WMMA 16 x 16 x 16, f32 accumulators; see the *_tc kernels below);
//   * f32 inputs run them on the CUDA cores in f32, which keeps f32 inputs
//     exact to f32 rounding (a TF32 tensor-core product would not): tiles
//     staged in shared memory as f32 (rows padded to D + 1 floats so that
//     the threads of a warp hit distinct banks), each of the 256 threads
//     owning a 4 x 4 micro-tile of a 64 x 64 score block and a 4 x D/16
//     slice of a 64 x D accumulator kept in registers.
// Keeping scores and the softmax in registers (mma.sync fragments or
// wgmma), TMA staging and warp specialisation are left for later work.
//
// The C entries allocate nothing, launch on the caller's stream and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // rows of a q tile and of a k tile
constexpr int kLDS = kTile + 1;        // padded row of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;      // the Pallas kernels' NEG_INF
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

// rows [row0, row0 + 64) of one (batch, head) -> dst [64][D + 1] f32; rows
// past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int row0, int rows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * LD + d] = row < rows ? to_f32(src[(long long)row * ss + d]) : 0.f;
  }
}

// c[i][j] = sum_d A[r][d] * B[c][d],  r = ty + 16 i,  c = tx + 16 j
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float c[4][4]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// acc[i][j] += sum_k P[r][k] * B[k][e],  r = ty + 16 i,  e = tx + 16 j;
// P is a [64][65] score tile, B a [64][D + 1] row tile
template <int D>
__device__ __forceinline__ void mm_ab(const float* P, const float* B,
                                      float acc[4][D / 16]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * kLDS + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[r][c] * B[r][e],  c = ty + 16 i,  e = tx + 16 j
template <int D>
__device__ __forceinline__ void mm_atb(const float* P, const float* B,
                                       float acc[4][D / 16]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[r * kLDS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// number of k tiles a q tile starting at row0 visits: all of them, or up to
// its causal frontier (the TPU kernel's `run` condition per tile)
__device__ __forceinline__ int k_tiles_for(int row0, int s_q, int s_k,
                                           int causal) {
  const int n = (s_k + kTile - 1) / kTile;
  if (!causal) return n;
  const int last = row0 + kTile - 1 + (s_k - s_q);
  return last < 0 ? 0 : min(n, last / kTile + 1);
}

// one score of a (q tile, k tile) pair, scaled and causally masked.  Key
// columns at or past s_k (the zero rows of a partial last k tile) score
// -inf, so that they add exactly nothing to a row's sum and to the
// backward's p and ds; the causal mask keeps the TPU kernel's NEG_INF.
__device__ __forceinline__ float masked_score(float s, float sm_scale,
                                              int qrow, int kcol, int offset,
                                              int causal, int s_k) {
  if (kcol >= s_k) return __int_as_float(0xff800000);   // -inf
  s *= sm_scale;
  return causal && qrow + offset < kcol ? kNegInf : s;
}

// One online-softmax step over a 64 x 64 score tile (raw q . k products in
// s, row stride LDS): scale and mask, update each row's running max m and
// denominator l (warp w owns rows 8w .. 8w + 7, lanes own columns lane and
// lane + 32), write p = exp(s - m_new) to p (row stride LDP; may alias s)
// and the row's rescale factor exp(m_old - m_new) to alpha_s.
template <int LDS, int LDP, typename P>
__device__ __forceinline__ void softmax_step(const float* s, P* p,
                                             float* alpha_s, float m[8],
                                             float l[8], int row0, int col0,
                                             int offset, int causal, int s_k,
                                             float sm_scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int r = warp * 8 + rr;
    const float s0 = masked_score(s[r * LDS + lane], sm_scale, row0 + r,
                                  col0 + lane, offset, causal, s_k);
    const float s1 = masked_score(s[r * LDS + lane + 32], sm_scale, row0 + r,
                                  col0 + lane + 32, offset, causal, s_k);
    const float m_new = fmaxf(m[rr], warp_max(fmaxf(s0, s1)));
    const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
    const float alpha = expf(m[rr] - m_new);
    l[rr] = alpha * l[rr] + warp_sum(p0 + p1);
    m[rr] = m_new;
    store(p + r * LDP + lane, p0);
    store(p + r * LDP + lane + 32, p1);
    if (lane == 0) alpha_s[r] = alpha;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, View qv, View kv, View vv, View ov,
              int hq, int hkv, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [64][D + 1]
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;            // [64][65] scores, then p
  float* alpha_s = p_s + kTile * kLDS;      // [64] per-row rescale
  float* m_s = alpha_s + kTile;
  float* l_s = m_s + kTile;

  const int row0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kb = k + kv.at(b, 0, hk);
  const T* vb = v + vv.at(b, 0, hk);

  load_tile<T, D>(q_s, q + qv.at(b, 0, h), qv.ss, row0, s_q);

  float acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  float m[8], l[8];                         // rows warp * 8 + rr, warp-uniform
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) { m[rr] = kNegInf; l[rr] = 0.f; }

  const int n_kt = k_tiles_for(row0, s_q, s_k, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();                        // last tile's readers are done
    load_tile<T, D>(k_s, kb, kv.ss, kt * kTile, s_k);
    load_tile<T, D>(v_s, vb, vv.ss, kt * kTile, s_k);
    __syncthreads();
    float sc[4][4];
    mm_abt<D>(q_s, k_s, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        p_s[r * kLDS + c] = sc[i][j];
      }
    __syncthreads();
    softmax_step<kLDS, kLDS>(p_s, p_s, alpha_s, m, l, row0, kt * kTile,
                             offset, causal, s_k, sm_scale);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= a;
    }
    mm_ab<D>(p_s, v_s, acc);
  }

  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      m_s[warp * 8 + rr] = m[rr];
      l_s[warp * 8 + rr] = l[rr];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = row0 + r;
    if (row < s_q) {
      const float lr = l_s[r];
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      T* orow = o + ov.at(b, row, h);
#pragma unroll
      for (int j = 0; j < JD; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    }
  }
  // the lse epilogue writes the compact (= TPU-packed) [B*Hq, S_q] row
  if (threadIdx.x < kTile && row0 + threadIdx.x < s_q) {
    const int r = threadIdx.x;
    lse[((long long)b * hq + h) * s_q + row0 + r] =
        m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

// per-row stats of one (batch, q head) q tile -> shared memory
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta,
                                           long long row_base, int row0,
                                           int s_q) {
  if (threadIdx.x < kTile) {
    const int row = row0 + threadIdx.x;
    lse_s[threadIdx.x] = row < s_q ? lse[row_base + row] : 0.f;
    delta_s[threadIdx.x] = row < s_q ? delta[row_base + row] : 0.f;
  }
}

// p = exp(s - lse) and ds = p * (dp - delta) * sm_scale of a tile pair
// (q rows ty + 16 i, k cols tx + 16 j); writes ds, and p when p_s is set
template <int D>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* delta_s, float* p_s,
                                         float* ds_s, int qrow0, int kcol0,
                                         int offset, int causal, int s_k,
                                         float sm_scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[4][4], dp[4][4];
  mm_abt<D>(q_s, k_s, sc);
  mm_abt<D>(do_s, v_s, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const float s = masked_score(sc[i][j], sm_scale, qrow0 + r, kcol0 + c,
                                   offset, causal, s_k);
      const float p = expf(s - lse_s[r]);
      if (p_s != nullptr) p_s[r * kLDS + c] = p;
      ds_s[r * kLDS + c] = p * (dp[i][j] - delta_s[r]) * sm_scale;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, View qv, View kv, View vv, View dov,
                  View dkv, View dvv, int hq, int hkv, int s_q, int s_k,
                  int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [64][D + 1] each
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;           // [64][65] each
  float* ds_s = p_s + kTile * kLDS;
  float* lse_s = ds_s + kTile * kLDS;       // [64] each
  float* delta_s = lse_s + kTile;

  const int col0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv;
  const int offset = s_k - s_q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(k_s, k + kv.at(b, 0, hk), kv.ss, col0, s_k);
  load_tile<T, D>(v_s, v + vv.at(b, 0, hk), vv.ss, col0, s_k);

  float dk_acc[4][JD], dv_acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) { dk_acc[i][j] = 0.f; dv_acc[i][j] = 0.f; }

  const int n_qt = (s_q + kTile - 1) / kTile;
  for (int rr = 0; rr < rep; ++rr) {        // the q heads of this kv head
    const int h = hk * rep + rr;
    const long long row_base = ((long long)b * hq + h) * s_q;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int row0 = qt * kTile;
      // tiles wholly before the causal frontier add nothing
      if (causal && row0 + kTile - 1 + offset < col0) continue;
      __syncthreads();
      load_tile<T, D>(q_s, q + qv.at(b, 0, h), qv.ss, row0, s_q);
      load_tile<T, D>(do_s, dout + dov.at(b, 0, h), dov.ss, row0, s_q);
      load_stats(lse_s, delta_s, lse, delta, row_base, row0, s_q);
      __syncthreads();
      p_and_ds<D>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, row0, col0,
                  offset, causal, s_k, sm_scale);
      __syncthreads();
      mm_atb<D>(p_s, do_s, dv_acc);         // dv += p^T do
      mm_atb<D>(ds_s, q_s, dk_acc);         // dk += ds^T q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = col0 + ty + 16 * i;
    if (row < s_k) {
      T* dkr = dk + dkv.at(b, row, hk);
      T* dvr = dv + dvv.at(b, row, hk);
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        store(dkr + tx + 16 * j, dk_acc[i][j]);
        store(dvr + tx + 16 * j, dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 View qv, View kv, View vv, View dov, View dqv, int hq,
                 int hkv, int s_q, int s_k, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                        // [64][D + 1] each
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;           // [64][65]
  float* lse_s = ds_s + kTile * kLDS;
  float* delta_s = lse_s + kTile;

  const int row0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + kv.at(b, 0, hk);
  const T* vb = v + vv.at(b, 0, hk);

  load_tile<T, D>(q_s, q + qv.at(b, 0, h), qv.ss, row0, s_q);
  load_tile<T, D>(do_s, dout + dov.at(b, 0, h), dov.ss, row0, s_q);
  load_stats(lse_s, delta_s, lse, delta, ((long long)b * hq + h) * s_q, row0,
             s_q);

  float acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;

  const int n_kt = k_tiles_for(row0, s_q, s_k, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(k_s, kb, kv.ss, kt * kTile, s_k);
    load_tile<T, D>(v_s, vb, vv.ss, kt * kTile, s_k);
    __syncthreads();
    p_and_ds<D>(q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, row0,
                kt * kTile, offset, causal, s_k, sm_scale);
    __syncthreads();
    mm_ab<D>(ds_s, k_s, acc);               // dq += ds k
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < s_q) {
      T* dqr = dq + dqv.at(b, row, h);
#pragma unroll
      for (int j = 0; j < JD; ++j) store(dqr + tx + 16 * j, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the same three kernels with their products on the tensor
// cores (WMMA 16 x 16 x 16, bf16 operands, f32 accumulators).  Tiles stay
// bf16 in shared memory; every 64 x 64 score block lands in shared memory
// as f32, where the softmax and the elementwise backward terms run as in
// the f32 kernels above.  The forward rounds p to bf16 for the P V product,
// as the TPU kernel does (`pd.astype(v.dtype)`).  The TPU backward keeps p
// and ds in f32 for its products; here each enters as two bf16 tiles,
// hi = bf16(x) and lo = bf16(x - hi), which carry x to 2^-16 relative, and
// every product with p or ds runs twice (hi, then lo, into the same f32
// accumulator): dK / dV do 6 tile products per tile pair instead of 4, dQ
// 4 instead of 3.  q, k, v and dO are bf16 values already, so the products
// are then f32-accurate up to that 2^-16.  Each warp owns fixed 16 x 16
// tiles of the 64 x D outputs: dK, dV and dQ stay in accumulator registers
// across the whole loop; the forward's O, which the online softmax rescales
// per row, lives in shared memory as f32.
// ---------------------------------------------------------------------------
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kWarps = kThreads / 32;
constexpr int kLDF = kTile + 4;        // f32 score tile row (16-byte multiple)
constexpr int kLDP = kTile + 8;        // bf16 probability tile row

template <int D> __host__ __device__ constexpr int ldb() { return D + 8; }  // bf16 row
template <int D> __host__ __device__ constexpr int ldo() { return D + 4; }  // f32 64 x D

// rows [row0, row0 + 64) of one (batch, head) -> dst [64][D + 8] bf16 in
// 16-byte vectors; rows past `rows` are zero.  The wrapper guarantees
// 16-byte aligned rows (base and strides).
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long ss, int row0,
                                               int rows) {
  constexpr int V = D / 8;                  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kTile * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (long long)row * ss + c));
    *reinterpret_cast<uint4*>(dst + r * ldb<D>() + c) = val;
  }
}

// out [64][kLDF] f32 = A [64][D] . B [64][D]^T, both bf16 row tiles; the
// 16 output tiles are split over the 8 warps
template <int D>
__device__ __forceinline__ void scores_tc(const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, float* out) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int u = 0; u < 16 / kWarps; ++u) {
    const int t = warp + kWarps * u, ti = t / 4, tj = t % 4;
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBT b;
      wmma::load_matrix_sync(a, A + ti * 16 * ldb<D>() + kk * 16, ldb<D>());
      wmma::load_matrix_sync(b, B + tj * 16 * ldb<D>() + kk * 16, ldb<D>());
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(out + ti * 16 * kLDF + tj * 16, c, kLDF,
                            wmma::mem_row_major);
  }
}

// acc[u] (the warp's 16 x 16 tiles of a 64 x D output) += (P_hi + P_lo) . B,
// with P_hi, P_lo [64][kLDP] bf16 tiles (transposed when TRANS) and B a
// [64][D + 8] row tile
template <int D, bool TRANS>
__device__ __forceinline__ void accumulate_tc(FragC* acc,
                                              const __nv_bfloat16* P_hi,
                                              const __nv_bfloat16* P_lo,
                                              const __nv_bfloat16* B) {
  constexpr int NT = D / 16;
  const int warp = threadIdx.x / 32;
  const __nv_bfloat16* parts[2] = {P_hi, P_lo};
#pragma unroll
  for (int u = 0; u < 4 * NT / kWarps; ++u) {
    const int t = warp + kWarps * u, ti = t / NT, tj = t % NT;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragB b;
      wmma::load_matrix_sync(b, B + kk * 16 * ldb<D>() + tj * 16, ldb<D>());
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (TRANS) {
          FragAT a;                         // A(row, k) = P[k][row]
          wmma::load_matrix_sync(a, parts[h] + kk * 16 * kLDP + ti * 16, kLDP);
          wmma::mma_sync(acc[u], a, b, acc[u]);
        } else {
          FragA a;
          wmma::load_matrix_sync(a, parts[h] + ti * 16 * kLDP + kk * 16, kLDP);
          wmma::mma_sync(acc[u], a, b, acc[u]);
        }
      }
    }
  }
}

// write the warps' accumulator tiles of a 64 x D output, through the f32
// staging tile, to rows [row0, row0 + 64) of one (batch, head)
template <int D>
__device__ __forceinline__ void write_acc_tc(const FragC* acc, float* stage,
                                             __nv_bfloat16* dst, long long ss,
                                             int row0, int rows) {
  constexpr int NT = D / 16;
  const int warp = threadIdx.x / 32;
  __syncthreads();                          // stage is free
#pragma unroll
  for (int u = 0; u < 4 * NT / kWarps; ++u) {
    const int t = warp + kWarps * u, ti = t / NT, tj = t % NT;
    wmma::store_matrix_sync(stage + ti * 16 * ldo<D>() + tj * 16, acc[u],
                            ldo<D>(), wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < rows)
      dst[(long long)(row0 + r) * ss + d] = __float2bfloat16(stage[r * ldo<D>() + d]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 View qv, View kv, View vv, View ov, int hq, int hkv, int s_q,
                 int s_k, int causal, float sm_scale) {
  constexpr int NT = D / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_b = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_b = q_b + kTile * ldb<D>();
  __nv_bfloat16* v_b = k_b + kTile * ldb<D>();
  __nv_bfloat16* p_b = v_b + kTile * ldb<D>();        // [64][kLDP]
  float* s_s = reinterpret_cast<float*>(p_b + kTile * kLDP);  // [64][kLDF]
  float* o_s = s_s + kTile * kLDF;                    // [64][D + 4]
  float* alpha_s = o_s + kTile * ldo<D>();
  float* m_s = alpha_s + kTile;
  float* l_s = m_s + kTile;

  const int row0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* kb = k + kv.at(b, 0, hk);
  const __nv_bfloat16* vb = v + vv.at(b, 0, hk);

  load_tile_bf16<D>(q_b, q + qv.at(b, 0, h), qv.ss, row0, s_q);
  for (int i = threadIdx.x; i < kTile * ldo<D>(); i += kThreads) o_s[i] = 0.f;
  float m[8], l[8];                         // rows warp * 8 + rr
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) { m[rr] = kNegInf; l[rr] = 0.f; }

  const int n_kt = k_tiles_for(row0, s_q, s_k, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();                        // last tile's readers are done
    load_tile_bf16<D>(k_b, kb, kv.ss, kt * kTile, s_k);
    load_tile_bf16<D>(v_b, vb, vv.ss, kt * kTile, s_k);
    __syncthreads();
    scores_tc<D>(q_b, k_b, s_s);
    __syncthreads();
    softmax_step<kLDF, kLDP>(s_s, p_b, alpha_s, m, l, row0, kt * kTile,
                             offset, causal, s_k, sm_scale);
    __syncthreads();
    // the warp rescales the rows of its own O tiles, then adds P V to them
#pragma unroll
    for (int u = 0; u < 4 * NT / kWarps; ++u) {
      const int t = warp + kWarps * u, ti = t / NT, tj = t % NT;
      float* ot = o_s + ti * 16 * ldo<D>() + tj * 16;
      for (int e = lane; e < 256; e += 32)
        ot[(e / 16) * ldo<D>() + e % 16] *= alpha_s[ti * 16 + e / 16];
      __syncwarp();
      FragC c;
      wmma::load_matrix_sync(c, ot, ldo<D>(), wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragA a;
        FragB bv;
        wmma::load_matrix_sync(a, p_b + ti * 16 * kLDP + kk * 16, kLDP);
        wmma::load_matrix_sync(bv, v_b + kk * 16 * ldb<D>() + tj * 16, ldb<D>());
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(ot, c, ldo<D>(), wmma::mem_row_major);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      m_s[warp * 8 + rr] = m[rr];
      l_s[warp * 8 + rr] = l[rr];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < s_q) {
      const float lr = l_s[r];
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      o[ov.at(b, row0 + r, h) + d] = __float2bfloat16(o_s[r * ldo<D>() + d] * inv);
    }
  }
  if (threadIdx.x < kTile && row0 + threadIdx.x < s_q) {
    const int r = threadIdx.x;
    lse[((long long)b * hq + h) * s_q + row0 + r] =
        m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

// x as two bf16 values, hi = bf16(x) and lo = bf16(x - hi): x - hi is
// exact in f32 and at most 2^-8 |x|, so hi + lo is x to 2^-16 relative
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// p and ds of a (q tile, k tile) pair from the f32 scores and dP tiles,
// each split into hi / lo bf16 tiles for the next products (p only when
// p_hi is set; the lo tile of a [64][kLDP] pair follows its hi tile)
__device__ __forceinline__ void p_and_ds_tc(const float* s_s, const float* dp_s,
                                            const float* lse_s,
                                            const float* delta_s,
                                            __nv_bfloat16* p_hi,
                                            __nv_bfloat16* ds_hi, int qrow0,
                                            int kcol0, int offset, int causal,
                                            int s_k, float sm_scale) {
  constexpr int kLo = kTile * kLDP;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile, e = r * kLDP + c;
    const float s = masked_score(s_s[r * kLDF + c], sm_scale, qrow0 + r,
                                 kcol0 + c, offset, causal, s_k);
    const float p = expf(s - lse_s[r]);
    if (p_hi != nullptr) split_bf16(p, p_hi + e, p_hi + kLo + e);
    split_bf16(p * (dp_s[r * kLDF + c] - delta_s[r]) * sm_scale, ds_hi + e,
               ds_hi + kLo + e);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, View qv, View kv,
                     View vv, View dov, View dkv, View dvv, int hq, int hkv,
                     int s_q, int s_k, int causal, float sm_scale) {
  constexpr int NU = 4 * (D / 16) / kWarps;   // output tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_b = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_b = k_b + kTile * ldb<D>();
  __nv_bfloat16* q_b = v_b + kTile * ldb<D>();
  __nv_bfloat16* do_b = q_b + kTile * ldb<D>();
  __nv_bfloat16* p_b = do_b + kTile * ldb<D>();       // hi, lo [64][kLDP]
  __nv_bfloat16* ds_b = p_b + 2 * kTile * kLDP;       // hi, lo [64][kLDP]
  float* s_s = reinterpret_cast<float*>(ds_b + 2 * kTile * kLDP);  // [64][kLDF]
  float* dp_s = s_s + kTile * kLDF;
  float* stage = s_s;                       // [64][D + 4], after the loop
  float* lse_s = dp_s + kTile * kLDF;
  float* delta_s = lse_s + kTile;

  const int col0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv;
  const int offset = s_k - s_q;

  load_tile_bf16<D>(k_b, k + kv.at(b, 0, hk), kv.ss, col0, s_k);
  load_tile_bf16<D>(v_b, v + vv.at(b, 0, hk), vv.ss, col0, s_k);
  FragC dk_acc[NU], dv_acc[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    wmma::fill_fragment(dk_acc[u], 0.f);
    wmma::fill_fragment(dv_acc[u], 0.f);
  }

  const int n_qt = (s_q + kTile - 1) / kTile;
  for (int rr = 0; rr < rep; ++rr) {
    const int h = hk * rep + rr;
    const long long row_base = ((long long)b * hq + h) * s_q;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int row0 = qt * kTile;
      if (causal && row0 + kTile - 1 + offset < col0) continue;
      __syncthreads();
      load_tile_bf16<D>(q_b, q + qv.at(b, 0, h), qv.ss, row0, s_q);
      load_tile_bf16<D>(do_b, dout + dov.at(b, 0, h), dov.ss, row0, s_q);
      load_stats(lse_s, delta_s, lse, delta, row_base, row0, s_q);
      __syncthreads();
      scores_tc<D>(q_b, k_b, s_s);
      scores_tc<D>(do_b, v_b, dp_s);
      __syncthreads();
      p_and_ds_tc(s_s, dp_s, lse_s, delta_s, p_b, ds_b, row0, col0, offset,
                  causal, s_k, sm_scale);
      __syncthreads();
      // dv += p^T do, dk += ds^T q
      accumulate_tc<D, true>(dv_acc, p_b, p_b + kTile * kLDP, do_b);
      accumulate_tc<D, true>(dk_acc, ds_b, ds_b + kTile * kLDP, q_b);
    }
  }
  write_acc_tc<D>(dk_acc, stage, dk + dkv.at(b, 0, hk), dkv.ss, col0, s_k);
  write_acc_tc<D>(dv_acc, stage, dv + dvv.at(b, 0, hk), dvv.ss, col0, s_k);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, View qv, View kv, View vv,
                    View dov, View dqv, int hq, int hkv, int s_q, int s_k,
                    int causal, float sm_scale) {
  constexpr int NU = 4 * (D / 16) / kWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_b = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_b = q_b + kTile * ldb<D>();
  __nv_bfloat16* k_b = do_b + kTile * ldb<D>();
  __nv_bfloat16* v_b = k_b + kTile * ldb<D>();
  __nv_bfloat16* ds_b = v_b + kTile * ldb<D>();       // hi, lo [64][kLDP]
  float* s_s = reinterpret_cast<float*>(ds_b + 2 * kTile * kLDP);
  float* dp_s = s_s + kTile * kLDF;
  float* stage = s_s;                       // [64][D + 4], after the loop
  float* lse_s = dp_s + kTile * kLDF;
  float* delta_s = lse_s + kTile;

  const int row0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = s_k - s_q;
  const __nv_bfloat16* kb = k + kv.at(b, 0, hk);
  const __nv_bfloat16* vb = v + vv.at(b, 0, hk);

  load_tile_bf16<D>(q_b, q + qv.at(b, 0, h), qv.ss, row0, s_q);
  load_tile_bf16<D>(do_b, dout + dov.at(b, 0, h), dov.ss, row0, s_q);
  load_stats(lse_s, delta_s, lse, delta, ((long long)b * hq + h) * s_q, row0,
             s_q);
  FragC acc[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) wmma::fill_fragment(acc[u], 0.f);

  const int n_kt = k_tiles_for(row0, s_q, s_k, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile_bf16<D>(k_b, kb, kv.ss, kt * kTile, s_k);
    load_tile_bf16<D>(v_b, vb, vv.ss, kt * kTile, s_k);
    __syncthreads();
    scores_tc<D>(q_b, k_b, s_s);
    scores_tc<D>(do_b, v_b, dp_s);
    __syncthreads();
    p_and_ds_tc(s_s, dp_s, lse_s, delta_s, nullptr, ds_b, row0, kt * kTile,
                offset, causal, s_k, sm_scale);
    __syncthreads();
    accumulate_tc<D, false>(acc, ds_b, ds_b + kTile * kLDP, k_b);  // dq += ds k
  }
  write_acc_tc<D>(acc, stage, dq + dqv.at(b, 0, h), dqv.ss, row0, s_q);
}

// [BH, S, 1] stats with (row, seq) strides -> compact [BH, S] f32; one
// block row per stats row, one thread per element
__global__ void pack_lse_kernel(const float* __restrict__ src,
                                float* __restrict__ dst, int s,
                                long long s_row, long long s_seq) {
  const long long r = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c < s) dst[r * s + c] = src[r * s_row + c * s_seq];
}

struct Geometry {
  int batch, hq, hkv, s_q, s_k, causal;
  float sm_scale;
};

inline View view_at(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <int D>
constexpr int fwd_smem() { return (3 * kTile * (D + 1) + kTile * kLDS + 3 * kTile) * 4; }
template <int D>
constexpr int dkv_smem() { return (4 * kTile * (D + 1) + 2 * kTile * kLDS + 2 * kTile) * 4; }
template <int D>
constexpr int dq_smem() { return (4 * kTile * (D + 1) + kTile * kLDS + 2 * kTile) * 4; }

template <int D>
constexpr int fwd_tc_smem() {
  return 3 * kTile * ldb<D>() * 2 + kTile * kLDP * 2 + kTile * kLDF * 4 +
         kTile * ldo<D>() * 4 + 3 * kTile * 4;
}
// the backward kernels' output staging tile reuses the two f32 score tiles
static_assert(kTile * ldo<128>() <= 2 * kTile * kLDF, "staging tile too big");
template <int D>
constexpr int dkv_tc_smem() {
  return 4 * kTile * ldb<D>() * 2 + 4 * kTile * kLDP * 2 +
         2 * kTile * kLDF * 4 + 2 * kTile * 4;
}
template <int D>
constexpr int dq_tc_smem() {
  return 4 * kTile * ldb<D>() * 2 + 2 * kTile * kLDP * 2 +
         2 * kTile * kLDF * 4 + 2 * kTile * 4;
}

template <typename T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

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
  return err;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const long long* st, const Geometry& g,
                cudaStream_t stream) {
  const dim3 grid((g.s_q + kTile - 1) / kTile, g.hq, g.batch);
  if constexpr (kTensorCores<T>) {
    constexpr int smem = fwd_tc_smem<D>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_fwd_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    fa_fwd_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), g.hq, g.hkv, g.s_q,
        g.s_k, g.causal, g.sm_scale);
    return cudaGetLastError();
  } else {
    constexpr int smem = fwd_smem<D>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), g.hq, g.hkv, g.s_q,
        g.s_k, g.causal, g.sm_scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const long long* st,
                    const Geometry& g, cudaStream_t stream) {
  const dim3 grid((g.s_k + kTile - 1) / kTile, g.hkv, g.batch);
  if constexpr (kTensorCores<T>) {
    constexpr int smem = dkv_tc_smem<D>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_bwd_dkv_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dkv_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
        view_at(st, 5), g.hq, g.hkv, g.s_q, g.s_k, g.causal, g.sm_scale);
    return cudaGetLastError();
  } else {
    constexpr int smem = dkv_smem<D>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_bwd_dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), view_at(st, 0),
        view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
        view_at(st, 5), g.hq, g.hkv, g.s_q, g.s_k, g.causal, g.sm_scale);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, const long long* st, const Geometry& g,
                   cudaStream_t stream) {
  const dim3 grid((g.s_q + kTile - 1) / kTile, g.hq, g.batch);
  if constexpr (kTensorCores<T>) {
    constexpr int smem = dq_tc_smem<D>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_bwd_dq_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dq_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), view_at(st, 0), view_at(st, 1), view_at(st, 2),
        view_at(st, 3), view_at(st, 4), g.hq, g.hkv, g.s_q, g.s_k, g.causal,
        g.sm_scale);
    return cudaGetLastError();
  } else {
    constexpr int smem = dq_smem<D>();
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem(done, fa_bwd_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    fa_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), view_at(st, 0), view_at(st, 1), view_at(st, 2),
        view_at(st, 3), view_at(st, 4), g.hq, g.hkv, g.s_q, g.s_k, g.causal,
        g.sm_scale);
    return cudaGetLastError();
  }
}

inline bool valid(const Geometry& g) {
  return g.batch > 0 && g.hkv > 0 && g.hq % g.hkv == 0 && g.s_q > 0 &&
         g.s_k > 0;
}

// dtype codes: 0 = float32, 1 = bfloat16; head_dim 64 or 128
#define FA_DISPATCH(CALL)                                                   \
  if (dtype == 0 && head_dim == 64) return CALL(float, 64);                 \
  if (dtype == 0 && head_dim == 128) return CALL(float, 128);               \
  if (dtype == 1 && head_dim == 64) return CALL(__nv_bfloat16, 64);         \
  if (dtype == 1 && head_dim == 128) return CALL(__nv_bfloat16, 128);       \
  return cudaErrorInvalidValue;

}  // namespace

// strides: q, k, v, o as (batch, seq, head) element strides, 12 values.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int batch, int hq, int hkv, int s_q, int s_k,
    int head_dim, int dtype, int causal, float sm_scale, void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, sm_scale};
  if (!valid(g)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FA_FWD(T, D) fwd<T, D>(q, k, v, o, l, strides, g, s)
  FA_DISPATCH(FA_FWD)
#undef FA_FWD
}

// strides: q, k, v, dout, dk, dv, 18 values; lse / delta compact [B*Hq, S_q].
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int batch, int hq, int hkv, int s_q, int s_k,
    int head_dim, int dtype, int causal, float sm_scale, void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, sm_scale};
  if (!valid(g)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define FA_DKV(T, D) bwd_dkv<T, D>(q, k, v, dout, l, dl, dk, dv, strides, g, s)
  FA_DISPATCH(FA_DKV)
#undef FA_DKV
}

// strides: q, k, v, dout, dq, 15 values.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int batch, int hq, int hkv, int s_q, int s_k, int head_dim, int dtype,
    int causal, float sm_scale, void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, sm_scale};
  if (!valid(g)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define FA_DQ(T, D) bwd_dq<T, D>(q, k, v, dout, l, dl, dq, strides, g, s)
  FA_DISPATCH(FA_DQ)
#undef FA_DQ
}

extern "C" int pack_lse_launch(const void* src, void* dst, long long bh,
                               long long s, long long s_row, long long s_seq,
                               void* stream) {
  if (bh <= 0 || s <= 0) return cudaSuccess;
  if (bh > 0x7fffffffLL || (s + 255) / 256 > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bh, (unsigned)((s + 255) / 256));
  pack_lse_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), (int)s, s_row,
      s_seq);
  return cudaGetLastError();
}
