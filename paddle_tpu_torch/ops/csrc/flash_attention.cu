// FlashAttention-2 forward and backward for NVIDIA Hopper (sm_90a) at head
// widths 64 and 128 (head dims 56-64 and 104-128), and the lse repack.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// (_fwd_kernel, _bwd_dkv_kernel, _bwd_dq_kernel at these head dims, and
// _pack_lse).  The bodies, what bounds them and their design are in
// flash_attention.cuh; the other widths are this source built with
// -DFA_TU_WIDTHS=<W>, one library each, in parallel with this one
// (ops/_build.py WIDTH_LIBRARIES).  At D = 64 and 128 this library holds
// the full-width (PART = false) bodies, the kernels the train steps of the
// port were tuned with.

#ifndef FA_TU_WIDTHS
#define FA_TU_WIDTHS 64, 128
#define FA_TUNED_LIBRARY 1
#endif
#include "flash_attention.cuh"

namespace {

// [BH, S, 1] stats with (row, seq) strides -> compact [BH, S] f32; one
// block row per stats row, one thread per element
__global__ void pack_lse_kernel(const float* __restrict__ src,
                                float* __restrict__ dst, int s,
                                long long s_row, long long s_seq) {
  const long long r = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c < s) dst[r * s + c] = src[r * s_row + c * s_seq];
}

}  // namespace

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

#ifdef FA_TUNED_LIBRARY
// The wgmma forward without segments (bf16, D 64, no dropout): compiled
// beside the mma.sync forward of row 3 so that a run can time the two
// designs on the same inputs; the wrappers never launch it.  Arguments as
// flash_attention_fwd_launch (the dropout threshold 0, no segments).
extern "C" int flash_attention_fwd_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int batch, int hq, int hkv, int s_q, int s_k,
    int head_dim, int dtype, int causal, float sm_scale, unsigned thresh,
    float drop_scale, unsigned seed_lo, unsigned seed_hi, const void* seg,
    void* stream) {
  const Geometry g{batch, hq, hkv, s_q, s_k, causal, head_dim, sm_scale};
  if (!valid(g, seg) || dtype != 1 || head_dim != 64 || thresh != 0 ||
      seg != nullptr)
    return cudaErrorInvalidValue;
  return fwd_wgmma<64, false, false>(q, k, v, o, static_cast<float*>(lse),
                                     strides, g, Dropout{0, drop_scale,
                                                         seed_lo, seed_hi},
                                     nullptr,
                                     static_cast<cudaStream_t>(stream));
}
#endif  // FA_TUNED_LIBRARY
