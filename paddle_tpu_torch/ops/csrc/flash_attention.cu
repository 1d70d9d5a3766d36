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
