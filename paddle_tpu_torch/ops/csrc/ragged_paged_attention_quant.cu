// Ragged paged attention over int8 / fp8 (e4m3) pages with per-row f32
// scales, dequantized inside the kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `ragged_paged_attention` -> `_ragged_kernel_quant`: the serving paths of
// an engine with kv_dtype="int8" or "fp8" (decode, speculative verify,
// chunked prefill) attend through it.  The scale pages ([Hkv, NP, ps] f32)
// come through the same page-table lookup and the same cp.async ring as
// the codes.  On the CUDA-core tile each K/V element becomes
// float(code) * scale[row] in f32 registers just before the online-softmax
// update — the TPU kernel's expression, not rounded to q's dtype; the
// tensor-core tile (bf16 q, 64 rows) dequantizes a staged tile to
// bf16(code * scale) in shared memory before ldmatrix, the rounding the
// plain version and JAX's reference make.
//
// What bounds it: the K/V bytes read, one byte per element plus four per
// row for the scales — about half of the bf16 entry's at D = 128 (5.0 us at
// 7B's decode shape on an H100 SXM).  The bodies are the templates of
// ragged_paged_attention.cuh with a one-byte page type: a 16-byte chunk of
// a K row carries 16 codes, and a 16-token stage is 2 KB of codes per
// tensor at D = 128.  The wrapper asserts that the page and scale bases are
// 16-byte aligned; rows of D >= 64 codes and 8-row groups of scales keep
// that alignment.  After a split grid this entry launches the merge
// (ragged_paged_attention_combine_kernel) itself.

#include "ragged_paged_attention.cuh"

namespace {

template <typename S>
cudaError_t launch_in(int in_dtype, int head_dim, int out_dtype,
                      const Args& a) {
  if (in_dtype == 0) return launch_out<float, S>(head_dim, out_dtype, a);
  if (in_dtype == 1)
    return launch_out<__nv_bfloat16, S>(head_dim, out_dtype, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q and out); kv_dtype codes:
// 0 = int8, 1 = float8_e4m3fn (both page arrays); row_tile and the splits
// as in ragged_paged_attention_launch.
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
               static_cast<cudaStream_t>(stream)};
  if (!valid_geometry(a)) return cudaErrorInvalidValue;
  if (kv_dtype == 0) return launch_in<int8_t>(in_dtype, head_dim, out_dtype, a);
  if (kv_dtype == 1)
    return launch_in<__nv_fp8_e4m3>(in_dtype, head_dim, out_dtype, a);
  return cudaErrorInvalidValue;
}
