// Ragged paged attention over f32 / bf16 pages, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `ragged_paged_attention` -> `_ragged_kernel`: every serving path (decode
// with q_len = 1, speculative verify with q_len = K + 1, chunked / suffix
// prefill with q_len = chunk) scores its ragged query segment against the
// slot's paged KV cache through this one kernel.  The body, its layout and
// what bounds it are in ragged_paged_attention.cuh; here the pages hold
// q's own dtype.

#include "ragged_paged_attention.cuh"

// dtype codes: 0 = float32, 1 = bfloat16; q, k and v share in_dtype.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_len, void* out, int s_slots, int qmax, int hq, int hkv,
    int num_pages, int page_size, int table_width, int head_dim, int in_dtype,
    int out_dtype, float sm_scale, void* stream) {
  if (s_slots <= 0 || qmax <= 0) return cudaSuccess;
  if (!valid_geometry(hq, hkv, page_size)) return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, nullptr, nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(q_start),
               static_cast<const int*>(q_len),
               static_cast<const int*>(kv_len), out, s_slots, qmax, hq, hkv,
               num_pages, page_size, table_width, sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (in_dtype == 0) return launch_out<float, float>(head_dim, out_dtype, a);
  if (in_dtype == 1)
    return launch_out<__nv_bfloat16, __nv_bfloat16>(head_dim, out_dtype, a);
  return cudaErrorInvalidValue;
}
