// Ragged paged attention over f32 / bf16 pages, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `ragged_paged_attention` -> `_ragged_kernel`: every serving path (decode
// with q_len = 1, speculative verify with q_len = K + 1, chunked / suffix
// prefill with q_len = chunk) scores its ragged query segment against the
// slot's paged KV cache through this one entry.  The bodies (the CUDA-core
// few-row tile, the tensor-core 64-row tile for bf16 q, the split-KV
// merge), their layout and what bounds them are in
// ragged_paged_attention.cuh; here the pages hold q's own dtype.  At 7B's
// decode shape the K/V bytes bound it (9.8 us for four slots of 96-1,040
// tokens on an H100 SXM); the split-KV grid and the staged, coalesced
// pages are what bring it toward that bound.
//
// ragged_paged_attention_combine_launch runs the splits' merge alone (the
// main entry launches it itself after a split grid); it is exposed for
// holding and timing the merge on its own.

#include "ragged_paged_attention.cuh"

// dtype codes: 0 = float32, 1 = bfloat16; q, k and v share in_dtype.
// row_tile: 8 (CUDA cores) or 64 (tensor cores, bf16 q); the splits: n
// splits of split_len tokens, partials in ml [n, S, Hkv, Qmax * rep] x 2 and
// acc [n, S, Hkv, Qmax * rep, D] f32 (unused, may be null, with one split).
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
               static_cast<cudaStream_t>(stream)};
  if (!valid_geometry(a)) return cudaErrorInvalidValue;
  if (in_dtype == 0) return launch_out<float, float>(head_dim, out_dtype, a);
  if (in_dtype == 1)
    return launch_out<__nv_bfloat16, __nv_bfloat16>(head_dim, out_dtype, a);
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
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  if (out_dtype == 0)
    return head_dim == 64 ? launch_combine<float, 64>(a)
                          : launch_combine<float, 128>(a);
  if (out_dtype == 1)
    return head_dim == 64 ? launch_combine<__nv_bfloat16, 64>(a)
                          : launch_combine<__nv_bfloat16, 128>(a);
  return cudaErrorInvalidValue;
}
