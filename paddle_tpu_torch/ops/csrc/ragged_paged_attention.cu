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
// holding and timing the merge on its own.  This library holds head widths
// 64 and 128 (the entries are in the header); each other width is this
// source built with -DRPA_TU_WIDTHS=<W> into a library of its own
// (ops/_build.py WIDTH_LIBRARIES).

#ifndef RPA_TU_WIDTHS
#define RPA_TU_WIDTHS 64, 128
#endif
#define RPA_PLAIN_ENTRIES
#include "ragged_paged_attention.cuh"
