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
// 16-byte aligned; rows of a multiple of 16 codes and 8-row groups of
// scales keep that alignment (rows of 8 mod 16 codes go by 8-byte copies).  After a split grid this entry launches the merge
// (ragged_paged_attention_combine_kernel) itself.  This library holds head
// widths 64 and 128 (the entry is in the header); each other width is
// this source built with -DRPA_TU_WIDTHS=<W> into a library of its own
// (ops/_build.py WIDTH_LIBRARIES).

#ifndef RPA_TU_WIDTHS
#define RPA_TU_WIDTHS 64, 128
#endif
#define RPA_QUANT_ENTRIES
#include "ragged_paged_attention.cuh"
