// The attention-dropout mask of flash_attention.cu: Philox4x32-10 (Salmon
// et al., SC'11; the constants and round of Random123's philox4x32), written
// out so that a kernel draws its words in registers, next to the scores they
// mask, and the mask never reaches device memory.
//
// The mask is a function of a score's global coordinates alone, the same
// as paddle_tpu_torch/ops/flash_attention.py's dropout_keep: key columns
// come in groups of 16, and the columns {2t, 2t+1, 8+2t, 9+2t} of a group
// (the four that thread t of a quad holds in an m16n8k16 accumulator
// fragment) share one call with the counter (4 * (col / 16) + t, q row,
// b * Hq + h, 0) and take its words 0..3 in that order.  The key is the
// 64-bit seed as (low word, high word).  A score is kept iff its word >=
// thresh = uint32(rate * 2^32) (the TPU kernel's rule), and a kept
// probability is scaled by `scale` = 1 / (1 - rate).

#pragma once

#include <cuda_runtime.h>

namespace {

struct Dropout {
  unsigned thresh;  // 0: no dropout (the kernels take the other branch)
  float scale;      // 1 / (1 - rate), as f32
  unsigned k0, k1;  // the seed's low and high words
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// the four words of call `cell` (= 4 * (col / 16) + t) of q row `row` of
// q-head row `bhq`
__device__ __forceinline__ uint4 dropout_words(const Dropout& dr,
                                               unsigned cell, unsigned row,
                                               unsigned bhq) {
  return philox4x32_10(make_uint4(cell, row, bhq, 0u), dr.k0, dr.k1);
}

__device__ __forceinline__ float dropped(const Dropout& dr, unsigned word,
                                         float x) {
  return word >= dr.thresh ? x * dr.scale : 0.f;
}

// the word of one score (q row `row`, key column `col`) alone, from its
// call (the f32 kernels, which hold scores outside the fragment layout)
__device__ __forceinline__ unsigned dropout_word_at(const Dropout& dr,
                                                    int row, int col,
                                                    unsigned bhq) {
  const uint4 w = dropout_words(
      dr, (unsigned)(col >> 4) * 4u + ((col & 7) >> 1), row, bhq);
  const int i = ((col >> 3) & 1) * 2 + (col & 1);
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// A 16-key group of an m16n8k16 accumulator fragment whose rows are q rows:
// a and b are n-tiles 2np and 2np + 1 (elements 0, 1 at q row `row`, 2, 3
// at row + 8; columns 2t + (e & 1) and 8 + 2t + (e & 1) of the group); each
// value becomes x * scale where kept, else 0.  Two calls for 8 scores.
__device__ __forceinline__ void drop_group(const Dropout& dr, float a[4],
                                           float b[4], unsigned cell, int row,
                                           unsigned bhq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint4 w = dropout_words(dr, cell, row + 8 * r, bhq);
    a[2 * r] = dropped(dr, w.x, a[2 * r]);
    a[2 * r + 1] = dropped(dr, w.y, a[2 * r + 1]);
    b[2 * r] = dropped(dr, w.z, b[2 * r]);
    b[2 * r + 1] = dropped(dr, w.w, b[2 * r + 1]);
  }
}

}  // namespace
