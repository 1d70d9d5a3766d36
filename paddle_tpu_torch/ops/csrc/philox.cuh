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

// The keep bits of one call's words (bit i: word i >= thresh): the mask
// as the wgmma backward keeps it, one bit a score
__device__ __forceinline__ unsigned keep_nibble(const Dropout& dr, uint4 w) {
  return (unsigned)(w.x >= dr.thresh) | (unsigned)(w.y >= dr.thresh) << 1 |
         (unsigned)(w.z >= dr.thresh) << 2 | (unsigned)(w.w >= dr.thresh) << 3;
}

// x * scale where bit i of `bits` is set, else 0
__device__ __forceinline__ float kept(const Dropout& dr, unsigned bits, int i,
                                      float x) {
  return (bits >> i) & 1u ? x * dr.scale : 0.f;
}

// The keep bits of NG 16-key groups of a fragment whose rows are q rows
// (the wgmma forward's and dQ's; m16n8k16's layout per 8-column n-tile):
// bit 4 j + e is element e of n-tile j (q row `row` + 8 (e >> 1), key
// column 8 j + 2t + (e & 1)), so byte kk holds group kk's 8 scores.  Two
// calls a group, of rows `row` and `row` + 8, with `cell0` = the first
// group's 4 (col / 16) + t.
template <int NG>
__device__ __forceinline__ unsigned keep_bits_rows(const Dropout& dr,
                                                   unsigned cell0, int row,
                                                   unsigned bhq) {
  static_assert(NG <= 4, "32 bits: at most four 16-key groups");
  unsigned bits = 0;
#pragma unroll
  for (int kk = 0; kk < NG; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned n =
          keep_nibble(dr, dropout_words(dr, cell0 + 4 * kk, row + 8 * r, bhq));
      // words x, y to n-tile 2 kk, z, w to 2 kk + 1, at elements 2 r, 2 r + 1
      bits |= ((n & 3u) | (n & 12u) << 2) << (8 * kk + 2 * r);
    }
  return bits;
}

// The keep bits of a transposed fragment (the wgmma dK / dV's: rows are
// keys g and g + 8 of a 16-key group, `kcell` = 4 (key / 16) + g / 2; its
// NQ 8-column n-tiles are q rows): bit 4 j + e is element e of n-tile j
// (q row q0 + 8 j + (e & 1) with q0 = row0 + 2t, key g + 8 (e >> 1)).  A
// thread's scores of one q row lie in one call but use 2 of its words
// (g & 1, 2 + (g & 1)); lanes g and g ^ 1 (lane ^ 4) hold the same q rows,
// so each draws the call of one of the two (q0 + 8 j + odd) and the pair
// swaps the keep bits of the other in one shuffle: no call is drawn twice.
template <int NQ>
__device__ __forceinline__ unsigned keep_bits_cols(const Dropout& dr,
                                                   unsigned kcell, int q0,
                                                   bool odd, unsigned bhq) {
  static_assert(NQ <= 8, "32 bits: at most eight n-tiles");
  unsigned own = 0;
#pragma unroll
  for (int j = 0; j < NQ; ++j)
    own |= keep_nibble(dr, dropout_words(dr, kcell, q0 + 8 * j + odd, bhq))
           << (4 * j);
  const unsigned other = __shfl_xor_sync(0xffffffffu, own, 4);
  // q row q0 + 8 j's nibble (a) and q0 + 8 j + 1's (b); this lane's keys
  // take their words (g & 1) and (g & 1) + 2
  const unsigned a = odd ? other : own, b = odd ? own : other;
  const unsigned s = odd ? 1u : 0u;
  return ((a >> s) & 0x55555555u) | ((b >> s) & 0x55555555u) << 1;
}

}  // namespace
