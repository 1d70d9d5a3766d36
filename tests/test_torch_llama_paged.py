"""Port parity: paddle_tpu_torch.models.llama's paged serving functions
against the JAX package's ``build_llama_paged_decode`` at f32 on the CPU.

The JAX model is built from a seed; its parameters go through
``params_from_numpy`` into the port, so both compute with the same weights.
Each case runs dense prefill, a three-chunk prefill and a decode step with
an inactive lane, and compares logits (rtol = atol = 1e-4: f32 products
summed in another order) and the page pools (atol 1e-5) after every call.
The trash page (index num_pages) is left out of the page comparison: JAX
fills out-of-range rope lookups of padding rows with NaN where the port
clamps, and only the trash page ever receives those rows."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models.llama import (LlamaConfig as JConfig,
                                     build_functional_llama,
                                     build_llama_paged_decode as jbuild)
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import (LlamaConfig as TConfig,
                                           build_llama_paged_decode as tbuild)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PAGE_TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)


class _Pair:
    """One JAX and one port instance of the paged functions over the same
    weights, each with its own page pool."""

    def __init__(self, kv_heads, impl, page_size=4, num_pages=24, seed=3):
        cfg = dict(CFG, num_key_value_heads=kv_heads)
        jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
        ep, bp, hp, *_ = build_functional_llama(
            jcfg, n_micro=1, key=jax.random.PRNGKey(seed))
        self.jparams = (ep, bp, hp)
        self.tparams = params_from_numpy(
            *[{k: np.asarray(v) for k, v in t.items()} for t in (ep, bp, hp)])
        jfns = jbuild(jcfg, page_size=page_size, num_pages=num_pages,
                      attention_impl="pallas" if impl == "pallas" else "ref",
                      interpret=True)
        self.jinit, self.jprefill, self.jchunk, self.jdecode = jfns[:4]
        (self.tinit, self.tprefill, self.tchunk,
         self.tdecode) = tbuild(tcfg, page_size=page_size,
                                num_pages=num_pages,
                                attention_impl="kernel" if impl == "pallas"
                                else "ref", device="cpu")
        jp, tp = self.jinit(), self.tinit()
        self.jk, self.jv = jp["k"], jp["v"]
        self.tk, self.tv = tp["k"], tp["v"]
        self.num_pages = num_pages

    def check_pages(self):
        n = self.num_pages
        np.testing.assert_allclose(self.tk[:, :, :n].numpy(),
                                   np.asarray(self.jk)[:, :, :n], **PAGE_TOL)
        np.testing.assert_allclose(self.tv[:, :, :n].numpy(),
                                   np.asarray(self.jv)[:, :, :n], **PAGE_TOL)

    def prefill(self, ids, true_len, page_row):
        jl, self.jk, self.jv = self.jprefill(
            self.jparams, jnp.asarray(ids), jnp.asarray(true_len, jnp.int32),
            jnp.asarray(page_row), self.jk, self.jv)
        tl, self.tk, self.tv = self.tprefill(
            self.tparams, torch.from_numpy(ids), true_len,
            torch.from_numpy(page_row), self.tk, self.tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        self.check_pages()

    def chunk(self, ids, start, chunk_len, page_row):
        jl, jt, self.jk, self.jv = self.jchunk(
            self.jparams, jnp.asarray(ids), jnp.asarray(start, jnp.int32),
            jnp.asarray(chunk_len, jnp.int32), jnp.asarray(page_row),
            self.jk, self.jv)
        tl, tt, self.tk, self.tv = self.tchunk(
            self.tparams, torch.from_numpy(ids), start, chunk_len,
            torch.from_numpy(page_row), self.tk, self.tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert int(tt) == int(jt)
        self.check_pages()

    def decode(self, toks, lengths, tables, active):
        jl, self.jk, self.jv = self.jdecode(
            self.jparams, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(tables), self.jk, self.jv, jnp.asarray(active))
        tl, self.tk, self.tv = self.tdecode(
            self.tparams, torch.from_numpy(toks), torch.from_numpy(lengths),
            torch.from_numpy(tables), self.tk, self.tv,
            torch.from_numpy(active))
        live = np.asarray(active)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
        self.check_pages()


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_paged_functions_match_jax(kv_heads, impl):
    pair = _Pair(kv_heads, impl)
    r = np.random.default_rng(kv_heads)
    P = 8
    # slot 0: dense prefill of an 11-token prompt padded to 16
    prompt0 = r.integers(1, 256, 11).astype(np.int32)
    row0 = np.array([3, 7, 1, 9, 0, 0, 0, 0], np.int32)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :11] = prompt0
    pair.prefill(ids, 11, row0)
    # slot 1: a 20-token prompt in chunks of 8, 8 and 4 (padded to 8), each
    # chunk seeing a 4-page-granular slice of its page row
    prompt1 = r.integers(1, 256, 20).astype(np.int32)
    row1 = np.array([5, 2, 11, 4, 8, 0, 0, 0], np.int32)
    for start, clen, pb in ((0, 8, 4), (8, 8, 4), (16, 4, 8)):
        ids = np.zeros((1, 8), np.int32)
        ids[0, :clen] = prompt1[start:start + clen]
        pair.chunk(ids, start, clen, row1[:pb].copy())
    # one decode step over both slots plus an inactive lane
    tables = np.stack([row0, row1, np.zeros(P, np.int32)])
    pair.decode(np.array([17, 42, 0], np.int32),
                np.array([11, 20, 0], np.int32), tables,
                np.array([True, True, False]))


def test_prefill_bucket_overrunning_the_page_table():
    """prompt_bucket 32 > max_pages_per_seq * page_size = 16: the padded
    positions' page lookups run past the row (JAX clips, the port clamps)
    and land on the trash page either way."""
    pair = _Pair(4, "ref")
    r = np.random.default_rng(0)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :13] = r.integers(1, 256, 13)
    pair.prefill(ids, 13, np.array([6, 2, 10, 3], np.int32))


def test_chunk_overrunning_page_row_and_rope_table():
    """A final chunk near the context end: its padded positions run past
    both the sliced page row and the rope table (JAX fills NaN there)."""
    pair = _Pair(2, "ref", num_pages=20)
    r = np.random.default_rng(1)
    prompt = r.integers(1, 256, 58).astype(np.int32)
    row = np.arange(16, dtype=np.int32)[::-1].copy()
    # chunks padded to 24: the last one's padding reaches position 71,
    # past the 64-entry rope table and the 16-page row
    for start, clen in ((0, 24), (24, 24), (48, 10)):
        ids = np.zeros((1, 24), np.int32)
        ids[0, :clen] = prompt[start:start + clen]
        pair.chunk(ids, start, clen, row)
