"""Port parity: paddle_tpu_torch.models.llama's paged serving functions
against the JAX package's ``build_llama_paged_decode`` at f32 on the CPU.

The JAX model is built from a seed; its parameters go through
``params_from_numpy`` into the port, so both compute with the same weights.
Each case runs dense prefill, a three-chunk prefill, a decode step with
an inactive lane and a speculative verify step, and compares logits (rtol =
atol = 1e-4: f32 products summed in another order) and the page pools
after every call.  The trash page (index num_pages) is left out of the
page comparison: JAX fills out-of-range rope lookups of padding rows with
NaN where the port clamps, and only the trash page ever receives those rows.

f32 / bf16 pools are compared at atol 1e-5.  Quantized pools (kv_dtype
int8 / fp8) store codes and f32 scales.  The K/V rows they quantize
differ between the two frameworks by f32 rounding (the f32 pools differ by
up to ~2e-6), so the scales are compared at rtol 1e-5, and a code may sit
one grid step away where the two rows straddle a rounding boundary: codes
are equal except for such one-step flips, which must stay rare (at most
0.1% of the codes).  The codec itself is bit-equal to JAX on equal inputs
(tests/test_torch_quant.py)."""
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
SCALE_TOL = dict(rtol=1e-5, atol=0)
MAX_CODE_FLIPS = 1e-3
CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4,
           max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them (``paddle_tpu.ops.pallas.register_all(force=True)``):
    a registered override would call a Pallas kernel outside interpret
    mode."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    yield
    paddle_tpu.set_flags(prev)


class _Pair:
    """One JAX and one port instance of the paged functions over the same
    weights, each with its own page pool."""

    def __init__(self, kv_heads, impl, page_size=4, num_pages=24, seed=3,
                 kv_dtype=None):
        cfg = dict(CFG, num_key_value_heads=kv_heads)
        jcfg, tcfg = JConfig(**cfg), TConfig(**cfg)
        ep, bp, hp, *_ = build_functional_llama(
            jcfg, n_micro=1, key=jax.random.PRNGKey(seed))
        self.jparams = (ep, bp, hp)
        self.tparams = params_from_numpy(
            *[{k: np.asarray(v) for k, v in t.items()} for t in (ep, bp, hp)],
            device="cpu")
        (self.jinit, self.jprefill, self.jchunk, self.jdecode,
         self.jverify) = jbuild(jcfg, page_size=page_size,
                                num_pages=num_pages,
                                attention_impl="pallas" if impl == "pallas"
                                else "ref", interpret=True,
                                kv_dtype=kv_dtype)
        (self.tinit, self.tprefill, self.tchunk, self.tdecode,
         self.tverify) = tbuild(tcfg, page_size=page_size,
                                num_pages=num_pages,
                                attention_impl="kernel" if impl == "pallas"
                                else "ref", device="cpu", kv_dtype=kv_dtype)
        jp, tp = self.jinit(), self.tinit()
        self.jk, self.jv = jp["k"], jp["v"]
        self.tk, self.tv = tp["k"], tp["v"]
        self.num_pages = num_pages
        self.kv_dtype = kv_dtype

    def check_pages(self):
        n = self.num_pages
        for t, j in ((self.tk, self.jk), (self.tv, self.jv)):
            if self.kv_dtype is None:
                np.testing.assert_allclose(t[:, :, :n].numpy(),
                                           np.asarray(j)[:, :, :n],
                                           **PAGE_TOL)
                continue
            np.testing.assert_allclose(t["s"][:, :, :n].numpy(),
                                       np.asarray(j["s"])[:, :, :n],
                                       **SCALE_TOL)
            # codes by value: a flipped int8 code is one integer away, a
            # flipped fp8 code one e4m3 step
            tc = t["q"][:, :, :n].float().numpy()
            jc = np.asarray(j["q"])[:, :, :n].astype(np.float32)
            flips = tc != jc
            if flips.any():
                step = np.abs(tc - jc)[flips]
                # an e4m3 step is at most 1/8 of the value, 2**-9 below the
                # normal range
                grid = 1.0 if self.kv_dtype == "int8" else np.maximum(
                    np.maximum(np.abs(tc), np.abs(jc))[flips] / 8, 2.0 ** -9)
                assert np.all(step <= grid), "a code moved more than a step"
            assert flips.mean() <= MAX_CODE_FLIPS, flips.mean()

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

    def verify(self, toks, lengths, tables, n_q):
        jl, jg, self.jk, self.jv = self.jverify(
            self.jparams, jnp.asarray(toks), jnp.asarray(lengths),
            jnp.asarray(tables), self.jk, self.jv, jnp.asarray(n_q))
        tl, tg, self.tk, self.tv = self.tverify(
            self.tparams, torch.from_numpy(toks), torch.from_numpy(lengths),
            torch.from_numpy(tables), self.tk, self.tv,
            torch.from_numpy(n_q))
        live = np.asarray(n_q) > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **LOGIT_TOL)
        for s in np.flatnonzero(live):
            np.testing.assert_array_equal(tg.numpy()[s, :n_q[s]],
                                          np.asarray(jg)[s, :n_q[s]])
        self.check_pages()


def _drive(pair, r):
    """Dense prefill, three chunks, a decode step and a verify step; the
    verify step's segments straddle page boundaries."""
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
    # speculative verify at K = 4: slot 0 with three drafts from position
    # 12, slot 1 with four from 21, an idle lane
    pair.verify(np.array([[5, 6, 7, 8, 0], [9, 10, 11, 12, 13],
                          [0, 0, 0, 0, 0]], np.int32),
                np.array([12, 21, 0], np.int32), tables,
                np.array([4, 5, 0], np.int32))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_paged_functions_match_jax(kv_heads, impl):
    _drive(_Pair(kv_heads, impl), np.random.default_rng(kv_heads))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_paged_functions_match_jax(kv_dtype, impl):
    """The kv_dtype page store: logits of every function at 1e-4, scales
    and codes as the module docstring states.  GQA 4:2."""
    _drive(_Pair(2, impl, kv_dtype=kv_dtype), np.random.default_rng(7))


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
