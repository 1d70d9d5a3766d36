"""Port parity: paddle_tpu_torch.ops.flash_attention against the JAX
package's Pallas flash-attention kernels in interpret mode, on the CPU at
f32.  The same numpy inputs feed both packages; the JAX kernels take
[B*H, S, D] rows, the port [B, S, H, D].  Tolerances are the JAX suite's
own: o and lse 2e-5, gradients 2e-4, the lse repack exact.  On CPU
tensors the port's wrappers run their plain versions, so the kernel launch
counters must not move.  The dropout and segment branches are held in
``test_torch_flash_attention_branches.py``, which imports this file's
helpers; every head dim the JAX kernels take is held here."""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from paddle_tpu_torch.ops import flash_attention as tfa

# the JAX package's ops.pallas re-exports a function under the module's name
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)

# (B, S_q, S_k, Hq, Hkv, D)
SHAPES = [(1, 128, 128, 1, 1, 64), (2, 256, 256, 2, 2, 64),
          (1, 128, 128, 4, 2, 64), (2, 128, 128, 4, 1, 32),
          (1, 128, 256, 2, 2, 64)]
IDS = ["1x128x1", "2x256x2", "gqa4:2", "gqa4:1", "sq128<sk256"]


def _inputs(shape, seed):
    b, s_q, s_k, hq, hkv, d = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, s_q, hq, d)).astype(np.float32)
    k = r.standard_normal((b, s_k, hkv, d)).astype(np.float32)
    v = r.standard_normal((b, s_k, hkv, d)).astype(np.float32)
    do = r.standard_normal((b, s_q, hq, d)).astype(np.float32)
    return q, k, v, do


def _rows(x):
    """[B, S, H, D] numpy -> the JAX kernels' [B*H, S, D], in a buffer of
    JAX's own: ``jnp.asarray`` would alias a 64-byte-aligned numpy buffer
    (at B = H = 1 the reshape is a view of the array the torch side reads
    too), and whether it is aligned depends on what the worker allocated
    before."""
    b, s, h, d = x.shape
    return jnp.array(x.transpose(0, 2, 1, 3).reshape(b * h, s, d), copy=True)


@pytest.fixture(autouse=True)
def _pinned_numerics():
    """Pin the process-wide settings the f32 comparisons depend on, whatever
    ran before on the worker: torch's f32 matmul precision and default
    dtype, and JAX's default matmul precision."""
    prec, dtype = torch.get_float32_matmul_precision(), torch.get_default_dtype()
    torch.set_float32_matmul_precision("highest")
    torch.set_default_dtype(torch.float32)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.set_default_dtype(dtype)


def _bshd(x, b):
    """[B*H, S, D] -> [B, S, H, D] numpy."""
    x = np.asarray(x)
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


def _counts():
    return (tfa.flash_attention_fwd.launches, tfa.pack_lse.launches,
            tfa.flash_attention_bwd_dkv.launches,
            tfa.flash_attention_bwd_dq.launches)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_pallas_interpret(shape, causal):
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, _ = _inputs(shape, seed=1)
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jax.block_until_ready(jfa.flash_attention_fwd_kernel_call(
        _rows(q), _rows(k), _rows(v), causal, scale, interpret=True,
        n_q_heads=hq, n_kv_heads=hkv))
    before = _counts()
    o, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                     causal, scale)
    assert _counts() == before
    assert o.dtype == torch.float32 and lse.shape == (b * hq, s_q)
    np.testing.assert_allclose(o.numpy(), _bshd(jo, b), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_matches_pallas_interpret(shape, causal):
    """dq/dk/dv of the plain backward versions against ``_bwd_call`` on the
    same residuals and the same ``do``; dk/dv keep the kv head count."""
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, do = _inputs(shape, seed=2)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = _rows(q), _rows(k), _rows(v)
    jo, jlse = jfa.flash_attention_fwd_kernel_call(
        jq, jk, jv, causal, scale, interpret=True, n_q_heads=hq,
        n_kv_heads=hkv)
    jdq, jdk, jdv = jax.block_until_ready(jfa._bwd_call(
        (jq, jk, jv, jo, jlse), _rows(do), causal, scale, True,
        n_q_heads=hq, n_kv_heads=hkv))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, scale)
    before = _counts()
    dq, dk, dv = tfa._bwd_call((tq, tk, tv, o, lse), tdo, causal, scale)
    assert _counts() == before
    assert dk.shape == (b, s_k, hkv, d) and dv.shape == (b, s_k, hkv, d)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b), **BWD_TOL)


def test_pack_lse_matches_pallas_interpret():
    """The standalone repack, exact, from a contiguous and a strided
    [BH, S, 1] input."""
    r = np.random.default_rng(3)
    lse3 = r.standard_normal((3, 256, 1)).astype(np.float32)
    want = np.asarray(jfa._pack_lse(jnp.asarray(lse3), interpret=True))
    got = tfa.pack_lse(torch.from_numpy(lse3))
    np.testing.assert_array_equal(got.numpy(), want)
    wide = torch.from_numpy(r.standard_normal((3, 256, 4)).astype(np.float32))
    strided = wide[..., 2:3]
    want = np.asarray(jfa._pack_lse(jnp.asarray(strided.numpy()),
                                    interpret=True))
    np.testing.assert_array_equal(tfa.pack_lse(strided).numpy(), want)


def test_autograd_matches_jax_vjp():
    """The differentiable op: forward and all three gradients through
    ``torch.autograd`` equal ``jax.vjp`` of the Pallas op (interpret)."""
    shape = (1, 128, 128, 4, 2, 64)
    q, k, v, do = _inputs(shape, seed=4)
    jout, vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention(a, b_, c, causal=True,
                                             interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **BWD_TOL)


@pytest.mark.parametrize("q_shape,k_shape,causal", [
    ((1, 197, 1, 64), (1, 197, 1, 64), False),      # short untileable S
    ((2, 577, 16, 64), (2, 577, 16, 64), False),    # ViT-L/16 at 384 px
    ((2, 640, 16, 64), (2, 640, 16, 64), False),    # ... padded to the tile
    ((1, 128, 1, 300), (1, 128, 1, 300), False),    # head_dim > 256
    ((1, 128, 3, 64), (1, 128, 2, 64), False),      # heads not a multiple
    ((1, 256, 2, 64), (1, 128, 2, 64), True),       # causal s_q > s_k
    ((1, 256, 2, 64), (1, 128, 2, 64), False),
    ((2, 256, 4, 64), (2, 256, 2, 64), True),
])
def test_supported_agrees_with_jax(q_shape, k_shape, causal):
    assert tfa._supported(q_shape, k_shape, causal) \
        == jfa._supported(q_shape, k_shape, causal)


def test_unsupported_shape_returns_none():
    """The shapes of the JAX suite's test_unsupported_shape_returns_none:
    None from both, so that the caller runs plain attention."""
    for shape in ((1, 197, 1, 64), (1, 128, 1, 300)):
        jq = jnp.zeros(shape)
        assert jfa.flash_attention(jq, jq, jq) is None
        tq = torch.zeros(shape)
        assert tfa.flash_attention(tq, tq, tq) is None


def test_paths_not_ported_raise():
    """Every path of the JAX op is ported and runs: segment ids and the
    pad-to-tile path (S 400, which JAX pads to 512) return a finite output
    of q's shape, and so does in-kernel dropout (a seed, or one drawn from
    a host generator)."""
    q = torch.zeros((1, 128, 1, 64))
    out = tfa.flash_attention(q, q, q, segment_ids=torch.zeros((1, 128)))
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    out = tfa.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    out = tfa.flash_attention(q, q, q, dropout_rate=0.1,
                              generator=torch.Generator().manual_seed(0))
    assert out.shape == q.shape
    long = torch.zeros((1, 400, 1, 64))               # JAX pads it to 512
    out = tfa.flash_attention(long, long, long)
    assert out.shape == long.shape and bool(torch.isfinite(out).all())


# -- attention dropout ---------------------------------------------------------
DROP_SHAPES = [(1, 128, 128, 2, 2, 64), (2, 128, 128, 4, 2, 32),
               (1, 128, 256, 4, 1, 64)]
DROP_IDS = ["mha", "gqa4:2", "gqa4:1 sq<sk"]


def _two_segments(b, s, first):
    """[B, S] int32 ids: ``first`` rows of segment 0, the rest segment 1
    (the JAX suite's packed pair)."""
    return np.concatenate([np.zeros(first), np.ones(s - first)])[None] \
        .repeat(b, 0).astype(np.int32)


def _jax_masked_attention(q, k, v, factor, causal, seg=None):
    """JAX's masked formula (the TPU kernel's, as
    ``test_pallas_kernels.py``'s dropout test writes it): softmax(s) times
    the factor keep / (1 - rate), then @ v; [B, S, H, D], GQA by repeating
    K/V, f32; with ``seg`` [B, S] the scores across segments are masked,
    as ``test_pallas_kernels.py``'s ``_ref_sdpa_segments`` masks them."""
    hq = q.shape[2]
    k = jnp.repeat(k, hq // k.shape[2], axis=2)
    v = jnp.repeat(v, hq // v.shape[2], axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        s = jnp.where(jnp.tril(jnp.ones((sq, sk), bool), k=sk - sq), s,
                      -jnp.inf)
    if seg is not None:
        s = jnp.where(seg[:, None, :, None] == seg[:, None, None, :], s,
                      -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p * factor, v)


def _factor(seed, shape, rate):
    """keep / (1 - rate) of the port's mask as numpy [B, Hq, S_q, S_k]."""
    b, s_q, s_k, hq, _, _ = shape
    keep = tfa.dropout_keep(seed, range(b * hq), range(s_q), range(s_k),
                            rate).numpy().reshape(b, hq, s_q, s_k)
    return np.where(keep, np.float32(tfa.dropout_scale(rate)),
                    np.float32(0.0))


def test_ref_matches_jax_ref():
    """``flash_attention_ref`` (the plain [B, S, H, D] oracle) equals the
    JAX one, causal GQA."""
    q, k, v, _ = _inputs((2, 128, 128, 4, 2, 64), seed=5)
    want = jfa.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=True)
    got = tfa.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def _held_bf16(got, want, extra=None):
    """A bf16 kernel output against its plain version, as ``chip_smoke.py``
    holds it (``TRAIN_TOL``): elementwise within 2e-3 + 1.6e-2 |plain|
    (+ ``extra``), and each row whose plain norm is at least 1% of the
    median row's within 1.6e-2 of that norm."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = 2e-3 + 1.6e-2 * want.abs() + (0 if extra is None else extra)
    assert bool((err <= bound).all()), float(err.max())
    rows = (got - want).reshape(-1, want.shape[-1]).norm(dim=-1)
    ref = want.reshape(-1, want.shape[-1]).norm(dim=-1)
    big = ref >= 0.01 * ref.median()
    assert bool((rows[big] <= 1.6e-2 * ref[big]).all())


# bf16 cases for the tensor-core kernels' tiling: s_q < s_k causal, a
# partial 128-row forward q tile with GQA 16:4, S = 200 causal at D = 128,
# and one short q tile against a long key range; for dQ's 64-row q blocks
# and 16-key steps: D = 128 with GQA 16:4, a q length of 136 (inside a
# block), s_q < s_k causal with GQA 16:4, and S = 200 non-causal
BF16_CARD_CASES = [((2, 128, 384, 8, 4, 64), True),
                   ((2, 320, 320, 16, 4, 64), True),
                   ((2, 200, 200, 8, 8, 128), True),
                   ((2, 64, 2048, 16, 16, 64), True),
                   ((2, 320, 320, 16, 4, 128), True),
                   ((2, 136, 136, 8, 8, 64), True),
                   ((2, 136, 520, 16, 4, 64), True),
                   ((2, 200, 200, 16, 4, 64), False)]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Forward, both backward kernels and the repack against their plain
    versions on the card, f32, causal GQA, s_q < s_k, and lengths that end
    inside a 64-row tile; and the bf16 kernels on ``BF16_CARD_CASES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape, causal in (((2, 128, 128, 4, 2, 64), True),
                          ((1, 128, 256, 2, 2, 128), False),
                          ((2, 128, 200, 4, 2, 64), False),
                          ((1, 200, 200, 2, 2, 64), True)):
        q, k, v, do = (torch.from_numpy(x).cuda()
                       for x in _inputs(shape, seed=6))
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = tfa.flash_attention_fwd(q, k, v, causal, scale)
        ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, causal, scale)
        delta = (do * o).sum(-1).permute(0, 2, 1).reshape(lse.shape)
        got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                          scale)
        got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                           scale),)
        want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               causal, scale)
        want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                causal, scale),)
        torch.cuda.synchronize()
        for a, b_ in ((o, ro), (lse, rlse)) + tuple(zip(got, want)):
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
    for shape, causal in BF16_CARD_CASES:
        q, k, v, do = (torch.from_numpy(x).cuda().bfloat16()
                       for x in _inputs(shape, seed=7))
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = tfa.flash_attention_fwd(q, k, v, causal, scale)
        ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, causal, scale)
        # the kernel rounds p to bf16 before P V, as the TPU kernel does
        p_round = 2.0 ** -8 * tfa.flash_attention_fwd_ref(
            q, k, v.abs(), causal, scale)[0].float()
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
            .reshape(lse.shape).contiguous()
        got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                          scale)
        got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                           scale),)
        want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               causal, scale)
        want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                causal, scale),)
        torch.cuda.synchronize()
        _held_bf16(o, ro, p_round)
        torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
        for a, b_ in zip(got, want):
            _held_bf16(a, b_)
    lse3 = torch.randn(4, 256, 3, device="cuda")[..., 1:2]
    torch.testing.assert_close(tfa.pack_lse(lse3), tfa.pack_lse_ref(lse3),
                               rtol=0, atol=0)


# the wgmma dK/dV and dQ without segments, (shape, causal, dropout rate):
# the UNet's level-0 head dim (40, at W 48) non-causal over 4 q tiles of 64
# rows per key block, causal GQA 8:2 at D 64 with S off the tile, and the
# dropout branch at rate 0.1, non-causal, at D 64 (ERNIE's head dim, GQA
# 8:2, S off the tile) and at D 40
WGMMA_BWD_CARD_CASES = [((2, 256, 256, 4, 4, 40), False, 0.0),
                        ((2, 200, 200, 8, 2, 64), True, 0.0),
                        ((2, 200, 200, 8, 2, 64), False, 0.1),
                        ((2, 256, 256, 4, 4, 40), False, 0.1)]


@pytest.mark.cuda
def test_wgmma_backward_matches_plain_versions_on_card():
    """Each bf16 launch's body (``kernel_body``): the forward, dK/dV and dQ
    wgmma without segments, with and without dropout (dK/dV mma.sync at W
    160); then the wgmma dK/dV and dQ against
    their plain versions on ``WGMMA_BWD_CARD_CASES`` (as ``chip_smoke.py``
    holds them) and, under dropout, their masks read out against
    ``dropout_keep``'s bits (``chip_smoke.check_masks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for d in (40, 64, 80, 160, 256):
        dkv = "mma.sync" if d == 160 else "wgmma"
        for dropout in (False, True):
            assert chip_smoke.launch_bodies(tfa, d, False, dropout) == {
                "fwd": "wgmma", "bwd_dkv": dkv, "bwd_dq": "wgmma"}
    for shape, causal, rate in WGMMA_BWD_CARD_CASES:
        q, k, v, do = (torch.from_numpy(x).cuda().bfloat16()
                       for x in _inputs(shape, seed=8))
        scale = 1.0 / math.sqrt(shape[-1])
        args = (causal, scale, rate, (5 << 32) + 99)
        o, lse = tfa.flash_attention_fwd(q, k, v, *args)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
            .reshape(lse.shape).contiguous()
        got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args)
        got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, *args),)
        want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                               *args)
        want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                *args),)
        torch.cuda.synchronize()
        for a, b_ in zip(got, want):
            _held_bf16(a, b_)
        if rate > 0:
            chip_smoke.check_masks(tfa, shape, torch.bfloat16, causal,
                                   args[-1], rate)


# -- the wgmma backward's keep bits, lane by lane ------------------------------
# A model of where csrc/philox.cuh keep_bits_rows (the wgmma dQ) and
# keep_bits_cols (the wgmma dK/dV) put each score's keep bit: which lane
# draws which Philox call (cell, q row, q-head row), how the words become
# one register of bits (bit 4 j + e: element e of 8-column n-tile j), and,
# in dK/dV, the lane pair's one shuffle.  The mask it reassembles must be
# dropout_keep's, so that the kernels' bits stay the forward's.
WIDE_DIMS = (24, 40, 80, 160, 200)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_head_dims_match_pallas_interpret(d, causal):
    """o, lse and dq / dk / dv of the plain versions against the Pallas
    forward and ``_bwd_call`` in interpret mode at head dims 24-200, GQA
    2:1, S 128: o and lse within 2e-5, the gradients within 2e-4."""
    shape = b, s_q, s_k, hq, hkv, _ = (1, 128, 128, 2, 1, d)
    q, k, v, do = _inputs(shape, seed=20 + d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = _rows(q), _rows(k), _rows(v)
    jo, jlse = jfa.flash_attention_fwd_kernel_call(
        jq, jk, jv, causal, scale, interpret=True, n_q_heads=hq,
        n_kv_heads=hkv)
    jdq, jdk, jdv = jax.block_until_ready(jfa._bwd_call(
        (jq, jk, jv, jo, jlse), _rows(do), causal, scale, True,
        n_q_heads=hq, n_kv_heads=hkv))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    before = _counts()
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, scale)
    dq, dk, dv = tfa._bwd_call((tq, tk, tv, o, lse), tdo, causal, scale)
    assert _counts() == before
    np.testing.assert_allclose(o.numpy(), _bshd(jo, b), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b), **BWD_TOL)


def test_segments_at_head_dim_40_match_pallas_interpret():
    """The segment branch at head dim 40 (SD-1.5's level 0): the JAX
    suite's ids [0]*100 + [1]*156 at S 256, o and lse of the plain forward
    and dq / dk / dv of the plain backward against the Pallas kernels in
    interpret mode."""
    b, s, h, d = 1, 256, 2, 40
    q, k, v, do = _inputs((b, s, s, h, h, d), seed=15)
    seg = _two_segments(b, s, 100)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = _rows(q), _rows(k), _rows(v)
    jseg = jnp.asarray(seg, jnp.float32)
    jo, jlse = jfa.flash_attention_fwd_kernel_call(
        jq, jk, jv, False, scale, interpret=True, n_q_heads=h,
        n_kv_heads=h, segment_ids=jseg)
    jdq, jdk, jdv = jax.block_until_ready(jfa._bwd_call(
        (jq, jk, jv, jo, jlse), _rows(do), False, scale, True,
        n_q_heads=h, n_kv_heads=h, segment_ids=jseg))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, False, scale,
                                     segment_ids=tseg)
    dq, dk, dv = tfa._bwd_call((tq, tk, tv, o, lse), tdo, False, scale,
                               segment_ids=tseg)
    np.testing.assert_allclose(o.numpy(), _bshd(jo, b), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b), **BWD_TOL)


def test_dropout_at_head_dim_160_matches_jax_masked_formula():
    """The dropout branch at head dim 160 (SD-1.5's level 2), rate 0.1,
    causal, GQA 2:1: the op against ``jax.vjp`` of JAX's masked formula
    under the port's mask, o within 2e-5, the gradients within 1e-4 of
    each tensor's max |grad|."""
    rate, seed, causal = 0.1, 4321, True
    shape = (1, 128, 128, 2, 1, 160)
    q, k, v, do = _inputs(shape, seed=16)
    factor = _factor(seed, shape, rate)
    jout, vjp = jax.vjp(
        lambda a, b_, c: _jax_masked_attention(a, b_, c, factor, causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate,
                              dropout_seed=seed)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_head_width_map_covers_every_head_dim_jax_takes():
    """Every D that JAX's ``_supported`` takes (a multiple of 8 up to 256)
    has a compiled width: the narrowest of ``HEAD_WIDTHS`` that holds it
    (40 at 48, not 64; 80 and 160 at their own), a multiple of 16 (an
    mma.sync k-step); the wrapper's check takes it, and refuses the head
    dims JAX declines.  Every width has one library (``_build``'s
    ``WIDTH_LIBRARIES``: the source's default ``FA_TU_WIDTHS``, and one
    library for each other width), and the map is the one the CUDA
    dispatch (``fa_width``) computes."""
    import re
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    csrc = Path(tfa.__file__).parent / "csrc"
    macro, own, more = _build.WIDTH_LIBRARIES["flash_attention"]
    default = re.search(rf"#define {macro} ([\d, ]+)\n",
                        (csrc / "flash_attention.cu").read_text()).group(1)
    assert tuple(int(w) for w in default.split(",")) == own
    compiled = {w: _build.width_library("flash_attention", w)
                for w in own + more}
    assert sorted(compiled) == list(tfa.HEAD_WIDTHS)
    assert len(set(compiled.values())) == 1 + len(more)
    assert set(compiled.values()) <= set(_build._sources(csrc))
    header = (csrc / "flash_attention.cuh").read_text()
    body = header[header.index("inline constexpr int fa_width"):]
    cuts = [(int(a), int(b)) for a, b in
            re.findall(r"d <= (\d+)\s+\? (\d+)", body[:600])]
    assert cuts == [(w, w) for w in tfa.HEAD_WIDTHS[:-1]]
    for d in range(1, 300):
        q_shape = (1, 128, 2, d)
        takes = jfa._supported(q_shape, q_shape)
        w = tfa.head_width(d)
        assert (w is not None) == takes, d
        t = torch.zeros((1, 1, 1, d))
        if takes:
            assert w >= d and w % 16 == 0
            assert w == min(x for x in tfa.HEAD_WIDTHS if x >= d)
            assert tfa._check("fwd", (t, t, t)) == t.device
        else:
            with pytest.raises(ValueError, match="head dim"):
                tfa._check("fwd", (t, t, t))
    assert [tfa.head_width(d) for d in (8, 40, 56, 80, 112, 160, 200)] \
        == [32, 48, 64, 80, 128, 160, 256]


@pytest.mark.cuda
def test_head_dim_kernels_match_plain_versions_on_card():
    """Rows 3/5/6 at every compiled width (off-width head dims included),
    bf16 and f32, causal and not, one GQA case, and the dropout and
    segment branches at head dims 40 and 160, against their plain versions
    on the card under the tolerances of ``chip_smoke.py`` phase 2e."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    chip_smoke.head_dim_checks(tfa, torch.Generator("cuda").manual_seed(0))
