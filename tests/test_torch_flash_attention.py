"""Port parity: paddle_tpu_torch.ops.flash_attention against the JAX
package's Pallas flash-attention kernels in interpret mode, on the CPU at
f32.  The same numpy inputs feed both packages; the JAX kernels take
[B*H, S, D] rows, the port [B, S, H, D].  Tolerances are the JAX suite's
own: o and lse 2e-5, gradients 2e-4, the lse repack exact.  On CPU
tensors the port's wrappers run their plain versions, so the kernel launch
counters must not move.  Segment ids (the varlen mask) and the pad-to-tile
path of long untileable sequences are held the same way."""
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", DROP_SHAPES, ids=DROP_IDS)
def test_dropout_matches_jax_masked_formula(shape, causal):
    """The differentiable op at rate 0.1 (the plain versions on the CPU)
    against ``jax.vjp`` of JAX's masked formula under the same mask,
    crossed through numpy: o within 2e-5, dq / dk / dv within 1e-4 of the
    tensor's max |grad|."""
    rate, seed = 0.1, 1234567
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, do = _inputs(shape, seed=8)
    factor = _factor(seed, shape, rate)
    jout, vjp = jax.vjp(
        lambda a, b_, c: _jax_masked_attention(a, b_, c, factor, causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = _counts()
    out = tfa.flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate,
                              dropout_seed=seed)
    out.backward(torch.from_numpy(do))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # the mask is not a no-op: o moved from the undropped output
    plain = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal)
    assert not torch.allclose(out.detach(), plain, atol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_lse_is_the_undropped_lse(causal):
    """Under dropout lse keeps the undropped p: the plain forward's lse at
    rate 0.1 equals the Pallas kernel's at rate 0 (interpret mode)."""
    shape = (1, 128, 256, 4, 2, 64)
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, _ = _inputs(shape, seed=9)
    scale = 1.0 / math.sqrt(d)
    _, jlse = jax.block_until_ready(jfa.flash_attention_fwd_kernel_call(
        _rows(q), _rows(k), _rows(v), causal, scale, interpret=True,
        n_q_heads=hq, n_kv_heads=hkv))
    _, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x)
                                       for x in (q, k, v)), causal, scale,
                                     dropout_rate=0.1, seed=77)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)


def test_dropout_rate_zero_is_the_undropped_path():
    """Rate 0 is bit-equal to no dropout, forward and gradients, in the op
    and in each plain version."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs((1, 128, 128, 4, 2, 64), seed=10))
    scale = 1.0 / 8.0
    a = tfa.flash_attention_fwd_ref(q, k, v, True, scale)
    b = tfa.flash_attention_fwd_ref(q, k, v, True, scale, 0.0, 99)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    delta = (do * a[0]).sum(-1).permute(0, 2, 1).reshape(a[1].shape)
    for fn in (tfa.flash_attention_bwd_dkv_ref,
               tfa.flash_attention_bwd_dq_ref):
        x = fn(q, k, v, do, a[1], delta, True, scale)
        y = fn(q, k, v, do, a[1], delta, True, scale, 0.0, 99)
        x, y = (x, y) if isinstance(x, tuple) else ((x,), (y,))
        assert all(torch.equal(i, j) for i, j in zip(x, y))
    grads = []
    for rate in (None, 0.0):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        kw = {} if rate is None else dict(dropout_rate=rate, dropout_seed=5)
        out = tfa.flash_attention(*ts, causal=True, **kw)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in ts])
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_dropout_rate_one_returns_zeros():
    """A rate of 1 or more returns zeros of q's shape, before the shape
    check (so an untileable shape gets zeros too), as JAX's op does."""
    for s in (128, 197):
        q = torch.randn(1, s, 2, 64)
        for rate in (1.0, 1.5):
            out = tfa.flash_attention(q, q, q, dropout_rate=rate)
            assert out is not None and torch.equal(out, torch.zeros_like(q))
    jq = jnp.ones((1, 197, 2, 64))
    assert not np.asarray(jfa.flash_attention(jq, jq, jq,
                                              dropout_rate=1.0)).any()


def test_dropout_seed_comes_from_the_host_generator():
    """A None seed is drawn from the explicit host generator: equal
    generator states give equal outputs, and successive calls differ; no
    generator, or one on another device, raises."""
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs((1, 128, 128, 2, 2, 64), seed=11))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    a = tfa.flash_attention(q, k, v, dropout_rate=0.1, generator=g1)
    b = tfa.flash_attention(q, k, v, dropout_rate=0.1, generator=g2)
    c = tfa.flash_attention(q, k, v, dropout_rate=0.1, generator=g1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="host"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)


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
def _nibbles(seed, cell, row, bhq, rate):
    """The 4 keep bits (bit i: word i >= the threshold) of the Philox calls
    at the broadcast int64 counters (cell, row, bhq, 0)."""
    words = tfa.philox4x32_10((cell, row, bhq, 0), tfa._seed_words(seed))
    thresh = tfa.dropout_threshold(rate)
    return sum((w >= thresh).long() << i for i, w in enumerate(words))


def _bit(bits, i):
    return ((bits >> i) & 1).bool()


def _wgmma_dq_keep(seed, bh, s_q, s_k, rate, bm, causal, bk=64):
    """keep [bh, s_q, s_k] as the wgmma dQ's (and forward's) lanes hold it,
    and the scores its tiles cover (key tiles of ``bk`` per block of ``bm``
    q rows).  A lane (g, t) of the warp whose 16 q rows start at ``r16``
    holds rows r16 + g and r16 + g + 8 and, per key tile at kcol0, keys
    kcol0 + 8 j + 2t + (e & 1); per 64-key chunk c of the tile it keeps one
    register of bits, in which per 16-key group kk it draws the calls
    (4 (kcol0 / 16 + 4 c + kk) + t, row + 8 r) and puts words x, y at bits
    8 kk + 2 r + (0, 1) and z, w at 8 kk + 4 + 2 r + (0, 1)."""
    n16, n_kt = -(-s_q // 16), -(-s_k // bk)
    bhq = torch.arange(bh)[:, None, None, None, None]
    row = (16 * torch.arange(n16)[:, None] + torch.arange(8))  # r16 + g
    row = row.reshape(-1)[None, :, None, None, None]
    t = torch.arange(4)[None, None, :, None, None]
    kt = torch.arange(n_kt)[None, None, None, :, None]
    keep = torch.zeros(bh, n16 * 16, n_kt * bk, dtype=torch.bool)
    for c in range(bk // 64):
        bits = torch.zeros(bh, row.shape[1], 4, n_kt, 1, dtype=torch.int64)
        for kk in range(4):
            for r in range(2):
                n = _nibbles(seed, (bk // 16 * kt + 4 * c + kk) * 4 + t,
                             row + 8 * r, bhq, rate)
                bits |= ((n & 3) | (n & 12) << 2) << (8 * kk + 2 * r)
        for j in range(8):
            for e in range(4):
                rows = (row + 8 * (e >> 1)).expand_as(bits)
                cols = (bk * kt + 64 * c + 8 * j + 2 * t + (e & 1)) \
                    .expand_as(bits)
                keep[torch.arange(bh)[:, None, None, None, None]
                     .expand_as(bits), rows, cols] = _bit(bits, 4 * j + e)
    plan = tfa.segment_tile_plan(None, s_q, s_k, bm, bk, causal)
    seen = (plan[0] != tfa.TILE_SKIP).repeat_interleave(bm, 0) \
        .repeat_interleave(bk, 1)[:s_q, :s_k]
    return keep[:, :s_q, :s_k], seen


def _wgmma_dkv_keep(seed, bh, s_q, s_k, rate, bq, causal):
    """keep [bh, s_q, s_k] as the wgmma dK/dV's lanes hold it, and the
    scores its tiles cover (64 keys per consumer, q tiles of ``bq``).  The
    fragment is transposed: a lane (g, t) of the warp whose 16 keys start
    at ``k16`` holds keys k16 + g and k16 + g + 8 and, per q tile at row0,
    q rows row0 + 8 j + 2t + (e & 1).  It draws the call (4 (k16 / 16) +
    g / 2, row0 + 8 j + 2t + (g & 1)) into nibble j of ``own``; the lane
    pair g, g ^ 1 swaps ``own`` in one shuffle; then element e of n-tile j
    is bit 4 j + e of ((a >> s) & 0x5..) | ((b >> s) & 0x5..) << 1, with a
    the nibbles of q row 2t, b of 2t + 1 and s = g & 1."""
    nq = bq // 8
    n16, n_qt = -(-s_k // 16), -(-s_q // bq)
    bhq = torch.arange(bh)[:, None, None, None, None]
    k16 = 16 * torch.arange(n16)[None, :, None, None, None]
    g = torch.arange(8)[None, None, :, None, None]
    t = torch.arange(4)[None, None, None, :, None]
    row0 = bq * torch.arange(n_qt)[None, None, None, None, :]
    odd = g & 1
    own = torch.zeros(bh, n16, 8, 4, n_qt, dtype=torch.int64)
    for j in range(nq):
        own |= _nibbles(seed, (k16 >> 4) * 4 + (g >> 1),
                        row0 + 2 * t + 8 * j + odd, bhq, rate) << (4 * j)
    other = own[:, :, torch.arange(8) ^ 1]                   # lane ^ 4
    a = torch.where(odd.bool(), other, own)
    b = torch.where(odd.bool(), own, other)
    m = 0x55555555
    bits = ((a >> odd) & m) | (((b >> odd) & m) << 1)
    keep = torch.zeros(bh, n_qt * bq, n16 * 16, dtype=torch.bool)
    for j in range(nq):
        for e in range(4):
            keys = (k16 + g + 8 * (e >> 1)).expand_as(bits)
            rows = (row0 + 8 * j + 2 * t + (e & 1)).expand_as(bits)
            keep[bhq.expand_as(bits), rows, keys] = _bit(bits, 4 * j + e)
    plan = tfa.segment_tile_plan(None, s_q, s_k, bq, 64, causal)
    seen = (plan[0] != tfa.TILE_SKIP).repeat_interleave(bq, 0) \
        .repeat_interleave(64, 1)[:s_q, :s_k]
    return keep[:, :s_q, :s_k], seen


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [40, 128, 256])
@pytest.mark.parametrize("s_q,s_k", [(200, 200), (136, 200)])
def test_wgmma_backward_keep_bits_are_dropout_keep(s_q, s_k, d, causal):
    """The keep bits of every lane of the wgmma dQ and dK/dV fragments
    (``_wgmma_dq_keep``, ``_wgmma_dkv_keep``: each body's tiles at head dim
    ``d``, ``tfa.segment_tiles``), reassembled into [rows, keys], equal
    ``dropout_keep`` on every score the tiles cover, and the tiles cover
    every visible score; lengths off the tile, causal and not."""
    rate, seed, bh = 0.1, (11 << 32) + 5, 2
    want = tfa.dropout_keep(seed, range(bh), range(s_q), range(s_k), rate)
    rows = torch.arange(s_q)[:, None]
    visible = rows + (s_k - s_q) >= torch.arange(s_k) if causal \
        else torch.ones(s_q, s_k, dtype=torch.bool)
    for which, model in (("bwd_dq", _wgmma_dq_keep),
                         ("bwd_dkv", _wgmma_dkv_keep)):
        bq, bk = tfa.segment_tiles(which, d)
        assert bk == 64
        keep, seen = model(seed, bh, s_q, s_k, rate, bq, causal)
        assert bool(seen[visible].all()), which
        seen = seen.expand_as(keep)
        assert torch.equal(keep[seen], want[seen]), which
        assert 0.85 < float(keep[seen].float().mean()) < 0.95


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("design", range(len(tfa.FWD_DESIGNS)))
@pytest.mark.parametrize("s_q,s_k", [(200, 200), (136, 200), (264, 264)])
def test_wgmma_forward_keep_bits_are_dropout_keep(s_q, s_k, design, causal):
    """The keep bits of every lane of the wgmma forward's fragment
    (``_wgmma_dq_keep`` at the design's q rows a block and keys a tile:
    64-key tiles in one register of bits, 128-key tiles in two), reassembled
    into [rows, keys], equal ``dropout_keep`` on every score the tiles
    cover, and the tiles cover every visible score; every design of
    ``tfa.FWD_DESIGNS`` (the segment branch's is design 0), lengths off the
    tile, causal and not."""
    rate, seed, bh = 0.1, (13 << 32) + 7, 2
    want = tfa.dropout_keep(seed, range(bh), range(s_q), range(s_k), rate)
    rows = torch.arange(s_q)[:, None]
    visible = rows + (s_k - s_q) >= torch.arange(s_k) if causal \
        else torch.ones(s_q, s_k, dtype=torch.bool)
    bq, bk, _ = tfa.FWD_DESIGNS[design]
    keep, seen = _wgmma_dq_keep(seed, bh, s_q, s_k, rate, bq, causal, bk)
    assert bool(seen[visible].all())
    seen = seen.expand_as(keep)
    assert torch.equal(keep[seen], want[seen])
    assert 0.85 < float(keep[seen].float().mean()) < 0.95


# (B, S_q, S_k, Hq, D, causal) of the forward's launches in 3c, 3d and
# 3h, S 200 (off the tile) causal and not at head dims 64 and 160, and
# 512 q tiles at head dims 192 and 256
FWD_TILE_LAUNCHES = [(8, 2048, 2048, 16, 64, True), (64, 512, 512, 12, 64,
                                                     False),
                     (8, 4096, 4096, 8, 40, False),
                     (8, 1024, 1024, 8, 80, False),
                     (8, 256, 256, 8, 160, False),
                     (2, 200, 200, 4, 64, True), (2, 200, 200, 4, 64, False),
                     (2, 200, 200, 4, 160, True),
                     (8, 1024, 1024, 8, 192, False),
                     (8, 1024, 1024, 8, 256, False)]
H100_SMS = 132


@pytest.mark.parametrize("launch", FWD_TILE_LAUNCHES,
                         ids=["3c", "3d", "3h-d40", "3h-d80", "3h-d160",
                              "S200-causal", "S200", "S200-d160-causal",
                              "d192", "d256"])
def test_forward_tiles_cover_every_q_tile_once_longest_first(launch):
    """The forward's tiles in every design (``tfa.FWD_DESIGNS``; the
    segment branch's, design 0, is ``segment_tiles("fwd", d)``) and the
    order its blocks take them at a launch (``tfa.fwd_tile_order``: a block
    per q tile, or a persistent grid of a block an SM walking them) cover
    every (batch x q-head row, q tile) exactly once, and the longest first:
    down the launch order and within each block the key tiles a q tile
    visits never grow."""
    b, s_q, s_k, hq, d, causal = launch
    assert tfa.FWD_DESIGNS[0][:2] == tfa.segment_tiles("fwd", d)
    for bq, bk, persistent in tfa.FWD_DESIGNS:
        n_qt = -(-s_q // bq)
        plan = tfa.segment_tile_plan(None, s_q, s_k, bq, bk, causal)[0]
        visits = (plan != tfa.TILE_SKIP).sum(1).tolist()
        for blocks in (None, H100_SMS) if persistent else (None,):
            order = tfa.fwd_tile_order(b * hq, s_q, bq, blocks)
            flat = [x for blk in order for x in blk]
            assert len(flat) == b * hq * n_qt
            assert set(flat) == {(r, qt) for r in range(b * hq)
                                 for qt in range(n_qt)}
            assert len(order) == (b * hq * n_qt if blocks is None
                                  else min(blocks, b * hq * n_qt))
            for blk in order:
                lens = [visits[qt] for _, qt in blk]
                assert lens == sorted(lens, reverse=True)
            launch_order = sorted(
                ((j + i * len(order), qt) for j, blk in enumerate(order)
                 for i, (_, qt) in enumerate(blk)), key=lambda x: x[0])
            lens = [visits[qt] for _, qt in launch_order]
            assert lens == sorted(lens, reverse=True)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dropout_mask_read_out_of_each_plain_version(causal):
    """The read-out ``chip_smoke.py`` applies to the kernels on the card,
    applied to the plain versions: one-hot inputs beside rate 0 give back
    every keep bit of o, dq, dk and dv, equal to ``dropout_keep``'s, with
    GQA (each q head of a group read alone through dK/dV) and lengths off
    the chunk."""
    for dt in (torch.float32, torch.bfloat16):
        n, kept = chip_smoke.check_masks(tfa, (2, 72, 136, 4, 2, 32), dt,
                                         causal, (3 << 32) + 17, 0.1, "cpu")
        assert n == 2 * 4 * (72 * 136 if not causal else
                             sum(min(136, i + 65) for i in range(72)))
        assert abs(kept - 0.9) <= 5 * (0.09 / n) ** 0.5


@pytest.mark.cuda
def test_dropout_kernels_match_plain_versions_on_card():
    """The dropout branch of the three kernels at rate 0.1 against their
    plain versions under the same seed, f32 (1e-5) and bf16 (as
    ``chip_smoke.py`` holds it), causal GQA and a key length off the tile;
    then the masks of all three kernels themselves, read out through
    one-hot inputs (``chip_smoke.check_masks``), equal to ``dropout_keep``
    bit for bit, bf16 and f32, causal and not, with GQA and lengths off the
    64-row tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rate, seed = 0.1, (3 << 32) + 17
    for dt in (torch.float32, torch.bfloat16):
        for shape, causal in (((2, 128, 128, 4, 2, 64), True),
                              ((1, 128, 200, 2, 2, 128), False)):
            q, k, v, do = (torch.from_numpy(x).cuda().to(dt)
                           for x in _inputs(shape, seed=12))
            scale = 1.0 / math.sqrt(shape[-1])
            args = (causal, scale, rate, seed)
            o, lse = tfa.flash_attention_fwd(q, k, v, *args)
            ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, *args)
            delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
                .reshape(lse.shape).contiguous()
            got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args)
            got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                               *args),)
            want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   *args)
            want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                                    *args),)
            torch.cuda.synchronize()
            torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
            if dt == torch.float32:
                for a, b_ in ((o, ro),) + tuple(zip(got, want)):
                    torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
            else:
                _held_bf16(o, ro, 2.0 ** -8 * tfa.flash_attention_fwd_ref(
                    q, k, v.abs(), *args)[0].float())
                for a, b_ in zip(got, want):
                    _held_bf16(a, b_)
    for shape in ((2, 136, 200, 8, 2, 64), (1, 128, 200, 4, 4, 128)):
        for dt in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                chip_smoke.check_masks(tfa, shape, dt, causal, seed, rate)


# -- segment ids (the varlen mask) and the pad-to-tile path -------------------
def _two_segments(b, s, first):
    """[B, S] int32 ids: ``first`` rows of segment 0, the rest segment 1
    (the JAX suite's packed pair)."""
    return np.concatenate([np.zeros(first), np.ones(s - first)])[None] \
        .repeat(b, 0).astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_forward_matches_pallas_interpret(causal):
    """The JAX suite's case (``test_pallas_kernels.py:214``): S 256, ids
    [0]*100 + [1]*156 (the boundary inside a tile), o and lse of the plain
    forward against ``flash_attention_fwd_kernel_call(segment_ids=...)``
    in interpret mode, and the op against the Pallas op, within 2e-5."""
    b, s, h, d = 2, 256, 2, 64
    q, k, v, _ = _inputs((b, s, s, h, h, d), seed=13)
    seg = _two_segments(b, s, 100)
    scale = 1.0 / math.sqrt(d)
    jo, jlse = jax.block_until_ready(jfa.flash_attention_fwd_kernel_call(
        _rows(q), _rows(k), _rows(v), causal, scale, interpret=True,
        n_q_heads=h, n_kv_heads=h,
        segment_ids=jnp.asarray(seg, jnp.float32)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = _counts()
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, scale,
                                     segment_ids=torch.from_numpy(seg))
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              segment_ids=torch.from_numpy(seg))
    assert _counts() == before
    np.testing.assert_allclose(o.numpy(), _bshd(jo, b), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    want = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=causal, interpret=True,
                               segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_backward_matches_pallas_interpret(causal):
    """dq / dk / dv of the plain backward versions with segment ids
    ([0]*48 + [1]*80, the JAX suite's gradient case) against ``_bwd_call``
    with the same ids in interpret mode at S 128, GQA 4:2, within 2e-4."""
    b, s, hq, hkv, d = 1, 128, 4, 2, 64
    q, k, v, do = _inputs((b, s, s, hq, hkv, d), seed=14)
    seg = _two_segments(b, s, 48)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = _rows(q), _rows(k), _rows(v)
    jseg = jnp.asarray(seg, jnp.float32)
    jo, jlse = jfa.flash_attention_fwd_kernel_call(
        jq, jk, jv, causal, scale, interpret=True, n_q_heads=hq,
        n_kv_heads=hkv, segment_ids=jseg)
    jdq, jdk, jdv = jax.block_until_ready(jfa._bwd_call(
        (jq, jk, jv, jo, jlse), _rows(do), causal, scale, True,
        n_q_heads=hq, n_kv_heads=hkv, segment_ids=jseg))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, scale,
                                     segment_ids=tseg)
    before = _counts()
    dq, dk, dv = tfa._bwd_call((tq, tk, tv, o, lse), tdo, causal, scale,
                               segment_ids=tseg)
    assert _counts() == before
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), _bshd(want, b), **BWD_TOL)


@pytest.mark.parametrize("with_ids", [False, True])
def test_pad_to_tile_equals_jax(with_ids):
    """``_pad_to_tile`` bit for bit against JAX's: q, k, v padded with zero
    rows to the next 128, the ids (zeros when none) as f32 with the padding
    in segment -1, and the unpadded length."""
    b, s, h, d = 2, 453, 2, 64
    q, k, v, _ = _inputs((b, s, s, h, h, d), seed=15)
    ids = np.random.default_rng(16).integers(0, 3, (b, s)).astype(np.int32) \
        if with_ids else None
    want = jfa._pad_to_tile(*(jnp.asarray(x) for x in (q, k, v)),
                            None if ids is None else jnp.asarray(ids))
    got = tfa._pad_to_tile(*(torch.from_numpy(x) for x in (q, k, v)),
                           None if ids is None else torch.from_numpy(ids))
    assert got[4] == want[4] == s
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].shape == (b, 512) and bool((got[3][:, s:] == -1).all())


@pytest.mark.parametrize("s", [390, 577])
def test_pad_to_tile_matches_jax_ref(s):
    """An untileable S >= 384 (390, and ViT-L/16's 577 at 384 px) takes the
    pad path through the plain versions: the output and the three
    gradients against ``jax.vjp`` of JAX's ``flash_attention_ref`` on the
    unpadded inputs, within 2e-5 and 2e-4."""
    b, h, d = 1, 2, 64
    q, k, v, do = _inputs((b, s, s, h, h, d), seed=17)
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention_ref(a, b_, c),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = _counts()
    out = tfa.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do))
    assert _counts() == before
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_segments_with_dropout_match_jax_masked_formula(causal):
    """Segment ids and dropout together (rate 0.1): the op against
    ``jax.vjp`` of JAX's masked formula with the same segments, fed the
    port's mask through numpy; o within 2e-5, gradients within 1e-4 of the
    tensor's max |grad|."""
    rate, seed = 0.1, 99991
    shape = (2, 128, 128, 4, 2, 32)
    q, k, v, do = _inputs(shape, seed=18)
    seg = np.random.default_rng(19).integers(0, 3, (2, 128)).astype(np.int32)
    seg.sort(axis=1)
    factor = _factor(seed, shape, rate)
    jout, vjp = jax.vjp(
        lambda a, b_, c: _jax_masked_attention(a, b_, c, factor, causal,
                                               jnp.asarray(seg)),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              segment_ids=torch.from_numpy(seg),
                              dropout_rate=rate, dropout_seed=seed)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for t, want in zip((tq, tk, tv), jgrads):
        want = np.asarray(want)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_segment_ids_need_equal_lengths():
    """As in JAX, segment ids with s_q != s_k give None from the op; the
    wrappers raise on ids of another shape."""
    q, k = torch.zeros((1, 128, 2, 64)), torch.zeros((1, 256, 2, 64))
    assert tfa.flash_attention(q, k, k, segment_ids=torch.zeros((1, 128))) \
        is None
    jq, jk = jnp.zeros((1, 128, 2, 64)), jnp.zeros((1, 256, 2, 64))
    assert jfa.flash_attention(jq, jk, jk, interpret=True,
                               segment_ids=jnp.zeros((1, 128))) is None


# (B, S, Hq, Hkv, D), causal, the segment lengths of each batch row
SEG_CARD_CASES = [((2, 256, 8, 8, 64), False, [100, 156]),
                  ((2, 256, 8, 2, 64), True, [100, 156]),
                  ((1, 320, 4, 4, 128), True, [64, 10, 118, 128]),
                  ((1, 512, 4, 4, 64), False, [5, 37, 300, 9, 161]),
                  ((2, 640, 4, 4, 64), False, [577, 63])]


@pytest.mark.cuda
def test_segment_kernels_match_plain_versions_on_card():
    """The segment branch of the forward and both backward kernels against
    their plain versions on the card, f32 (1e-5) and bf16 (as
    ``chip_smoke.py`` holds it), at rate 0 and 0.1: boundaries on and off
    the 64-row tile, a segment inside one tile, many short segments, GQA,
    causal and not, and the pad-to-tile shape (577 real rows of 640)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (b, s, hq, hkv, d), causal, lens in SEG_CARD_CASES:
        seg = torch.repeat_interleave(
            torch.arange(len(lens)), torch.tensor(lens))[None] \
            .repeat(b, 1).cuda()
        for dt in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                q, k, v, do = (torch.from_numpy(x).cuda().to(dt) for x in
                               _inputs((b, s, s, hq, hkv, d), seed=20))
                args = (causal, 1.0 / math.sqrt(d), rate, 4321, seg)
                o, lse = tfa.flash_attention_fwd(q, k, v, *args)
                ro, rlse = tfa.flash_attention_fwd_ref(q, k, v, *args)
                delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
                    .reshape(lse.shape).contiguous()
                got = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  *args)
                got += (tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                   *args),)
                want = tfa.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                       delta, *args)
                want += (tfa.flash_attention_bwd_dq_ref(q, k, v, do, lse,
                                                        delta, *args),)
                torch.cuda.synchronize()
                torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
                if dt == torch.float32:
                    for a, b_ in ((o, ro),) + tuple(zip(got, want)):
                        torch.testing.assert_close(a, b_, rtol=1e-5,
                                                   atol=1e-5)
                else:
                    _held_bf16(o, ro, 2.0 ** -8 * tfa.flash_attention_fwd_ref(
                        q, k, v.abs(), *args)[0].float())
                    for a, b_ in zip(got, want):
                        _held_bf16(a, b_)


# -- every head dim the JAX kernels take --------------------------------------
# head dims off and on the kernels' compiled widths (24 at 32, 40 at 48, 80,
# 160, 200 at 256), S <= 256
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
