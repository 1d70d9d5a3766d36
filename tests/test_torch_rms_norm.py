"""Port parity: paddle_tpu_torch.ops.fused RMSNorm against the JAX package's
Pallas RMSNorm kernels (``fused.rms_norm(..., interpret=True)``) on the CPU
at f32, with the JAX suite's tolerances: out 2e-5, dx and dw 2e-4 against
``jax.vjp``.  On CPU tensors the wrappers run their plain versions, so the
kernel launch counters must not move."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.nn.functional.norm import rms_norm_ref
from paddle_tpu_torch.ops import fused as tfu

jfu = importlib.import_module("paddle_tpu.ops.pallas.fused")

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
EPS = 1e-5


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32)
    w = r.standard_normal(shape[-1:]).astype(np.float32)
    g = r.standard_normal(shape).astype(np.float32)
    return x, w, g


def _counts():
    return tfu.rms_norm_fwd.launches, tfu.rms_norm_bwd.launches


@pytest.mark.parametrize("shape", [(32, 256), (2, 8, 128), (16, 1024)],
                         ids=["32x256", "2x8x128", "16x1024"])
def test_forward_and_vjp_match_pallas_interpret(shape):
    x, w, g = _inputs(shape, seed=1)
    jout, vjp = jax.vjp(
        lambda a, b: jfu.rms_norm(a, b, eps=EPS, interpret=True),
        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    before = _counts()
    out = tfu.rms_norm(tx, tw, EPS)
    out.backward(torch.from_numpy(g))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **BWD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **BWD_TOL)


def test_fwd_and_bwd_entries_against_jax_ref():
    """The two kernel entries directly: out and inv from the forward, then
    dx and dw from (x, w, inv, g), against the JAX ``rms_norm_ref`` and its
    ``jax.vjp``."""
    from paddle_tpu.nn.functional.norm import rms_norm_ref as jref
    x, w, g = _inputs((64, 128), seed=2)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    out, inv = tfu.rms_norm_fwd(tx, tw, EPS)
    jout, vjp = jax.vjp(lambda a, b: jref(a, b, EPS), jnp.asarray(x),
                        jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    want_inv = 1.0 / np.sqrt((x.astype(np.float64) ** 2).mean(-1) + EPS)
    np.testing.assert_allclose(inv.numpy(), want_inv, **FWD_TOL)
    dx, dw = tfu.rms_norm_bwd(tx, tw, inv, tg)
    jdx, jdw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **BWD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **BWD_TOL)


@pytest.mark.parametrize("shape", [(4, 100), (6, 128), (8, 64)])
def test_untileable_returns_none_where_jax_does(shape):
    jx = jnp.zeros(shape)
    j_none = jfu.rms_norm(jx, jnp.zeros(shape[-1:]), interpret=True) is None
    t_none = tfu.rms_norm(torch.zeros(shape), torch.zeros(shape[-1:])) is None
    assert j_none == t_none


def test_bf16_rows_keep_their_dtypes():
    """bf16 x and w: out and dx in bf16, dw in w's dtype, all within bf16
    rounding of the f32 computation."""
    x, w, g = _inputs((16, 128), seed=3)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tw = torch.from_numpy(w).bfloat16().requires_grad_(True)
    out = tfu.rms_norm(tx, tw, EPS)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    ref = rms_norm_ref(tx.detach().float(), tw.detach().float(), EPS)
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)


def _held_bf16(got, want):
    """A bf16 kernel output against its plain version, as ``chip_smoke.py``
    holds it: elementwise within 2e-3 + 1.6e-2 |plain|, and each row within
    1.6e-2 of its plain norm."""
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= 2e-3 + 1.6e-2 * want.abs()).all())
    rows = (got - want).reshape(-1, want.shape[-1]).norm(dim=-1)
    assert bool((rows <= 1.6e-2 * want.reshape(rows.shape[0], -1)
                 .norm(dim=-1)).all())


# (N, H, x dtype, w dtype) on the card beyond the f32 rows: the forward's
# and backward's register passes at H = 1,024 and 768, with N off the
# backward's row runs and below a block's 8 rows, and the general loops (H
# = 1,000 and 4,096; f32 x with bf16 w)
CARD_CASES = [(16411, 1024, torch.bfloat16, torch.bfloat16),
              (1003, 1024, torch.bfloat16, torch.float32),
              (4096, 768, torch.bfloat16, torch.bfloat16),
              (5, 1024, torch.bfloat16, torch.bfloat16),
              (4096, 1000, torch.bfloat16, torch.bfloat16),
              (1024, 4096, torch.bfloat16, torch.bfloat16),
              (1000, 1024, torch.float32, torch.bfloat16)]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x, w, g = (torch.from_numpy(a).cuda() for a in _inputs((1000, 384), 4))
    out, inv = tfu.rms_norm_fwd(x, w, EPS)
    rout, rinv = tfu.rms_norm_fwd_ref(x, w, EPS)
    dx, dw = tfu.rms_norm_bwd(x, w, inv, g)
    rdx, rdw = tfu.rms_norm_bwd_ref(x, w, inv, g)
    torch.cuda.synchronize()
    for a, b in ((out, rout), (inv, rinv), (dx, rdx)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # dw sums 1000 rows in another order than torch.sum
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-4)
    for n, h, dt, wdt in CARD_CASES:
        x, w, g = _inputs((n, h), 5)
        x, g = (torch.from_numpy(a).cuda().to(dt) for a in (x, g))
        w = torch.from_numpy(1 + 0.1 * w).cuda().to(wdt)
        out, inv = tfu.rms_norm_fwd(x, w, EPS)
        rout, rinv = tfu.rms_norm_fwd_ref(x, w, EPS)
        dx, dw = tfu.rms_norm_bwd(x, w, inv, g)
        rdx, rdw = tfu.rms_norm_bwd_ref(x, w, inv, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(inv, rinv, rtol=1e-5, atol=1e-5)
        if dt == torch.bfloat16:
            _held_bf16(out, rout)
            _held_bf16(dx, rdx)
        else:
            torch.testing.assert_close(out, rout, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-5)
        if wdt == torch.bfloat16:
            _held_bf16(dw, rdw)
        else:
            torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-4)
