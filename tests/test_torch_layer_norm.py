"""Port parity: paddle_tpu_torch.ops.fused LayerNorm against the JAX
package's Pallas LayerNorm kernels (``fused.layer_norm(...,
interpret=True)``) on the CPU at f32, with the JAX suite's tolerances: out
1e-5, dx, dw and db 2e-4 against ``jax.vjp``; and the port's
``nn.functional.layer_norm`` against the JAX one with the norm kernels off
(``layer_norm_ref``).  On CPU tensors the wrappers run their plain
versions, so the kernel launch counters must not move."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional.norm import layer_norm_ref as jlayer_norm_ref
from paddle_tpu_torch.nn.functional import norm as tnorm
from paddle_tpu_torch.ops import fused as tfu

jfu = importlib.import_module("paddle_tpu.ops.pallas.fused")

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
EPS = 1e-5


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = r.standard_normal(shape[-1:]).astype(np.float32)
    b = r.standard_normal(shape[-1:]).astype(np.float32)
    g = r.standard_normal(shape).astype(np.float32)
    return x, w, b, g


def _counts():
    return tfu.layer_norm_fwd.launches, tfu.layer_norm_bwd.launches


@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 256), (32, 768)],
                         ids=["16x128", "2x8x256", "32x768"])
def test_forward_and_vjp_match_pallas_interpret(shape):
    x, w, b, g = _inputs(shape, seed=1)
    jout, vjp = jax.vjp(
        lambda a, c, d: jfu.layer_norm(a, c, d, eps=EPS, interpret=True),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    before = _counts()
    out = tfu.layer_norm(tx, tw, tb, EPS)
    out.backward(torch.from_numpy(g))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    for got, want in ((tx.grad, jdx), (tw.grad, jdw), (tb.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


def test_fwd_and_bwd_entries_against_jax_ref():
    """The two kernel entries directly: out, mu and inv from the forward,
    then dx, dw and db from (x, w, mu, inv, g), against the JAX
    ``layer_norm_ref`` and its ``jax.vjp``, and mu / inv against float64."""
    x, w, b, g = _inputs((64, 256), seed=2)
    tx, tw, tb, tg = (torch.from_numpy(a) for a in (x, w, b, g))
    out, mu, inv = tfu.layer_norm_fwd(tx, tw, tb, EPS)
    jout, vjp = jax.vjp(lambda a, c, d: jlayer_norm_ref(a, c, d, 1, EPS),
                        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mu.numpy(), x64.mean(-1), **FWD_TOL)
    np.testing.assert_allclose(inv.numpy(), 1 / np.sqrt(x64.var(-1) + EPS),
                               **FWD_TOL)
    dx, dw, db = tfu.layer_norm_bwd(tx, tw, mu, inv, tg)
    for got, want in zip((dx, dw, db), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


@pytest.mark.parametrize("shape", [(4, 100), (6, 128), (8, 64), (128,)])
def test_untileable_returns_none_where_jax_does(shape):
    h = shape[-1]
    j_none = jfu.layer_norm(jnp.zeros(shape), jnp.ones(h), jnp.zeros(h),
                            interpret=True) is None
    t_none = tfu.layer_norm(torch.zeros(shape), torch.ones(h),
                            torch.zeros(h)) is None
    assert j_none and t_none


@pytest.mark.parametrize("norm_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functional_layer_norm_matches_jax(dtype, norm_kernels):
    """The port's ``nn.functional.layer_norm`` against the JAX
    ``layer_norm_ref`` (what the JAX dispatch runs with the norm kernels
    off).  At bf16 the norm-kernel path rounds once from f32 where
    ``layer_norm_ref`` rounds x-hat first and then multiplies in bf16, so
    there the two agree to bf16 rounding; f32 and the flag-off bf16 path
    agree to f32 rounding."""
    x, w, b, _ = _inputs((4, 8, 128), seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jlayer_norm_ref(
        jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
        jnp.asarray(b).astype(jd), 1, EPS).astype(jnp.float32))
    before = _counts()
    got = tnorm.layer_norm(
        torch.from_numpy(x).to(td), 128, torch.from_numpy(w).to(td),
        torch.from_numpy(b).to(td), EPS, norm_kernels=norm_kernels)
    assert _counts() == before and got.dtype == td
    tol = FWD_TOL if dtype == "float32" or not norm_kernels \
        else dict(rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_functional_layer_norm_without_weight_and_over_two_axes():
    """A bias without a weight (the weight becomes ones, as in JAX) and a
    LayerNorm over the last two axes (plain in both packages)."""
    from paddle_tpu.nn.functional.norm import layer_norm as jln
    import paddle_tpu as paddle
    x, _, b, _ = _inputs((2, 4, 128), seed=4)
    want = jln(paddle.to_tensor(x), 128, None, paddle.to_tensor(b), EPS)
    got = tnorm.layer_norm(torch.from_numpy(x), 128, None,
                           torch.from_numpy(b), EPS, norm_kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               **FWD_TOL)
    want = jln(paddle.to_tensor(x), [4, 128], epsilon=EPS)
    got = tnorm.layer_norm(torch.from_numpy(x), (4, 128), epsilon=EPS,
                           norm_kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               **FWD_TOL)


def test_bf16_rows_keep_their_dtypes():
    """bf16 x, w and b: out and dx in bf16, dw and db in the parameters'
    dtype, within bf16 rounding of the f32 computation."""
    x, w, b, g = _inputs((16, 128), seed=5)
    tx, tw, tb = (torch.from_numpy(a).bfloat16().requires_grad_(True)
                  for a in (x, w, b))
    out = tfu.layer_norm(tx, tw, tb, EPS)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == tx.grad.dtype == tw.grad.dtype == tb.grad.dtype \
        == torch.bfloat16
    ref, _, _ = tfu.layer_norm_fwd_ref(tx.detach().float(),
                                       tw.detach().float(),
                                       tb.detach().float(), EPS)
    torch.testing.assert_close(out.float(), ref, rtol=1.6e-2, atol=1.6e-2)


@pytest.mark.parametrize("shape", [(64, 768), (16, 1024)],
                         ids=["64x768", "16x1024"])
def test_library_backward_is_the_plain_versions_function(shape):
    """``aten.native_layer_norm_backward``, which ``chip_smoke.py`` times as
    the backward kernel's library yardstick, computes the function of
    :func:`layer_norm_bwd_ref` (dx, dw and db from the same x, w, mu, inv
    and g): f32, to 1e-5."""
    x, w, b, g = (torch.from_numpy(a) for a in _inputs(shape, seed=7))
    n, h = shape
    _, mu, inv = tfu.layer_norm_fwd_ref(x, w, b, EPS)
    got = torch.ops.aten.native_layer_norm_backward(
        g, x, [h], mu.view(n, 1), inv.view(n, 1), w, b, [True, True, True])
    for a, c in zip(got, tfu.layer_norm_bwd_ref(x, w, mu, inv, g)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


def _held_bf16(got, want):
    """A bf16 kernel output against its plain version, as ``chip_smoke.py``
    holds it: elementwise within 2e-3 + 1.6e-2 |plain|, and each row within
    1.6e-2 of its plain norm."""
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= 2e-3 + 1.6e-2 * want.abs()).all())
    rows = (got - want).reshape(-1, want.shape[-1]).norm(dim=-1)
    assert bool((rows <= 1.6e-2 * want.reshape(rows.shape[0], -1)
                 .norm(dim=-1)).all())


# (N, H, x dtype, w dtype) on the card beyond the f32 rows: the backward's
# register pass at ERNIE's rows and at H = 1,024, N off its grid's row runs
# (with f32 w) and below a block's 8 rows, and its general loop (H = 1,000
# and 4,096)
CARD_CASES = [(32768, 768, torch.bfloat16, torch.bfloat16),
              (4096, 1024, torch.bfloat16, torch.bfloat16),
              (16411, 768, torch.bfloat16, torch.float32),
              (5, 768, torch.bfloat16, torch.bfloat16),
              (4096, 1000, torch.bfloat16, torch.bfloat16),
              (2048, 4096, torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    x, w, b, g = (torch.from_numpy(a).cuda() for a in _inputs((1000, 384), 6))
    before = _counts()
    out, mu, inv = tfu.layer_norm_fwd(x, w, b, EPS)
    rout, rmu, rinv = tfu.layer_norm_fwd_ref(x, w, b, EPS)
    dx, dw, db = tfu.layer_norm_bwd(x, w, mu, inv, g)
    rdx, rdw, rdb = tfu.layer_norm_bwd_ref(x, w, mu, inv, g)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1)
    for a, c in ((out, rout), (mu, rmu), (inv, rinv), (dx, rdx)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
    # dw and db sum 1000 rows in another order than torch.sum
    for a, c in ((dw, rdw), (db, rdb)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-4)
    for n, h, dt, wdt in CARD_CASES:
        x, w, b, g = _inputs((n, h), 8)
        x, g = (torch.from_numpy(a).cuda().to(dt) for a in (x, g))
        w, b = (torch.from_numpy(a).cuda().to(wdt) for a in (1 + 0.1 * w,
                                                            0.1 * b))
        out, mu, inv = tfu.layer_norm_fwd(x, w, b, EPS)
        rout, _, _ = tfu.layer_norm_fwd_ref(x, w, b, EPS)
        dx, dw, db = tfu.layer_norm_bwd(x, w, mu, inv, g)
        rdx, rdw, rdb = tfu.layer_norm_bwd_ref(x, w, mu, inv, g)
        torch.cuda.synchronize()
        _held_bf16(out, rout)
        _held_bf16(dx, rdx)
        for a, c in ((dw, rdw), (db, rdb)):
            if wdt == torch.bfloat16:
                _held_bf16(a, c)
            else:
                torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-4)
