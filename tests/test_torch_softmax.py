"""Port parity: paddle_tpu_torch.ops.fused softmax against the JAX
package's Pallas softmax kernels (``fused.softmax(..., interpret=True)``)
on the CPU at f32, with the JAX suite's tolerances: out rtol 1e-5 / atol
1e-6, dx rtol 1e-4 / atol 1e-5 against ``jax.vjp``.  On CPU tensors the
wrappers run their plain versions, so the kernel launch counters must not
move."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import fused as tfu

jfu = importlib.import_module("paddle_tpu.ops.pallas.fused")

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * 3).astype(np.float32)
    g = r.standard_normal(shape).astype(np.float32)
    return x, g


def _counts():
    return tfu.softmax_fwd.launches, tfu.softmax_bwd.launches


@pytest.mark.parametrize("shape", [(16, 256), (2, 4, 128), (8, 512)],
                         ids=["16x256", "2x4x128", "8x512"])
def test_forward_and_vjp_match_pallas_interpret(shape):
    x, g = _inputs(shape, seed=1)
    jout, vjp = jax.vjp(lambda a: jfu.softmax(a, interpret=True),
                        jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    before = _counts()
    out = tfu.softmax(tx)
    out.backward(torch.from_numpy(g))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **BWD_TOL)


def test_fwd_and_bwd_entries_against_jax_nn_softmax():
    """The two kernel entries directly against ``jax.nn.softmax`` and its
    ``jax.vjp``, with a row of large values (the max subtraction)."""
    x, g = _inputs((32, 384), seed=2)
    x[3] += 80.0
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    o = tfu.softmax_fwd(tx)
    jo, vjp = jax.vjp(lambda a: jax.nn.softmax(a, axis=-1), jnp.asarray(x))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    (jdx,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(tfu.softmax_bwd(o, tg).numpy(),
                               np.asarray(jdx), **BWD_TOL)


def _causal_masked(x):
    """x [N, H] with -inf above the diagonal of each H x H block of rows
    (row i sees columns <= i mod H), as masked attention scores come."""
    n, h = x.shape
    x = x.copy()
    x[np.arange(h)[None, :] > (np.arange(n) % h)[:, None]] = -np.inf
    return x


def test_masked_rows_match_pallas_interpret():
    """Rows holding -inf (a causal mask): the masked columns get exactly 0
    and their gradient 0, as in the Pallas kernels."""
    x, g = _inputs((256, 128), seed=5)
    x = _causal_masked(x)
    jout, vjp = jax.vjp(lambda a: jfu.softmax(a, interpret=True),
                        jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tfu.softmax(tx)
    out.backward(torch.from_numpy(g))
    assert bool((out[torch.from_numpy(np.isneginf(x))] == 0).all())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **BWD_TOL)


@pytest.mark.parametrize("shape", [(4, 100), (6, 128), (128,), (3, 2, 256)])
def test_untileable_returns_none_where_jax_does(shape):
    j_none = jfu.softmax(jnp.zeros(shape), interpret=True) is None
    t_none = tfu.softmax(torch.zeros(shape)) is None
    assert j_none and t_none


def test_bf16_rows_keep_their_dtype():
    x, g = _inputs((16, 256), seed=3)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    out = tfu.softmax(tx)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == tx.grad.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(),
                               torch.softmax(tx.detach().float(), -1),
                               rtol=1.6e-2, atol=2e-3)


@pytest.mark.parametrize("shape", [(64, 512), (16, 384)],
                         ids=["64x512", "16x384"])
def test_library_backward_is_the_plain_versions_function(shape):
    """``aten._softmax_backward_data``, which ``chip_smoke.py`` times as the
    backward kernel's library yardstick, computes the function of
    :func:`softmax_bwd_ref` (dx from the forward's output and g): f32, to
    1e-5."""
    x, g = (torch.from_numpy(a) for a in _inputs(shape, seed=8))
    o = tfu.softmax_fwd_ref(x)
    got = torch.ops.aten._softmax_backward_data(g, o, -1, torch.float32)
    torch.testing.assert_close(got, tfu.softmax_bwd_ref(o, g), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    xn, gn = _inputs((1000, 384), 4)
    g = torch.from_numpy(gn).cuda()
    # plain rows, and the same rows under a causal -inf mask
    for rows in (xn, _causal_masked(xn)):
        x = torch.from_numpy(rows).cuda()
        before = _counts()
        o = tfu.softmax_fwd(x)
        ro = tfu.softmax_fwd_ref(x)
        dx = tfu.softmax_bwd(o, g)
        rdx = tfu.softmax_bwd_ref(o, g)
        torch.cuda.synchronize()
        assert _counts() == (before[0] + 1, before[1] + 1)
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dx, rdx, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [512, 2048, 1002, 4096],
                         ids=["reg-512", "reg-2048", "loop-1002", "loop-4096"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_branches_match_plain_version_on_card(h, dtype):
    """Both forward branches — the register pass (rows of whole 16-byte
    vectors up to 2,048 long) and the looped kernel (1,002 is off both
    vector widths, 4,096 past the register pass) — against the plain
    version: a row that begins with -inf, and a row of -inf throughout,
    which gives NaN in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    xn, _ = _inputs((64, h), 7)
    xn[1, : h // 2] = -np.inf
    xn[2] = -np.inf
    x = torch.from_numpy(xn).cuda().to(dtype)
    before = _counts()
    o = tfu.softmax_fwd(x)
    ro = tfu.softmax_fwd_ref(x)
    torch.cuda.synchronize()
    assert _counts()[0] == before[0] + 1
    assert bool(o[2].isnan().all()) and bool(ro[2].isnan().all())
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=1.6e-2, atol=2e-3)
    keep = torch.arange(64, device="cuda") != 2
    torch.testing.assert_close(o[keep].float(), ro[keep].float(), **tol)
