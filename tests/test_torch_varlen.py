"""Port parity of ``nn.functional.flash_attn_unpadded`` (packed varlen
attention, ``[total, H, D]`` with cumulative boundaries) against the JAX
package's, on the CPU at f32.  The same numpy inputs feed both; on the CPU
the JAX side runs its block-diagonal plain path (no Pallas kernel is
registered there), and the port either the flash-attention op with segment
ids (its kernel route, through the kernels' plain versions) or the same
block-diagonal plain path.  Tolerances are the JAX suite's
(``test_pallas_kernels.py:252``): 2e-4 relative, 2e-5 absolute."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-5)
H, D = 2, 32


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops, as on a CPU where no Pallas
    override is registered, even after an earlier test on this worker
    registered them: a registered ``flash_attention_varlen`` override would
    call a Pallas kernel outside interpret mode."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


def _packed(lens_q, lens_k, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((sum(lens_q), H, D)).astype(np.float32)
    k = r.standard_normal((sum(lens_k), H, D)).astype(np.float32)
    v = r.standard_normal((sum(lens_k), H, D)).astype(np.float32)
    cu_q = np.cumsum([0] + lens_q).astype(np.int32)
    cu_k = np.cumsum([0] + lens_k).astype(np.int32)
    return q, k, v, cu_q, cu_k


def _both(lens_q, lens_k, seed, **kw):
    q, k, v, cu_q, cu_k = _packed(lens_q, lens_k, seed)
    jout, none = JF.flash_attn_unpadded(
        *(paddle.to_tensor(x) for x in (q, k, v, cu_q, cu_k)),
        max(lens_q), max(lens_k), **kw)
    assert none is None
    tout, none = TF.flash_attn_unpadded(
        *(torch.from_numpy(x) for x in (q, k, v, cu_q, cu_k)),
        max(lens_q), max(lens_k), **kw)
    assert none is None
    return tout, np.asarray(jout.numpy())


class _NoPlainPath:
    """Within the block, the block-diagonal plain path raises."""

    def __enter__(self):
        self.saved = tattn._sdpa_ref

        def refused(*a, **kw):
            raise AssertionError("the plain path ran")
        tattn._sdpa_ref = refused

    def __exit__(self, *exc):
        tattn._sdpa_ref = self.saved


@pytest.mark.parametrize("causal", [False, True])
def test_short_packed_sequences_match_jax(causal):
    """The JAX suite's case, lens [5, 9, 4]: 18 tokens is below the
    kernels' tile, so both packages take the block-diagonal plain path."""
    tout, jout = _both([5, 9, 4], [5, 9, 4], seed=1, causal=causal)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


@pytest.mark.parametrize("lens", [[100, 60, 96], [5, 37, 300, 9, 61]],
                         ids=["256 tokens", "412 tokens (pad to tile)"])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_route_matches_jax(lens, causal):
    """Equal boundaries and no ``scale``: the port runs the flash-attention
    op with segment ids (the plain path must not run), on a tileable total
    and on one the op pads to the tile; against JAX's block-diagonal
    path."""
    before = tfa.flash_attention_fwd.launches
    with _NoPlainPath():
        tout, jout = _both(lens, lens, seed=2, causal=causal)
    assert tfa.flash_attention_fwd.launches == before
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


@pytest.mark.parametrize("case", ["scale", "unequal"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_route_matches_jax(case, causal):
    """A ``scale``, or q and k boundaries that differ (the kernel route
    needs equal ones), takes the block-diagonal plain path in both
    packages, with a per-sequence causal mask."""
    if case == "scale":
        tout, jout = _both([100, 60, 96], [100, 60, 96], seed=3,
                           causal=causal, scale=0.1)
    else:
        tout, jout = _both([3, 7, 5], [4, 7, 9], seed=4, causal=causal)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


def test_dropout_draws_from_the_explicit_generators():
    """In training with dropout the kernel route draws its seed from the
    host ``seed_generator`` and the plain route its mask from
    ``generator``: equal generator states give equal outputs, the mask
    moves the output, and a route without its generator raises."""
    q, k, v, cu, _ = (torch.from_numpy(x) for x in
                      _packed([100, 60, 96], [100, 60, 96], seed=5))
    args = (q, k, v, cu, cu, 100, 100)
    runs = [TF.flash_attn_unpadded(
        *args, dropout=0.1, seed_generator=torch.Generator().manual_seed(7))[0]
        for _ in range(2)]
    assert torch.equal(*runs)
    assert not torch.allclose(runs[0], TF.flash_attn_unpadded(*args)[0])
    plain = [TF.flash_attn_unpadded(
        *args, dropout=0.1, scale=0.2,
        generator=torch.Generator().manual_seed(7))[0] for _ in range(2)]
    assert torch.equal(*plain)
    with pytest.raises(ValueError):
        TF.flash_attn_unpadded(*args, dropout=0.1)
    with pytest.raises(ValueError):
        TF.flash_attn_unpadded(*args, dropout=0.1, scale=0.2)
    evaluated = TF.flash_attn_unpadded(*args, dropout=0.1, training=False)[0]
    assert torch.equal(evaluated, TF.flash_attn_unpadded(*args)[0])
