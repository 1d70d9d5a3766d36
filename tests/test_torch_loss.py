"""Port parity of ``nn.functional.cross_entropy`` / ``nn.CrossEntropyLoss``
and of the in-place ``nn.functional.softmax_`` against the JAX package's on
the same numpy inputs: class weights, ``ignore_index``, every
``reduction``, soft labels, another class ``axis``, label smoothing and
probabilities (``use_softmax=False``) — values and input gradients within
1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn import functional as TF

rng = np.random.default_rng(0)
LOGITS = rng.standard_normal((6, 5)).astype(np.float32)
LABELS = np.array([0, 4, -100, 2, 1, 3], np.int64)
SOFT = rng.random((6, 5)).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
WEIGHT = rng.random(5).astype(np.float32) + 0.5
AXIS1 = rng.standard_normal((2, 5, 3)).astype(np.float32)
AXIS1_LAB = rng.integers(0, 5, (2, 3)).astype(np.int64)

CASES = {
    "mean": (LOGITS, LABELS, {}),
    "sum": (LOGITS, LABELS, dict(reduction="sum")),
    "none": (LOGITS, LABELS, dict(reduction="none")),
    "weight_mean": (LOGITS, LABELS, dict(weight=WEIGHT)),
    "weight_none": (LOGITS, LABELS, dict(weight=WEIGHT, reduction="none")),
    "labels_n1": (LOGITS, np.abs(LABELS[:, None]) % 5, {}),
    "ignore_index_4": (LOGITS, LABELS % 5, dict(ignore_index=4)),
    "smoothing": (LOGITS, LABELS, dict(label_smoothing=0.1)),
    "soft": (LOGITS, SOFT, dict(soft_label=True)),
    "soft_weight_smoothing": (LOGITS, SOFT, dict(
        soft_label=True, weight=WEIGHT, label_smoothing=0.2)),
    "axis1": (AXIS1, AXIS1_LAB, dict(axis=1)),
    "probabilities": (np.abs(LOGITS) / np.abs(LOGITS).sum(-1, keepdims=True),
                      LABELS % 5, dict(use_softmax=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cross_entropy_matches_jax(name):
    x, lab, kw = CASES[name]
    jkw = dict(kw)
    if "weight" in kw:
        jkw["weight"] = Tensor(jnp.asarray(kw["weight"]))

    def jloss(v):
        out = JF.cross_entropy(Tensor(v), Tensor(jnp.asarray(lab)), **jkw)
        return out._value

    jv = np.asarray(jloss(jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jloss(v)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tkw = dict(kw)
    if "weight" in kw:
        tkw["weight"] = torch.from_numpy(kw["weight"])
    tv = TF.cross_entropy(tx, torch.from_numpy(lab), **tkw)
    (tg,) = torch.autograd.grad(tv.sum(), tx)
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-6)
    layer = CrossEntropyLoss(**tkw)
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x), torch.from_numpy(lab)).numpy(),
        tv.detach().numpy())


@pytest.mark.parametrize("axis,dtype", [(-1, None), (0, None),
                                        (-1, "float64")])
def test_softmax_in_place_matches_jax(axis, dtype):
    x = rng.standard_normal((4, 7)).astype(np.float32)
    jt = Tensor(jnp.asarray(x))
    JF.softmax_(jt, axis=axis, dtype=dtype)
    tt = torch.from_numpy(x.copy())
    out = TF.softmax_(tt, axis=axis, dtype=dtype)
    assert out is tt
    assert str(tt.dtype).endswith(dtype or "float32")
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt._value), rtol=0,
                               atol=1e-7)
    # the kernels' knobs on: a CPU tensor takes the kernel's plain version
    tk = torch.from_numpy(x.copy())
    TF.softmax_(tk, norm_kernels=True)
    np.testing.assert_allclose(tk.numpy(), torch.softmax(
        torch.from_numpy(x), -1).numpy(), rtol=0, atol=1e-6)
