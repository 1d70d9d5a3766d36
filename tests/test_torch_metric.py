"""Port parity of ``paddle_tpu_torch.metric`` against the JAX package's on
the same numpy inputs: ``Accuracy`` (top 1 and 5, labels [N] and [N, 1]),
``Precision``, ``Recall``, ``Auc`` and ``accuracy``, every update's return
and the accumulated values equal to 1e-7; a bf16 tensor is read as f32."""
import numpy as np
import pytest
import torch

from paddle_tpu import metric as jm
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import metric as tm


def _batches(n=3, rows=16, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, classes)).astype(np.float32),
             rng.integers(0, classes, (rows, 1)).astype(np.int64))
            for _ in range(n)]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=1e-7)


@pytest.mark.parametrize("topk", [(1,), (1, 5)])
def test_accuracy_matches_jax(topk):
    j, t = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    for i, (p, y) in enumerate(_batches()):
        lab = y if i % 2 else y[:, 0]
        jc = j.compute(Tensor(p), Tensor(lab))
        tc = t.compute(torch.from_numpy(p), torch.from_numpy(lab))
        _close(tc.numpy(), np.asarray(jc._value))
        _close(t.update(tc), j.update(jc))
    _close(t.accumulate(), j.accumulate())
    assert t.name() == j.name() == "acc"


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(name):
    rng = np.random.default_rng(1)
    j, t = getattr(jm, name)(), getattr(tm, name)()
    for _ in range(3):
        p = rng.random((32, 2) if name == "Auc" else (32,)).astype(np.float32)
        y = rng.integers(0, 2, (32,)).astype(np.int64)
        j.update(Tensor(p), Tensor(y))
        t.update(torch.from_numpy(p), torch.from_numpy(y))
    _close(t.accumulate(), j.accumulate())
    j.reset()
    t.reset()
    _close(t.accumulate(), j.accumulate())


def test_accuracy_function_and_bf16():
    p, y = _batches(1, rows=64)[0]
    for k in (1, 3):
        _close(tm.accuracy(torch.from_numpy(p), torch.from_numpy(y), k=k),
               np.asarray(jm.accuracy(Tensor(p), Tensor(y), k=k)._value))
    pb = torch.from_numpy(p).bfloat16()
    c = tm.Accuracy().compute(pb, torch.from_numpy(y))
    _close(c.numpy(), tm.Accuracy().compute(pb.float(),
                                            torch.from_numpy(y)).numpy())
