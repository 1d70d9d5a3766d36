"""Data parallel across real processes (the counterpart of
``tests/test_launch_multiprocess.py:58`` and ``:161``): one gang of two
ranks on gloo (``tests/torch_launch_scripts/dp_rank.py``) trains the
linear model through ``DataParallel``'s gradient hooks and a small
network through ``hapi.Model``; the curves equal the single-process runs
of the same models on the full batch, in JAX and in the port."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_gang import start_gang


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gang's results, and while it runs the single-process curves:
    the linear model's in JAX and in the port, the hapi network's in
    JAX."""
    wait = start_gang("dp_rank.py", str(tmp_path_factory.mktemp("dp")))
    curves = (_jax_linear_curve(), _port_linear_curve(), _jax_hapi_curve())
    return wait(), curves


@pytest.fixture(scope="module")
def gang(runs):
    return runs[0]


@pytest.fixture(scope="module")
def curves(runs):
    return runs[1]


def _data():
    rng = np.random.default_rng(42)
    X = rng.normal(0, 1, (8, 4)).astype(np.float32)
    Y = (X @ np.arange(1, 5).astype(np.float32)[:, None] * 0.1)
    W0 = rng.normal(0, 0.1, (4, 1)).astype(np.float32)
    return X, Y, W0


def _jax_linear_curve():
    X, Y, W0 = _data()
    x, y, w = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(W0)

    def loss_fn(w):
        return jnp.mean(jnp.square(x @ w - y))

    out = []
    for _ in range(10):
        v, g = jax.value_and_grad(loss_fn)(w)
        w = w - 0.1 * g
        out.append(float(v))
    return out


def _port_linear_curve():
    X, Y, W0 = _data()
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    w = torch.from_numpy(W0.copy()).requires_grad_(True)
    out = []
    for _ in range(10):
        loss = torch.mean((x @ w - y) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        with torch.no_grad():
            w -= 0.1 * g
        out.append(float(loss.detach()))
    return out


def test_dp_loss_curve_matches_single_process_on_both_sides(gang, curves):
    jref, tref, _ = curves
    np.testing.assert_allclose(tref, jref, rtol=1e-5, atol=1e-6)
    for r in gang:
        np.testing.assert_allclose(r["dp_losses"], jref, rtol=1e-5,
                                   atol=1e-6)


def test_data_parallel_hooks_average_the_gradient(gang):
    """After the first backward each rank holds the full batch's
    gradient, from one all-reduce (one parameter)."""
    for r in gang:
        assert r["hook_grad_gap"] < 1e-6
        assert r["hook_all_reduces"] == 1


def _hapi_weights(seed=0):
    """``dp_rank.hapi_net``'s weights, [in, out], from the same numpy
    seed."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.4, (4, 8)).astype(np.float32),
            np.zeros(8, np.float32),
            rng.normal(0, 0.4, (8, 1)).astype(np.float32),
            np.zeros(1, np.float32)]


def _jax_hapi_curve():
    ws = _hapi_weights()
    import paddle_tpu as paddle
    from paddle_tpu import nn, optimizer
    from paddle_tpu.hapi.model import Model
    X, Y, _ = _data()
    net = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 1))
    for p, w in zip(net.parameters(), ws):
        p.set_value(w)
    opt = optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    m = Model(net)
    m.prepare(optimizer=opt, loss=lambda o, y: ((o - y) ** 2).mean())
    return [m.train_batch(paddle.to_tensor(X), paddle.to_tensor(Y))[0]
            for _ in range(6)]


def test_hapi_fit_under_data_parallel_matches_jax_single_process(gang,
                                                                curves):
    """The mean of the two ranks' local losses equals JAX's
    single-process full-batch curve (rtol 2e-4, as the JAX test holds its
    own), and both ranks end on the same weights."""
    ranks = [r["hapi_losses"] for r in gang]
    np.testing.assert_allclose(np.mean(ranks, axis=0), curves[2],
                               rtol=2e-4, atol=1e-5)
    assert gang[0]["final_w0"] == gang[1]["final_w0"]
    assert gang[0]["hapi_rows"] == [0, 2, 4, 6]
    assert gang[1]["hapi_rows"] == [1, 3, 5, 7]
