"""The JAX oracles of the port's pipeline tests (``test_torch_pipeline.py``,
``test_torch_pipeline_schedules.py``): dense training on one device, as
``tests/test_parallel.py:17`` and ``tests/test_pipeline_schedules.py``
prove JAX's pipelines equal it — the tiny LLaMA's ``build_functional_llama``
loss over the whole batch and JAX's functional AdamW, under ``jax.jit``;
and the ``Linear`` pipeline layer's MSE.  Each returns numpy: the loss of
every step, the first step's gradients, the elements where AdamW's
denominator came near its eps and the parameters after the last step."""
import contextlib
import functools
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_launch_scripts"))
import pipeline_cases as cases  # noqa: E402

sys.path.pop(0)

LOSS_RTOL = 2e-4                    # JAX's, test_pipeline_schedules.py:62
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
ADAM_EPS, ADAM_BETA2 = 1e-8, 0.999     # AdamW's defaults
ADAM_ILL = 10 * ADAM_EPS               # an ill denominator: sqrt(v) below it
ILL_SHARE = 1e-3                       # the most of a tensor held so


def assert_params(got, want, ill, what, steps=cases.STEPS, lr=cases.LR):
    """Parameters after ``steps`` AdamW steps against the oracle's: rtol
    1e-4 / atol 1e-5, except where AdamW's denominator was ill at some
    step (``ill``: see :func:`_train`).  AdamW steps by m / (sqrt(v) +
    eps), so where sqrt(v) is within a few eps of 0 the size of a step
    turns on the gradient's rounding, which any micro-batching changes,
    and such an element is held to what the steps can move it, 2 lr a
    step.  JAX's own micro-batched training (four losses of two rows) ends
    1.8e-5 to 4.3e-5 from JAX's dense on three such elements of the tiny
    LLaMA (|g| 3.9e-9 to 2.7e-8).  At most ``ILL_SHARE`` of the elements
    may be so held."""
    got, want = np.asarray(got), np.asarray(want)
    assert ill.sum() <= ILL_SHARE * ill.size, (
        f"{what}: {int(ill.sum())} of {ill.size} elements with an ill "
        "AdamW denominator")
    tol = PARAM_ATOL + PARAM_RTOL * np.abs(want)
    tol = np.where(ill, 2 * steps * lr, tol)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} of {bad.size} elements off, worst "
        f"{np.abs(got - want).max():.3e}")


@contextlib.contextmanager
def plain_jax():
    """The JAX oracle runs its plain ops (no Pallas override another test
    of this worker registered)."""
    import paddle_tpu
    prev = paddle_tpu.get_flags(["use_pallas_kernels"])
    paddle_tpu.set_flags({"use_pallas_kernels": False})
    try:
        yield
    finally:
        paddle_tpu.set_flags(prev)


def jax_llama():
    """JAX's tiny LLaMA (key 3): (config, (ep, bp, hp) as numpy, the
    functions)."""
    from paddle_tpu.models.llama import (build_functional_llama,
                                         llama_config_tiny)
    cfg = llama_config_tiny(**cases.TINY)
    ep, bp, hp, ea, ba, hl = build_functional_llama(
        cfg, key=jax.random.PRNGKey(3))
    trees = tuple({k: np.asarray(v) for k, v in t.items()}
                  for t in (ep, bp, hp))
    return cfg, trees, (ea, ba, hl)


def _train(loss_fn, params, batch, steps, lr):
    """``steps`` AdamW(lr) steps of ``loss_fn(params, *batch)`` under
    ``jax.jit``; ``params`` a dict of named trees.  Returns the losses,
    the first step's gradients, where AdamW's bias-corrected sqrt(v) was
    nonzero but below ``ADAM_ILL`` after some step (``ill``, see
    :func:`assert_params`) and the parameters after, each by dotted
    name."""
    from paddle_tpu import optimizer
    from paddle_tpu.parallel.pipeline import _flatten, _unflatten
    opt = optimizer.AdamW(learning_rate=lr, parameters=[])
    state = {k: opt.init_opt_state(_flatten(t)) for k, t in params.items()}

    @jax.jit
    def step(params, state):
        loss, g = jax.value_and_grad(loss_fn)(params, *batch)
        new_p, new_s = {}, {}
        for k in params:
            p, s = opt.apply_gradients_functional(
                _flatten(params[k]), _flatten(g[k]), state[k], lr=lr)
            new_p[k], new_s[k] = _unflatten(p, params[k]), s
        return new_p, new_s, loss, g

    losses, first, ill, v = [], None, None, None
    for k in range(1, steps + 1):
        params, state, loss, g = step(params, state)
        losses.append(float(loss))
        first = g if first is None else first
        g2 = jax.tree_util.tree_map(lambda x: np.asarray(x) ** 2, g)
        v = g2 if v is None else jax.tree_util.tree_map(
            lambda a, b: ADAM_BETA2 * a + b, v, g2)
        # v here is AdamW's v / (1 - beta2); its bias-corrected sqrt(v)
        # is sqrt(v (1 - beta2) / (1 - beta2 ** k))
        near = jax.tree_util.tree_map(
            lambda x: (x > 0) & (x * (1 - ADAM_BETA2) / (1 - ADAM_BETA2 ** k)
                                 < ADAM_ILL ** 2), v)
        ill = near if ill is None else jax.tree_util.tree_map(
            np.logical_or, ill, near)
    flat = lambda tree: {f"{k}.{n}": np.asarray(v)  # noqa: E731
                         for k, t in tree.items() for n, v in t.items()}
    return dict(losses=losses, grads=flat(first), ill=flat(ill),
                params=flat(params))


@functools.lru_cache(maxsize=None)
def llama_oracle(steps=cases.STEPS):
    """Dense training of JAX's tiny LLaMA on ``cases.batch()``."""
    with plain_jax():
        cfg, trees, (ea, ba, hl) = jax_llama()
        ids, labels = (jnp.asarray(a) for a in cases.batch())

        def loss_fn(p, ids, labels):
            x = ea(p["ep"], (ids, labels))[0]
            y, _ = jax.lax.scan(lambda c, lp: (ba(lp, c), None), x, p["bp"])
            return hl(p["hp"], y[None], (ids, labels))
        params = {k: {n: jnp.asarray(v) for n, v in t.items()}
                  for k, t in zip(("ep", "bp", "hp"), trees)}
        out = _train(loss_fn, params, (ids, labels), steps, cases.LR)
    out["init"] = trees
    return out


@functools.lru_cache(maxsize=None)
def linear_oracle(widths, steps):
    """Dense training of the ``Linear`` pipeline layer of ``widths`` on
    ``cases.linear_data()``; names as the port's ``PipelineLayer`` gives
    them (``run_function.{i}.weight`` / ``.bias``)."""
    ws, x, y = cases.linear_data()
    y = y[:, :widths[-1]]
    params = {"run_function": {}}
    for i, ((w, b), a, o) in enumerate(zip(ws, widths[:-1], widths[1:])):
        params["run_function"][f"{i}.weight"] = jnp.asarray(w[:a, :o])
        params["run_function"][f"{i}.bias"] = jnp.asarray(b[:o])

    def loss_fn(p, x, y):
        h = x
        for i in range(len(widths) - 1):
            h = h @ p["run_function"][f"{i}.weight"] \
                + p["run_function"][f"{i}.bias"]
        return jnp.mean((h - y) ** 2)
    with plain_jax():
        return _train(loss_fn, params, (jnp.asarray(x), jnp.asarray(y)),
                      steps, cases.LR)
