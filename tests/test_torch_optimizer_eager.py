"""Port parity of the eager optimizer (``Optimizer(parameters=...)``,
``step()`` / ``clear_grad()``) against the JAX package's on a small MLP:
``Momentum``, ``Adam`` and ``AdamW`` with each clip, ``L1Decay`` /
``L2Decay`` (global and per parameter), ``apply_decay_param_fun`` and a
scheduler — the parameters after 5 steps within 1e-6 of JAX's; the state
dict round trip; and the functional path, which (as JAX's) applies
neither ``grad_clip`` nor ``apply_decay_param_fun``."""
import numpy as np
import pytest
import torch

from test_torch_train_step import (_jax_plain_dispatch, batch,  # noqa: F401
                                   jax_net, port_net)
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu import regularizer as jreg
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import lr as tlr


def _both(make):
    """``make(optimizer module, nn module, regularizer module, lr module)``
    for each package."""
    return make(joptim, jnn, jreg, jlr), make(toptim, tnn, treg, tlr)


CASES = {
    "Momentum": lambda o, n, r, s: (o.Momentum, dict(
        learning_rate=0.05, momentum=0.9)),
    "Momentum-nesterov-L2-clip_value": lambda o, n, r, s: (o.Momentum, dict(
        learning_rate=0.05, momentum=0.9, use_nesterov=True,
        weight_decay=r.L2Decay(1e-3), grad_clip=n.ClipGradByValue(0.05))),
    "Momentum-float_wd-sched": lambda o, n, r, s: (o.Momentum, dict(
        learning_rate=s.StepDecay(0.05, step_size=2), weight_decay=1e-3)),
    "Adam": lambda o, n, r, s: (o.Adam, dict(learning_rate=0.01)),
    "Adam-L1-clip_norm": lambda o, n, r, s: (o.Adam, dict(
        learning_rate=0.01, weight_decay=r.L1Decay(1e-3),
        grad_clip=n.ClipGradByNorm(0.1))),
    "Adam-param_regularizer-global_norm": lambda o, n, r, s: (o.Adam, dict(
        learning_rate=0.01, weight_decay=r.L2Decay(1e-2),
        grad_clip=n.ClipGradByGlobalNorm(0.2))),
    "AdamW": lambda o, n, r, s: (o.AdamW, dict(learning_rate=0.01,
                                               weight_decay=0.05)),
    "AdamW-decay_fun-clip-warmup": lambda o, n, r, s: (o.AdamW, dict(
        learning_rate=s.LinearWarmup(s.PolynomialDecay(0.01, 8), 2, 0.0,
                                     0.01),
        weight_decay=0.05, apply_decay_param_fun=lambda nm: nm in (
            "param_0", "param_2"),
        grad_clip=n.ClipGradByGlobalNorm(0.2))),
    "AdamW-param_regularizer": lambda o, n, r, s: (o.AdamW, dict(
        learning_rate=0.01, weight_decay=0.05)),
}


def _eager(net, opt, fwd, steps, lo=0):
    for i in range(lo, lo + steps):
        x, y = batch(i, "mlp")
        loss = fwd(net, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched = opt._learning_rate
        if not isinstance(sched, float):
            sched.step()


def _jfwd(net, x, y):
    return JF.cross_entropy(net(paddle.to_tensor(x)), paddle.to_tensor(y))


def _tfwd(net, x, y):
    return cross_entropy(net(torch.from_numpy(x)), torch.from_numpy(y))


def _pair(name):
    (jcls, jkw), (tcls, tkw) = _both(CASES[name])
    jnet = jax_net("mlp", 5)
    tnet = port_net("mlp", like=jnet)
    if "param_regularizer" in name:
        # the first layer's weight takes its own L1 (ParamAttr's
        # regularizer), overriding the optimizer's decay
        jnet[0].weight.regularizer = jreg.L1Decay(2e-3)
        tnet[0].weight.regularizer = treg.L1Decay(2e-3)
    jopt = jcls(parameters=jnet.parameters(), **jkw)
    topt = tcls(parameters=tnet.parameters(), **tkw)
    return jnet, tnet, jopt, topt


@pytest.mark.parametrize("name", sorted(CASES))
def test_eager_step_matches_jax(name):
    jnet, tnet, jopt, topt = _pair(name)
    _eager(jnet, jopt, _jfwd, 5)
    _eager(tnet, topt, _tfwd, 5)
    assert topt._global_step == jopt._global_step == 5
    assert topt.get_lr() == jopt.get_lr()
    for (k, v), p in zip(jnet.state_dict().items(), tnet.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(v.numpy()),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_state_dict_round_trip():
    """3 steps, the state dict into a fresh optimizer on a copy of the
    weights, 2 steps on each: bit-identical; the keys are JAX's."""
    jnet, tnet, jopt, topt = _pair("AdamW-decay_fun-clip-warmup")
    _eager(jnet, jopt, _jfwd, 3)
    _eager(tnet, topt, _tfwd, 3)
    sd = topt.state_dict()
    assert sorted(sd) == sorted(jopt.state_dict())
    assert sd["LR_Scheduler"] == jopt.state_dict()["LR_Scheduler"]
    tnet2 = port_net("mlp")
    tnet2.load_state_dict(tnet.state_dict())
    _, (tcls, tkw) = _both(CASES["AdamW-decay_fun-clip-warmup"])
    topt2 = tcls(parameters=tnet2.parameters(), **tkw)
    topt2.set_state_dict({k: (v.clone() if isinstance(v, torch.Tensor)
                              else v) for k, v in sd.items()})
    assert topt2._global_step == 3 and topt2.get_lr() == topt.get_lr()
    _eager(tnet, topt, _tfwd, 2, lo=3)
    _eager(tnet2, topt2, _tfwd, 2, lo=3)
    for a, b in zip(tnet.parameters(), tnet2.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        topt.set_lr(0.1)


def test_functional_path_ignores_clip_and_decay_fun():
    """``apply_gradients_functional`` applies neither ``grad_clip`` nor
    ``apply_decay_param_fun``, as JAX's: the update with both equals the
    update without, and JAX's; a global ``L2Decay`` and ``lr_scales`` are
    applied."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    g0 = {k: 5 * rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    scales = {"b": 0.5}
    kws = [dict(), dict(grad_clip=tnn.ClipGradByGlobalNorm(0.01),
                        apply_decay_param_fun=lambda n: False)]
    outs = []
    for kw in kws:
        opt = toptim.AdamW(learning_rate=0.01, weight_decay=0.1, **kw)
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        grads = {k: torch.from_numpy(v) for k, v in g0.items()}
        st = opt.init_opt_state(params, device="cpu")
        opt.apply_gradients_functional(params, grads, st, lr_scales=scales)
        outs.append(params)
    import jax.numpy as jnp
    jopt = joptim.AdamW(learning_rate=0.01, weight_decay=0.1, parameters=[],
                        grad_clip=jnn.ClipGradByGlobalNorm(0.01),
                        apply_decay_param_fun=lambda n: False)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jnew, _ = jopt.apply_gradients_functional(
        jp, {k: jnp.asarray(v) for k, v in g0.items()},
        jopt.init_opt_state(jp), lr_scales=scales)
    for k in shapes:
        assert torch.equal(outs[0][k], outs[1][k])
        np.testing.assert_allclose(outs[1][k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-6)
    # the coupled decay object on the functional path
    opt = toptim.Momentum(learning_rate=0.1, weight_decay=treg.L2Decay(0.5))
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt.apply_gradients_functional(
        params, {k: torch.from_numpy(v) for k, v in g0.items()},
        opt.init_opt_state(params, device="cpu"))
    jm = joptim.Momentum(learning_rate=0.1, parameters=[],
                         weight_decay=jreg.L2Decay(0.5))
    jnew, _ = jm.apply_gradients_functional(
        jp, {k: jnp.asarray(v) for k, v in g0.items()}, jm.init_opt_state(jp))
    for k in shapes:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-6)


def test_clips_match_jax():
    """Each clipper over the same (param, grad) pairs, one parameter with
    ``need_clip = False``."""
    from paddle_tpu.core.tensor import Tensor
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal(s).astype(np.float32) * 3
          for s in ((4, 5), (5,), (3, 3))]
    for name, args in (("ClipGradByValue", (0.5, -0.25)),
                       ("ClipGradByNorm", (1.0,)),
                       ("ClipGradByGlobalNorm", (2.0,))):
        jp = [type("P", (), {"need_clip": i != 1})() for i in range(3)]
        tp = [type("P", (), {"need_clip": i != 1})() for i in range(3)]
        jout = getattr(jnn, name)(*args)(
            [(p, Tensor(g)) for p, g in zip(jp, gs)])
        tout = getattr(tnn, name)(*args)(
            [(p, torch.from_numpy(g)) for p, g in zip(tp, gs)])
        for (_, a), (_, b) in zip(jout, tout):
            np.testing.assert_allclose(b.numpy(), np.asarray(a._value),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
