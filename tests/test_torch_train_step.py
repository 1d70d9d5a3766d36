"""Port parity of the train loop's core: ``parallel.TrainStep`` against the
JAX package's ``TrainStep`` on a small net with BatchNorm and Linear
layers (losses and parameters after 4 steps, ``grad_accum`` 1 and 2, an
AdamW under a ``LinearWarmup`` schedule), the port's copies of JAX's
non-finite sentinel cases (``tests/test_resilience.py``
``TestTrainStepSentinel``), ``TrainTelemetry``'s counters and report on
the same events under a fake clock (``tests/test_observability.py``
``TestTrainTelemetry``), and ``GradScaler``'s eager books.  JAX weights
cross by name through numpy.  The helpers here (``jax_net``, ``port_net``,
``batch``) are shared by the other train-loop test files."""
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.nn import functional as JF
from paddle_tpu.observability.train import TrainTelemetry as JTelemetry
from paddle_tpu.parallel.train_step import compile_train_step as jcompile
from paddle_tpu.resilience import inject as jinject
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.observability import TrainTelemetry
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.resilience import FaultSpec, inject

CPU = dict(dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True)
def _jax_plain_dispatch():
    """The JAX oracle runs its plain ops even after an earlier test on this
    worker registered the Pallas overrides."""
    prev = paddle.get_flags(["use_pallas_kernels"])
    paddle.set_flags({"use_pallas_kernels": False})
    yield
    paddle.set_flags(prev)


def jax_net(kind="bn", seed=3):
    """``bn``: BatchNorm2D(4), Flatten, Linear(16, 8), ReLU, Linear(8, 3)
    over [B, 4, 2, 2]; ``mlp``: Linear(8, 16), Tanh, Linear(16, 4);
    ``linear``: Linear(8, 4)."""
    paddle.seed(seed)
    if kind == "bn":
        return jnn.Sequential(jnn.BatchNorm2D(4), jnn.Flatten(),
                              jnn.Linear(16, 8), jnn.ReLU(), jnn.Linear(8, 3))
    if kind == "mlp":
        return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    return jnn.Linear(8, 4)


def port_net(kind="bn", like=None):
    """The port's copy of :func:`jax_net`'s net, with ``like``'s weights
    (a JAX net) when given."""
    g = torch.Generator().manual_seed(0)
    lin = lambda i, o: L.Linear(i, o, generator=g, **CPU)  # noqa: E731
    if kind == "bn":
        net = nn.Sequential(L.BatchNorm2D(4, **CPU), L.Flatten(), lin(16, 8),
                            L.ReLU(), lin(8, 3))
    elif kind == "mlp":
        net = nn.Sequential(lin(8, 16), nn.Tanh(), lin(16, 4))
    else:
        net = lin(8, 4)
    if like is not None:
        sd = {k: np.array(v.numpy()) for k, v in like.state_dict().items()}
        with torch.no_grad():
            for k, t in net.state_dict().items():
                t.copy_(torch.from_numpy(sd[k]))
    return net


def batch(i, kind="bn", n=8):
    r = np.random.default_rng(1000 + i)
    shape = (n, 4, 2, 2) if kind == "bn" else (n, 8)
    classes = 3 if kind == "bn" else 4
    return (r.standard_normal(shape).astype(np.float32),
            r.integers(0, classes, (n,)).astype(np.int64))


def jax_ce(m, x, y):
    return JF.cross_entropy(m(x), y)


def port_ce(m, x, y):
    return cross_entropy(m(x), y)


def state_of(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def warmup(mod):
    return mod.LinearWarmup(mod.PolynomialDecay(0.01, decay_steps=6),
                            warmup_steps=2, start_lr=0.0, end_lr=0.01)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    """4 steps of AdamW under LinearWarmup(PolynomialDecay): every loss and
    every parameter and BatchNorm buffer within 1e-5 of JAX's."""
    jnet = jax_net()
    tnet = port_net(like=jnet)
    from paddle_tpu.optimizer import lr as jlr
    jopt = joptim.AdamW(learning_rate=warmup(jlr), parameters=[],
                        weight_decay=0.01)
    topt = AdamW(learning_rate=warmup(tlr), weight_decay=0.01)
    jts = jcompile(jnet, jopt, jax_ce, grad_accum=grad_accum)
    tts = TrainStep(tnet, topt, port_ce, grad_accum=grad_accum,
                    device="cpu")
    for i in range(4):
        x, y = batch(i)
        a, b = float(jts(x, y).numpy()), float(tts(x, y))
        assert abs(a - b) <= 1e-5 * max(1.0, abs(a)), (i, a, b)
    assert topt.get_lr() == jopt.get_lr() and topt._global_step == 4
    jts.sync_to_model()
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(tnet.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_train_step_keeps_grad_buffers_and_checks_device(monkeypatch):
    """No ``.grad`` is written; the model must be on the step's device;
    an unported option raises naming its ROADMAP item."""
    tnet = port_net()
    tts = TrainStep(tnet, Adam(0.01), port_ce, grad_accum=2, device="cpu")
    tts(*batch(0))
    assert all(p.grad is None for p in tnet.parameters())
    with pytest.raises(ValueError, match="not divisible"):
        tts(*batch(1, n=7))
    with pytest.raises(NotImplementedError, match="item 7"):
        TrainStep(tnet, Adam(0.01), port_ce, with_amp=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="is on cpu"):
        TrainStep(tnet, Adam(0.01), port_ce)


def test_in_shardings_is_accepted_and_ignored_like_jax():
    """``in_shardings`` changes nothing on either side: one seeded step
    with it equals the step without it, bit for bit, in JAX and in the
    port, and the two packages agree within 1e-5."""
    x, y = batch(0)
    losses, params = {}, {}
    for given in (None, ()):
        jnet = jax_net()
        tnet = port_net(like=jnet)
        jts = jcompile(jnet, joptim.Adam(learning_rate=0.01, parameters=[]),
                       jax_ce, in_shardings=given)
        tts = TrainStep(tnet, Adam(0.01), port_ce, in_shardings=given,
                        device="cpu")
        losses[given] = (float(jts(x, y).numpy()), float(tts(x, y)))
        jts.sync_to_model()
        params[given] = (
            {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()},
            {k: v.numpy().copy() for k, v in tnet.state_dict().items()})
    assert losses[()] == losses[None]
    for side in (0, 1):
        for k, v in params[None][side].items():
            np.testing.assert_array_equal(params[()][side][k], v, err_msg=k)
    a, b = losses[None]
    assert abs(a - b) <= 1e-5 * max(1.0, abs(a))
    for k, v in params[None][0].items():
        np.testing.assert_allclose(params[None][1][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the non-finite sentinel (JAX tests/test_resilience.py TestTrainStepSentinel)
# ---------------------------------------------------------------------------
def _sentinel(guard=3, scaler=None, telemetry=None):
    net = port_net("linear", like=jax_net("linear", 13))
    opt = Adam(learning_rate=0.01, parameters=net.parameters())
    ts = TrainStep(net, opt, lambda m, x: m(x).mean(), nonfinite_guard=guard,
                   scaler=scaler, telemetry=telemetry, device="cpu")
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    return ts, x


def test_bad_step_skipped_everything_frozen():
    """The injected step is skipped: parameters, moments, BatchNorm buffers,
    the LR schedule and global_step stay bit-identical."""
    net = port_net()
    opt = AdamW(learning_rate=warmup(tlr), parameters=net.parameters())
    ts = TrainStep(net, opt, port_ce, nonfinite_guard=3, device="cpu")
    with inject({"train.nonfinite": dict(action="trigger", at=2)}):
        for i in range(5):
            before = state_of(net)
            moments = {k: {n: t.clone() for n, t in st.items()}
                       for k, st in ts.opt_state.items()}
            lr, sched = opt.get_lr(), dict(opt._learning_rate.state_dict())
            lv = float(ts(*batch(i)))
            if i == 2:
                assert np.isnan(lv) and not ts.last_step_good
                for k, t in state_of(net).items():
                    assert torch.equal(t, before[k]), k
                for k, st in ts.opt_state.items():
                    for n, t in st.items():
                        assert torch.equal(t, moments[k][n]), (k, n)
                assert opt.get_lr() == lr
                assert opt._learning_rate.state_dict() == sched
            else:
                assert np.isfinite(lv) and ts.last_step_good
    assert ts.skipped_steps == 1 and ts.consecutive_bad == 0
    assert opt._global_step == 4 and opt._learning_rate.last_epoch == 4


def test_raises_after_m_consecutive():
    ts, x = _sentinel(guard=3)
    with inject({"train.nonfinite": dict(action="trigger", after=0,
                                         count=None)}):
        with pytest.raises(FloatingPointError, match="3 consecutive"):
            for _ in range(10):
                ts(x)
    assert ts.skipped_steps == 3


def test_intermittent_never_raises():
    ts, x = _sentinel(guard=2)
    with inject([FaultSpec("train.nonfinite", action="trigger", at=1),
                 FaultSpec("train.nonfinite", action="trigger", at=3)]):
        for _ in range(6):
            ts(x)
    assert ts.skipped_steps == 2 and ts.consecutive_bad == 0


def test_scaler_backoff_on_skip():
    scaler = GradScaler(enable=True, init_loss_scaling=1024.0,
                        decr_every_n_nan_or_inf=1)
    ts, x = _sentinel(scaler=scaler)
    with inject({"train.nonfinite": dict(action="trigger", at=1)}):
        for _ in range(3):
            ts(x)
    assert scaler._scale == 512.0  # one bad step halved the loss scale
    assert scaler._good_steps == 1


# ---------------------------------------------------------------------------
# TrainTelemetry against JAX's on the same events (fake clocks)
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _telemetry_pair(guard, spec):
    """The JAX and the port sentinel steps, each with a TrainTelemetry on
    its own fake clock, driven through the same injected faults."""
    tels = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            tel = JTelemetry(clock=_Clock())
            net = jax_net("linear", 13)
            opt = joptim.Adam(learning_rate=0.01, parameters=net.parameters())
            scaler = JScaler(init_loss_scaling=1024.0)
            ts = jcompile(net, opt, lambda m, x: m(x).mean(),
                          nonfinite_guard=guard, scaler=scaler, telemetry=tel)
            ctx = jinject
        else:
            tel = TrainTelemetry(clock=_Clock())
            ts, _ = _sentinel(guard, GradScaler(init_loss_scaling=1024.0),
                              tel)
            ctx = inject
        x = np.random.default_rng(0).standard_normal((4, 8)).astype(
            np.float32)
        raised = False
        with ctx(spec, seed=7):
            try:
                for _ in range(4):
                    ts(x)
            except FloatingPointError:
                raised = True
        tels.append((tel, raised))
    return tels


@pytest.mark.parametrize("guard,spec", [
    (3, {"train.nonfinite": dict(action="trigger", at=1)}),
    (2, {"train.nonfinite": dict(action="trigger", after=0, count=None)})],
    ids=["skip", "raise"])
def test_telemetry_matches_jax(guard, spec):
    (jt, jraised), (tt, traised) = _telemetry_pair(guard, spec)
    assert jraised == traised
    assert tt.report(window_s=2.0) == jt.report(window_s=2.0)
    assert tt.registry.snapshot() == jt.registry.snapshot()
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k != "fault_plan"} for e in evs]
    assert strip(tt.flight.events()) == strip(jt.flight.events())
    if jraised:
        assert tt.flight.last_dump()["reason"] == "nonfinite_raise"
        assert tt.flight.last_dump()["extra"] \
            == jt.flight.last_dump()["extra"]
    else:
        fp = [e["fault_plan"] for e in tt.flight.events()
              if e["event"] == "nonfinite_skip"]
        assert fp and fp[0]["seed"] == 7 and fp[0]["fired"] == 1


def test_telemetry_checkpoint_hooks_match_jax():
    """span / phase_event / saved / restored / torn_snapshot /
    async_save_failed land in the same counters and flight events."""
    out = []
    for cls in (JTelemetry, TrainTelemetry):
        tel = cls(clock=_Clock())
        with tel.span("ckpt.save", step=4):
            tel.phase_event("ckpt.stage", 0.25, step=4)
        tel.saved(4, "/x/step_00000004")
        tel.restored(4, "/x/step_00000004")
        tel.torn_snapshot("/x/step_00000008", ValueError("torn"))
        tel.async_save_failed(OSError("disk"))
        tel.step(0.5, data_s=0.1, compute_s=0.4, samples=3)
        out.append((tel.report(), tel.registry.snapshot(),
                    tel.flight.event_names()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# GradScaler's eager books against JAX's
# ---------------------------------------------------------------------------
def test_grad_scaler_eager_matches_jax():
    """scale(loss).backward(), step(opt), update() for 4 iterations, the
    second with a NaN in its batch: the same skip, scales and parameters
    as JAX's; unscale_ twice raises; the state dict round trips."""
    jnet = jax_net("mlp", 5)
    tnet = port_net("mlp", like=jnet)
    jopt = joptim.Adam(learning_rate=0.01, parameters=jnet.parameters())
    topt = Adam(learning_rate=0.01, parameters=tnet.parameters())
    kw = dict(init_loss_scaling=2.0 ** 16, incr_every_n_steps=2)
    js, ts = JScaler(**kw), GradScaler(**kw)
    for i in range(4):
        x, y = batch(i, "mlp")
        if i == 1:
            x[0, 0] = np.nan
        jl = JF.cross_entropy(jnet(paddle.to_tensor(x)), paddle.to_tensor(y))
        js.scale(jl).backward()
        js.step(jopt)
        js.update()
        jopt.clear_grad()
        tl = cross_entropy(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        ts.scale(tl).backward()
        ts.step(topt)
        ts.update()
        topt.clear_grad()
        assert ts.state_dict() == js.state_dict(), i
    assert ts._scale == 2.0 ** 16     # halved once, doubled once
    for (k, v), p in zip(jnet.state_dict().items(), tnet.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(v.numpy()),
                                   rtol=0, atol=1e-6, err_msg=k)
    tl = cross_entropy(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    ts.scale(tl).backward()
    ts.unscale_(topt)
    with pytest.raises(RuntimeError, match="twice"):
        ts.unscale_(topt)
    other = GradScaler()
    other.set_state_dict(ts.state_dict())
    assert other.state_dict() == ts.state_dict()
