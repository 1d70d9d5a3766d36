"""The train side of the port's ``CheckpointManager``: the port's copies
of the model / optimizer / scheduler / scaler cases of JAX's
``TestCheckpointManager`` (``tests/test_resilience.py``) — resume
bit-identical within the port, also after a save killed mid-file — the rng
plane (the global generators and a model's own, through ``TrainStep`` on a
tiny ERNIE with dropout), the telemetry spans, and a snapshot the JAX
package's manager wrote of a two-Linear net with AdamW and LinearWarmup,
restored by the port's: the next three losses within 1e-6 of JAX's."""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_train_step import (_jax_plain_dispatch, batch,  # noqa: F401
                                   jax_net, port_net)
import paddle_tpu as paddle
from paddle_tpu import optimizer as joptim
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.resilience import CheckpointManager as JManager
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.models import ErnieForMaskedLM, ernie_config_tiny
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.observability import TrainTelemetry
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.resilience import (CheckpointManager, InjectedFault,
                                         inject)


def _job(seed):
    """The port's copy of JAX's ``_make_job``: the MLP with Adam(0.01)."""
    net = port_net("mlp", like=jax_net("mlp", seed))
    return net, Adam(learning_rate=0.01, parameters=net.parameters())


def _train(net, opt, lo, hi, mgr=None):
    losses = []
    for i in range(lo, hi):
        x, y = batch(i, "mlp", 16)
        loss = cross_entropy(net(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        if mgr is not None and mgr.should_save(i + 1):
            mgr.save(i + 1)
    return losses


def test_rotation_keeps_last_n(tmp_path):
    net, opt = _job(1)
    mgr = CheckpointManager(str(tmp_path), model=net, optimizer=opt,
                            save_interval=1, keep_last=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_resume_is_bit_identical(tmp_path):
    net, opt = _job(7)
    mgr = CheckpointManager(str(tmp_path), model=net, optimizer=opt,
                            save_interval=4, keep_last=3)
    ref = _train(net, opt, 0, 12, mgr)
    net2, opt2 = _job(99)      # every weight and moment differs until restore
    mgr2 = CheckpointManager(str(tmp_path), model=net2, optimizer=opt2)
    assert mgr2.restore(os.path.join(str(tmp_path), "step_00000008")) == 8
    assert opt2._global_step == 8
    assert _train(net2, opt2, 8, 12) == ref[8:12]


def test_resume_after_killed_save_matches_uninterrupted(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(sys.modules["paddle_tpu_torch.distributed.checkpoint"
                                    ".save_state_dict"], "WRITE_CHUNK", 64)
    net, opt = _job(7)
    ref = _train(net, opt, 0, 12, CheckpointManager(
        str(tmp_path / "a"), model=net, optimizer=opt, save_interval=4))
    netc, optc = _job(7)
    mgrc = CheckpointManager(str(tmp_path / "c"), model=netc, optimizer=optc,
                             save_interval=4)
    _train(netc, optc, 0, 6, mgrc)               # step-4 save lands clean
    with pytest.raises(InjectedFault):
        with inject({"ckpt.write": dict(match={"file": "rank0.data"},
                                        at=2)}):
            _train(netc, optc, 6, 12, mgrc)      # dies saving at step 8
    netr, optr = _job(5)
    mgrr = CheckpointManager(str(tmp_path / "c"), model=netr, optimizer=optr)
    assert mgrr.find_latest_complete().endswith("step_00000004")
    assert mgrr.restore() == 4
    assert _train(netr, optr, 4, 12) == ref[4:12]


def test_rng_scheduler_scaler_and_extra_roundtrip(tmp_path):
    sched = tlr.StepDecay(learning_rate=0.1, step_size=3)
    scaler = GradScaler(enable=True, init_loss_scaling=2048.0)
    mgr = CheckpointManager(str(tmp_path), lr_scheduler=sched, scaler=scaler)
    torch.manual_seed(77)
    for _ in range(5):
        sched.step()
    scaler._scale = 512.0
    draws_before = torch.get_rng_state()
    mgr.save(5, extra_state={"tokens_seen": 12345})
    for _ in range(4):
        sched.step()
    scaler._scale = 1.0
    torch.manual_seed(0)
    assert mgr.restore() == 5
    assert sched.last_epoch == 5 and scaler._scale == 512.0
    assert mgr.last_extra == {"tokens_seen": 12345}
    assert torch.equal(torch.get_rng_state(), draws_before)


def _ernie_step(seed):
    cfg = ernie_config_tiny(vocab=64, hidden=16, layers=1, heads=2, seq=8)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.1
    model = ErnieForMaskedLM(cfg, device="cpu", seed=seed)
    sched = tlr.LinearWarmup(tlr.PolynomialDecay(1e-3, decay_steps=8),
                             warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, weight_decay=0.01)
    step = TrainStep(model, opt, lambda m, ids: m(ids, labels=ids)[0],
                     grad_accum=2, nonfinite_guard=3, device="cpu")
    return model, opt, step


def test_train_step_resume_with_model_generators(tmp_path):
    """A tiny ERNIE at dropout 0.1 through TrainStep: a fresh model of
    another seed restores step 3 — parameters, moments, schedule and both
    dropout generators — and its steps 4-6 equal the uninterrupted run's
    bit for bit."""
    ids = [torch.from_numpy(np.random.default_rng(i).integers(
        0, 64, (4, 8)).astype(np.int64)) for i in range(6)]
    model, opt, step = _ernie_step(0)
    mgr = CheckpointManager(str(tmp_path), model=model, optimizer=opt,
                            save_interval=3)
    ref, lrs = [], []
    for i in range(6):
        ref.append(float(step(ids[i])))
        lrs.append(opt.get_lr())
        mgr.maybe_save(i + 1)
    model2, opt2, step2 = _ernie_step(5)
    mgr2 = CheckpointManager(str(tmp_path), model=model2, optimizer=opt2)
    assert mgr2.restore(os.path.join(str(tmp_path), "step_00000003")) == 3
    assert opt2.get_lr() == lrs[2] and opt2._global_step == 3
    assert [float(step2(ids[i])) for i in range(3, 6)] == ref[3:]


def test_save_and_restore_spans(tmp_path):
    tel = TrainTelemetry()
    net, opt = _job(3)
    mgr = CheckpointManager(str(tmp_path), model=net, optimizer=opt,
                            telemetry=tel)
    mgr.save(2)
    assert mgr.restore() == 2
    snap = tel.registry.snapshot()
    assert snap["ckpt.saves"] == 1 and snap["ckpt.restores"] == 1
    assert tel.registry.histogram("ckpt.stage_s").count == 1
    assert tel.registry.histogram("ckpt.commit_s").count == 1
    assert tel.registry.histogram("ckpt.restore_s").count == 1


def test_restores_a_snapshot_the_jax_package_wrote(tmp_path):
    """JAX trains 4 eager steps of AdamW under LinearWarmup and saves; the
    port's manager restores the snapshot into a net of other weights; the
    next three losses are within 1e-6 of JAX's."""
    def warm(m):
        return m.LinearWarmup(m.PolynomialDecay(0.01, decay_steps=10),
                              warmup_steps=3, start_lr=0.0, end_lr=0.01)

    jnet = jax_net("mlp", 11)
    jopt = joptim.AdamW(learning_rate=warm(jlr), weight_decay=0.05,
                        parameters=jnet.parameters())
    jmgr = JManager(str(tmp_path), model=jnet, optimizer=jopt)
    jl = []
    for i in range(7):
        if i == 4:
            jmgr.save(4)
        x, y = batch(i, "mlp", 16)
        loss = JF.cross_entropy(jnet(paddle.to_tensor(x)),
                                paddle.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jopt._learning_rate.step()
        jl.append(float(loss.numpy()))
    tnet = port_net("mlp")
    topt = AdamW(learning_rate=warm(tlr), weight_decay=0.05,
                 parameters=tnet.parameters())
    mgr = CheckpointManager(str(tmp_path), model=tnet, optimizer=topt)
    assert mgr.restore() == 4
    assert topt._global_step == 4 and topt._learning_rate.last_epoch == 4
    tl = []
    for i in range(4, 7):
        x, y = batch(i, "mlp", 16)
        loss = cross_entropy(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        topt.step()
        topt.clear_grad()
        topt._learning_rate.step()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl[4:], rtol=0, atol=1e-6)
