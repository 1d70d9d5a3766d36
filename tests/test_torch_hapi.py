"""Port parity of ``hapi.Model`` and its callbacks against the JAX
package's: ``fit`` / ``evaluate`` on JAX's ``Toy`` dataset
(``tests/test_e2e_training.py``) — per-batch losses within 1e-5, accuracy
equal, the shuffled order too (both draw from numpy's global state); the
port's copies of JAX's ``TestFitCheckpointResume``
(``tests/test_resilience.py``) — ``fit(ckpt=)`` resumes bit-exact within
the port — and the same for a shuffling loader with a generator and 2
workers; ``.pdparams`` files written by one package and loaded by the
other; the callbacks; and the options left out, which raise."""
import os

import numpy as np
import pytest
import torch
from torch import nn

from test_torch_train_step import _jax_plain_dispatch  # noqa: F401
import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus,
                                                        MemoryStore)
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                             ElasticRestart, LRScheduler,
                                             ModelCheckpoint)
from paddle_tpu_torch.io import DataLoader, Dataset
from paddle_tpu_torch.nn import layers as L
from paddle_tpu_torch.optimizer import Adam, Momentum
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.resilience import (CheckpointManager, InjectedFault,
                                         inject)

CPU = dict(dtype=torch.float32, device="cpu")


class _Toy:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        x = r.standard_normal(8).astype(np.float32)
        return x, np.int64(x.sum() > 0)


JToy = type("JToy", (_Toy, JDataset), {})
TToy = type("TToy", (_Toy, Dataset), {})


def _nets(seed, act="relu"):
    """JAX's Linear(8, 16), act, Linear(16, 2) and the port's copy."""
    paddle.seed(seed)
    ja = jnn.ReLU() if act == "relu" else jnn.Tanh()
    jnet = jnn.Sequential(jnn.Linear(8, 16), ja, jnn.Linear(16, 2))
    g = torch.Generator().manual_seed(0)
    ta = L.ReLU() if act == "relu" else nn.Tanh()
    tnet = nn.Sequential(L.Linear(8, 16, generator=g, **CPU), ta,
                         L.Linear(16, 2, generator=g, **CPU))
    sd = {k: np.array(v.numpy()) for k, v in jnet.state_dict().items()}
    with torch.no_grad():
        for k, t in tnet.state_dict().items():
            t.copy_(torch.from_numpy(sd[k]))
    return jnet, tnet


def _loss_log(base):
    class Log(base):
        def __init__(self):
            self.losses = []

        def on_batch_end(self, mode, step, logs=None):
            if mode == "train" and logs and "loss" in logs:
                self.losses.append(logs["loss"])
    return Log()


def test_fit_and_evaluate_match_jax():
    """2 epochs of the shuffled Toy at B 16 with Adam(0.01) and Accuracy:
    every batch's loss within 1e-5 of JAX's, evaluation equal."""
    jnet, tnet = _nets(0)
    jm = paddle.Model(jnet)
    jm.prepare(joptim.Adam(learning_rate=0.01, parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), jmetric.Accuracy())
    tm = Model(tnet, device="cpu")
    tm.prepare(Adam(learning_rate=0.01, parameters=tnet.parameters()),
               tnn.CrossEntropyLoss(), tmetric.Accuracy())
    jlog, tlog = _loss_log(JCallback), _loss_log(Callback)
    np.random.seed(5)
    jm.fit(JToy(), batch_size=16, epochs=2, verbose=0, callbacks=[jlog])
    np.random.seed(5)
    tm.fit(TToy(), batch_size=16, epochs=2, verbose=0, callbacks=[tlog])
    assert len(tlog.losses) == len(jlog.losses) == 8
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=0, atol=1e-5)
    jres = jm.evaluate(JToy(), batch_size=16, verbose=0)
    tres = tm.evaluate(TToy(), batch_size=16, verbose=0)
    assert tres["acc"] == jres["acc"] and tres["acc"] > 0.7
    assert abs(tres["loss"] - jres["loss"]) <= 1e-5
    out = tm.predict(TToy(), batch_size=32)
    assert len(out) == 2 and out[0].shape == (32, 2)


# ---------------------------------------------------------------------------
# fit(ckpt=...) (JAX tests/test_resilience.py TestFitCheckpointResume)
# ---------------------------------------------------------------------------
def _fit_job(seed=5):
    _, net = _nets(seed, act="tanh")
    m = Model(net, device="cpu")
    m.prepare(Adam(learning_rate=0.01, parameters=net.parameters()),
              tnn.CrossEntropyLoss())
    return m


def _fit_batches(n=8, bs=8):
    out = []
    for i in range(n):
        r = np.random.default_rng(500 + i)
        out.append((r.standard_normal((bs, 8)).astype(np.float32),
                    r.integers(0, 2, (bs,)).astype(np.int64)))
    return out


def test_fit_auto_resume_bit_identical(tmp_path):
    data = _fit_batches()
    ref = _loss_log(Callback)
    _fit_job().fit(data, epochs=2, shuffle=False, verbose=0, callbacks=[ref])
    log1 = _loss_log(Callback)
    m1 = _fit_job()
    mgr1 = CheckpointManager(str(tmp_path), save_interval=2)
    m1.fit(data, epochs=2, shuffle=False, verbose=0, callbacks=[log1],
           num_iters=5, ckpt=mgr1)
    assert mgr1.model is m1.network
    log2 = _loss_log(Callback)
    _fit_job(seed=99).fit(data, epochs=2, shuffle=False, verbose=0,
                          callbacks=[log2],
                          ckpt=CheckpointManager(str(tmp_path),
                                                 save_interval=2))
    assert log1.losses[:4] + log2.losses == ref.losses


def test_fit_ckpt_with_shuffle_warns(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=2)
    with pytest.warns(RuntimeWarning, match="DETERMINISTIC"):
        _fit_job().fit(TToy(), batch_size=4, epochs=1, verbose=0, num_iters=2,
                       ckpt=mgr)


def test_fit_resume_respects_num_iters_bound(tmp_path):
    data = _fit_batches()
    log1 = _loss_log(Callback)
    _fit_job().fit(data, epochs=1, shuffle=False, verbose=0, callbacks=[log1],
                   num_iters=4, ckpt=CheckpointManager(str(tmp_path),
                                                       save_interval=2))
    assert len(log1.losses) == 4
    log2 = _loss_log(Callback)
    _fit_job(seed=13).fit(data, epochs=1, shuffle=False, verbose=0,
                          callbacks=[log2], num_iters=4,
                          ckpt=CheckpointManager(str(tmp_path),
                                                 save_interval=2))
    assert log2.losses == []


def test_fit_resume_skips_torn_snapshot(tmp_path, monkeypatch):
    import sys
    monkeypatch.setattr(sys.modules["paddle_tpu_torch.distributed.checkpoint"
                                    ".save_state_dict"], "WRITE_CHUNK", 64)
    data = _fit_batches()
    ref = _loss_log(Callback)
    _fit_job().fit(data, epochs=1, shuffle=False, verbose=0, callbacks=[ref])
    with inject({"ckpt.write": dict(match={"file": "rank0.data"},
                                    after=1 << 30)}) as probe:
        pm = _fit_job()
        CheckpointManager(str(tmp_path / "probe"), model=pm.network,
                          optimizer=pm._optimizer).save(0)
    per_save = probe.hits("ckpt.write")
    assert per_save >= 2
    log1 = _loss_log(Callback)
    mgr1 = CheckpointManager(str(tmp_path), save_interval=2, keep_last=None)
    with inject({"ckpt.write": dict(match={"file": "rank0.data"},
                                    after=per_save + 1)}):
        with pytest.raises(InjectedFault):
            _fit_job().fit(data, epochs=1, shuffle=False, verbose=0,
                           callbacks=[log1], ckpt=mgr1)
    mgr2 = CheckpointManager(str(tmp_path), save_interval=2)
    resumed_at = CheckpointManager.step_of(mgr2.find_latest_complete())
    log2 = _loss_log(Callback)
    _fit_job(seed=31).fit(data, epochs=1, shuffle=False, verbose=0,
                          callbacks=[log2], ckpt=mgr2)
    assert log1.losses[:resumed_at] + log2.losses == ref.losses


def test_elastic_change_triggers_gang_resume(tmp_path):
    data = _fit_batches()
    ref = _loss_log(Callback)
    _fit_job().fit(data, epochs=1, shuffle=False, verbose=0, callbacks=[ref])
    emgr = ElasticManager(MemoryStore(), np_min=1, np_max=4,
                          heartbeat_timeout=60.0)
    emgr.register("n0:1")
    emgr.watch()
    watcher = ElasticRestart(emgr)

    class Join(Callback):
        def on_batch_end(self, mode, step, logs=None):
            if mode == "train" and step == 3:
                emgr.register("n1:1")

    log1 = _loss_log(Callback)
    m1 = _fit_job()
    m1.fit(data, epochs=1, shuffle=False, verbose=0,
           callbacks=[log1, Join(), watcher],
           ckpt=CheckpointManager(str(tmp_path), save_interval=2))
    assert watcher.status == ElasticStatus.CHANGE
    assert len(log1.losses) == 4
    log2 = _loss_log(Callback)
    m1.fit(data, epochs=1, shuffle=False, verbose=0, callbacks=[log2],
           ckpt=CheckpointManager(str(tmp_path), save_interval=2))
    assert log1.losses[:4] + log2.losses == ref.losses


def test_fit_resume_with_shuffling_workers_and_schedule(tmp_path):
    """The card's ResNet recipe in miniature: a shuffling DataLoader over
    ``FakeImageNet`` with a generator, Momentum
    under PiecewiseDecay with L2Decay, top-1 / top-2 Accuracy, the
    LRScheduler callback; stopped at iteration 5 and relaunched with a
    loader of another seed and 2 workers, the run reproduces the
    uninterrupted losses and learning rates bit for bit (the workers do
    not change the order)."""
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision.datasets import FakeImageNet

    def job(seed, workers=0):
        _, net = _nets(seed)
        net = nn.Sequential(L.Flatten(), net)
        sched = tlr.PiecewiseDecay([3, 6], [0.1, 0.01, 0.001])
        m = Model(net, device="cpu")
        m.prepare(Momentum(learning_rate=sched, momentum=0.9,
                           parameters=net.parameters(),
                           weight_decay=L2Decay(1e-4)),
                  tnn.CrossEntropyLoss(), tmetric.Accuracy(topk=(1, 2)))
        loader = DataLoader(FakeImageNet(64, 2, 2, channels=2),
                            batch_size=16, shuffle=True,
                            num_workers=workers, persistent_workers=True,
                            generator=torch.Generator().manual_seed(seed))
        return m, loader, sched

    class Rec(Callback):
        def __init__(self, sched):
            self.sched, self.out = sched, []

        def on_batch_end(self, mode, step, logs=None):
            self.out.append((logs["loss"], self.sched()))

    m, loader, sched = job(0)
    ref = Rec(sched)
    m.fit(loader, epochs=2, verbose=0, callbacks=[LRScheduler(), ref])
    got = []
    for seed, stop, workers in ((0, 5, 0), (7, None, 2)):
        m, loader, sched = job(seed, workers)
        rec = Rec(sched)
        m.fit(loader, epochs=2, verbose=0, num_iters=stop,
              callbacks=[LRScheduler(), rec],
              ckpt=CheckpointManager(str(tmp_path), save_interval=2))
        got += rec.out[:4] if stop else rec.out
    assert got == ref.out and len(got) == 8


# ---------------------------------------------------------------------------
# files across the packages, callbacks, and what is left out
# ---------------------------------------------------------------------------
def test_pdparams_cross_between_the_packages(tmp_path):
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    jnet, tnet = _nets(21)
    jm = paddle.Model(jnet)
    jm.prepare(joptim.Adam(learning_rate=0.01, parameters=jnet.parameters()))
    jm.save(str(tmp_path / "jax"))
    _, other = _nets(22)
    tm = Model(other, device="cpu")
    tm.prepare(Adam(learning_rate=0.01, parameters=other.parameters()))
    tm.load(str(tmp_path / "jax"), reset_optimizer=True)
    want = np.asarray(jnet(paddle.to_tensor(x)).numpy())
    # the same weights; the two packages' matmuls round differently
    np.testing.assert_allclose(tm.predict_batch(x).numpy(), want, rtol=1e-6,
                               atol=1e-7)
    # and back: the port's file into a fresh JAX model
    tm.save(str(tmp_path / "port"))
    assert os.path.exists(str(tmp_path / "port.pdopt"))
    jnet2, _ = _nets(23)
    jm2 = paddle.Model(jnet2)
    jm2.load(str(tmp_path / "port"), reset_optimizer=True)
    np.testing.assert_array_equal(
        np.asarray(jnet2(paddle.to_tensor(x)).numpy()), want)
    from paddle_tpu_torch import framework
    sd = framework.load(str(tmp_path / "jax.pdparams"), return_numpy=True)
    assert isinstance(sd["0.weight"], np.ndarray)
    framework.save({"w": torch.ones(2, dtype=torch.bfloat16)},
                   str(tmp_path / "bf16.pdparams"))
    assert framework.load(str(tmp_path / "bf16.pdparams"))["w"].dtype \
        == torch.float32


def test_callbacks_and_accumulation(tmp_path):
    """LRScheduler advances per batch (and per epoch with by_epoch),
    EarlyStopping stops, ModelCheckpoint saves, and
    ``accumulate_grad_batches=2`` equals summed gradients of two batches
    stepped once."""
    data = _fit_batches(4)
    m = _fit_job()
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    m._optimizer.set_lr_scheduler(sched)
    m.fit(data, epochs=2, shuffle=False, verbose=0,
          callbacks=[LRScheduler(), LRScheduler(by_step=False, by_epoch=True),
                     ModelCheckpoint(save_dir=str(tmp_path))])
    assert sched.last_epoch == 4 * 2 + 2
    assert os.path.exists(str(tmp_path / "0.pdparams"))
    es = EarlyStopping(monitor="loss", mode="max", patience=0)
    m2 = _fit_job()
    m2.fit(data, epochs=5, shuffle=False, verbose=0, callbacks=[es])
    assert m2.stop_training
    a, b = _fit_job(), _fit_job()
    a.fit(data, epochs=1, shuffle=False, verbose=0, callbacks=[],
          accumulate_grad_batches=2)
    for i in (0, 2):
        for x, y in data[i:i + 2]:
            b.train_batch(x, y, update=False)
        b._optimizer.step()
        b._optimizer.clear_grad()
    for p, q in zip(a.network.parameters(), b.network.parameters()):
        assert torch.equal(p, q)


def test_left_out_options_raise():
    m = _fit_job()
    with pytest.raises(NotImplementedError, match="item 7"):
        m.prepare(amp_configs="O1")
    with pytest.raises(NotImplementedError, match="item 7"):
        m.save("x", training=False)
    with pytest.raises(NotImplementedError, match="item 7"):
        m.summary()
