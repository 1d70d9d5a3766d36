"""Port parity of ``paddle_tpu_torch.io`` and ``vision.datasets`` against
the JAX package's: the datasets, samplers and batch samplers give JAX's
indices for sequential order (and for ``DistributedBatchSampler``'s
epoch-seeded shuffle); ``DataLoader`` with 0 and 2 workers gives JAX's
batches, as CPU tensors; a loader with a ``torch.Generator`` replays its
order from ``generator_state()``; ``FakeImageNet`` / ``MNIST`` /
``Cifar10`` give JAX's samples; ``DatasetFolder`` reads local files as
JAX's does."""
import os

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu.vision import datasets as jds
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.vision import datasets as tds


class _Squares:
    """A map-style dataset of (x [3] f32, label int64, {"w": f32}) built
    the same way for either package's ``Dataset`` base."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return (r.standard_normal(3).astype(np.float32), np.int64(i % 5),
                {"w": np.float32(i * 0.5)})


def _ds(mod, n=23):
    return type("Squares", (_Squares, mod.Dataset), {})(n)


def _np(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if hasattr(obj, "_value"):
        return np.asarray(obj._value)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    return obj


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["sequence", "batch", "batch_drop_last",
                                  "distributed", "distributed_shuffle",
                                  "concat_subset_compose"])
def test_samplers_match_jax(name):
    out = []
    for mod in (jio, tio):
        ds = _ds(mod)
        if name == "sequence":
            got = list(mod.SequenceSampler(ds))
        elif name.startswith("batch"):
            got = list(mod.BatchSampler(ds, batch_size=4,
                                        drop_last=name.endswith("last")))
            got.append(len(mod.BatchSampler(ds, batch_size=4,
                                            drop_last=name.endswith("last"))))
        elif name.startswith("distributed"):
            got = []
            for rank in range(3):
                s = mod.DistributedBatchSampler(
                    ds, 4, num_replicas=3, rank=rank,
                    shuffle=name.endswith("shuffle"))
                s.set_epoch(2)
                got += [list(s), len(s)]
        else:
            c = mod.ConcatDataset([ds, _ds(mod, 5)])
            sub = mod.Subset(c, [27, 3, 24, 0])
            comp = mod.ComposeDataset([_ds(mod, 7), _ds(mod, 9)])
            got = [len(c), c[25], c[-1], len(sub), sub[0], len(comp),
                   comp[6]]
        out.append(got)
    _same(out[1], out[0])


def test_distributed_sampler_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    s = tio.DistributedBatchSampler(_ds(tio), 2)
    assert (s.nranks, s.local_rank) == (4, 3)
    assert list(s)[0] == [3, 7]


def _segments():
    return {f for f in os.listdir("/dev/shm") if f.startswith("psm_")} \
        if os.path.isdir("/dev/shm") else set()


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_matches_jax(workers):
    """Batches of nested samples (JAX's loader without workers), tensors on
    the CPU, the last batch short.  The workers fork from the forkserver,
    so their dataset is one that pickles by import path; a 2.4 MB batch
    crosses through shared memory, the last (0.8 MB) through the queue,
    and no segment is left behind."""
    if workers:
        before = _segments()
        jl = list(jio.DataLoader(jds.FakeImageNet(7, 256, 5), batch_size=3))
        loader = tio.DataLoader(tds.FakeImageNet(7, 256, 5), batch_size=3,
                                num_workers=workers)
    else:
        jl = list(jio.DataLoader(_ds(jio), batch_size=5))
        loader = tio.DataLoader(_ds(tio), batch_size=5)
    tl = list(loader)
    assert len(tl) == len(jl) == len(loader)
    for a, b in zip(jl, tl):
        assert all(t.device.type == "cpu" for t in _leaves(b))
        _same(b, a)
    if workers:
        assert _segments() <= before
    tensor_ds = tio.TensorDataset([torch.arange(6.0), torch.arange(6) * 2])
    got = list(tio.DataLoader(tensor_ds, batch_size=4))
    assert torch.equal(got[1][0], torch.tensor([4.0, 5.0]))


def _leaves(obj):
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _leaves(o)]
    return [obj]


def test_generator_order_replays_from_its_state():
    """A shuffling loader with a generator: the order is a function of the
    generator's state before the first epoch, which
    ``set_generator_state`` brings back (what a resumed ``fit`` uses)."""
    g = torch.Generator().manual_seed(3)
    loader = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True,
                            generator=g)
    start = loader.generator_state().clone()
    epochs = [[b[1].tolist() for b in loader] for _ in range(2)]
    assert epochs[0] != epochs[1]
    assert torch.equal(loader.generator_state(), start)
    other = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True,
                           generator=torch.Generator().manual_seed(99))
    other.set_generator_state(start)
    assert [[b[1].tolist() for b in other] for _ in range(2)] == epochs
    assert tio.DataLoader(_ds(tio)).generator_state() is None


def test_iterable_dataset_and_collate():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7, dtype=np.float32))

    got = list(tio.DataLoader(Stream(), batch_size=3))
    assert [b.tolist() for b in got] == [[0, 1, 2], [3, 4, 5], [6]]
    assert tio.default_collate_fn([1, 2]).tolist() == [1, 2]


@pytest.mark.parametrize("name", ["FakeImageNet", "MNIST", "Cifar10"])
def test_synthetic_datasets_match_jax(name):
    kw = dict(n=10, image_size=16, num_classes=7, seed=4) \
        if name == "FakeImageNet" else {}
    j, t = getattr(jds, name)(**kw), getattr(tds, name)(**kw)
    assert len(j) == len(t)
    for i in (0, 3, 9):
        _same(t[i], j[i])


def test_dataset_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for k in range(3):
            np.save(tmp_path / c / f"{k}.npy", rng.standard_normal(4))
        (tmp_path / c / "notes.txt").write_text("skipped")
    j, t = jds.ImageFolder(str(tmp_path)), tds.ImageFolder(str(tmp_path))
    assert t.class_to_idx == j.class_to_idx == {"cat": 0, "dog": 1}
    assert len(t) == len(j) == 6
    for i in range(6):
        _same(t[i], j[i])
