"""Data loading (port of ``paddle_tpu/io/__init__.py``; reference
python/paddle/io/ — Dataset, DataLoader reader.py:262 with multiprocess
workers dataloader/dataloader_iter.py).

Batches are collated in numpy on the host and handed out as CPU tensors;
the train step (``TrainStep``, ``hapi.Model``) moves each batch to the
module's device.  Workers (``num_workers > 0``) are forked from the
``forkserver`` process (the JAX package forks them from the main one), so
the dataset and the collate function must pickle by import path; they run
the dataset and the numpy collate only — they never touch torch's device
state — and hand each batch back through shared memory (arrays of
``SHM_MIN_BYTES`` or more) or the queue; the main process copies them out
and wraps them as tensors, in sampler order.  The JAX
package hands uniform numpy batches to a native C++ batcher when it is
built and falls back to this numpy collate; the batcher is not ported
(ROADMAP A item 7).

Samplers draw as JAX's do (``numpy``'s global state) unless given a
``torch.Generator`` (``RandomSampler(generator=)``, or ``DataLoader(
generator=)`` for a loader that shuffles), which makes the order a
function of the generator's state: ``DataLoader.generator_state()`` is that
state as it stood before the run's first epoch, what a checkpoint keeps so
a resumed ``fit`` replays the same batches.
"""
from __future__ import annotations

import bisect
import itertools
import math
import multiprocessing as mp
import os
import queue as queue_mod
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "DataLoader", "BatchSampler", "Sampler", "SequenceSampler",
           "RandomSampler", "WeightedRandomSampler", "DistributedBatchSampler",
           "default_collate_fn", "get_worker_info", "SubsetRandomSampler"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0)
        return self.datasets[ds_idx][off]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(n, float) for n in lengths):
        total = len(dataset)
        lengths = [int(math.floor(total * f)) for f in lengths]
        lengths[-1] += total - sum(lengths)
    perm = _permutation(sum(lengths), generator)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
    return out


def _permutation(n, generator):
    if isinstance(generator, torch.Generator):
        return torch.randperm(n, generator=generator).tolist()
    return np.random.permutation(n).tolist()


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or draws with replacement) of the indices, from
    ``generator`` (a ``torch.Generator``) or numpy's global state."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = self.generator
        if isinstance(g, torch.Generator):
            if self.replacement:
                return iter(torch.randint(0, n, (self.num_samples,),
                                          generator=g).tolist())
            return iter(torch.randperm(n, generator=g)[:self.num_samples]
                        .tolist())
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        perm = _permutation(len(self.indices), self.generator)
        return iter([self.indices[i] for i in perm])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray([float(w) for w in weights],
                                  dtype=np.float64).reshape(-1)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, generator=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, generator=generator)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _env_int(names, default):
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return default


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches (reference io/dataloader/batch_sampler.py
    DistributedBatchSampler): pads so every rank sees the same number of
    batches.  ``num_replicas`` / ``rank`` default to the environment's
    ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID`` (else ``WORLD_SIZE`` /
    ``RANK``, else a world of 1), as the JAX package reads them before its
    distributed environment starts."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else \
            _env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)
        self.local_rank = rank if rank is not None else \
            _env_int(("PADDLE_TRAINER_ID", "RANK"), 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) * 1.0 / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


def _collate_np(batch):
    """Stack samples into numpy arrays, recursing into tuples, lists and
    dicts (reference io/dataloader/collate.py default_collate_fn)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return np.stack([b.detach().cpu().numpy() for b in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return type(sample)(_collate_np(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: _collate_np([b[k] for b in batch]) for k in sample}
    return batch


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    return obj


def _to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_tensor(v) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    """Samples stacked into CPU tensors (numpy underneath)."""
    return _to_tensor(_collate_np(batch))


# arrays of at least this many bytes cross from a worker through shared
# memory: the pipe under the queue moves them much slower
SHM_MIN_BYTES = 1 << 20


class _Shared:
    """A numpy array a worker left in a shared-memory segment."""

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _to_shared(obj):
    """``obj`` with every large array moved into its own shared-memory
    segment, which the main process unlinks once it copied it out."""
    if isinstance(obj, np.ndarray) and obj.nbytes >= SHM_MIN_BYTES:
        seg = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        try:
            np.ndarray(obj.shape, obj.dtype, buffer=seg.buf)[...] = obj
        finally:
            seg.close()
        # the main process owns it from here (it unlinks it)
        resource_tracker.unregister(seg._name, "shared_memory")
        return _Shared(seg.name, obj.shape, obj.dtype.str)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_shared(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_shared(v) for k, v in obj.items()}
    return obj


def _from_shared(obj, keep=True):
    """The inverse of :func:`_to_shared`: each segment copied out (or, with
    ``keep=False``, dropped) and unlinked."""
    if isinstance(obj, _Shared):
        seg = shared_memory.SharedMemory(name=obj.name)
        try:
            return np.ndarray(obj.shape, np.dtype(obj.dtype),
                              buffer=seg.buf).copy() if keep else None
        finally:
            seg.close()
            seg.unlink()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_shared(o, keep) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_shared(v, keep) for k, v in obj.items()}
    return obj


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers):
    global _worker_info
    _worker_info = _WorkerInfo(worker_id, num_workers, dataset)
    collate = _collate_np if collate_fn is default_collate_fn else collate_fn
    while True:
        item = index_queue.get()
        if item is None:
            break
        seq, indices = item
        try:
            batch = _to_numpy(collate([dataset[i] for i in indices]))
            data_queue.put((seq, _to_shared(batch), None))
        except Exception as e:  # noqa: BLE001 — raised in the main process
            data_queue.put((seq, None, e))


class DataLoader:
    """reference io/reader.py:262 DataLoader: single or multi-process
    loading with prefetch (``num_workers`` workers, up to
    ``num_workers * prefetch_factor`` batches in flight).  With
    ``persistent_workers`` the workers outlive an epoch and serve every
    later one (``close()`` stops them; so does dropping the loader);
    without, each epoch starts and stops its own.  ``generator``: a
    ``torch.Generator`` for the order of a loader that shuffles."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, generator=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.persistent_workers = persistent_workers
        self._pool = None
        self._epoch = 0
        self.prefetch_factor = prefetch_factor
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self._start_state = None
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last,
                                              generator=generator)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # -- the order's generator -------------------------------------------
    def _generator(self):
        g = getattr(getattr(self.batch_sampler, "sampler", None),
                    "generator", None)
        return g if isinstance(g, torch.Generator) else None

    def generator_state(self):
        """The sampler generator's state before the run's first epoch drew
        its order (now, if none has), or None without a generator."""
        g = self._generator()
        if g is None:
            return None
        return self._start_state if self._start_state is not None \
            else g.get_state()

    def set_generator_state(self, state):
        self._generator().set_state(state)
        self._start_state = None

    def __iter__(self):
        g = self._generator()
        if g is not None and self._start_state is None:
            self._start_state = g.get_state()
        if self._iterable_mode:
            yield from self._iter_iterable()
        elif self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])
        else:
            yield from self._iter_multiprocess()

    def _iter_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _start_pool(self):
        # forked from the forkserver, a clean single-threaded process that
        # imported this module once: the main process holds CUDA state and
        # threads, which a plain fork would copy half-made into a worker,
        # and a spawn would import torch anew in every worker
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        data_queue = ctx.Queue()
        workers, index_queues = [], []
        for wid in range(self.num_workers):
            iq = ctx.Queue()
            w = ctx.Process(target=_worker_loop,
                            args=(self.dataset, iq, data_queue,
                                  self.collate_fn, wid, self.num_workers),
                            daemon=True)
            w.start()
            workers.append(w)
            index_queues.append(iq)
        return workers, index_queues, data_queue

    def close(self):
        """Stop persistent workers (a no-op without them)."""
        if self._pool is not None:
            pool, self._pool = self._pool, None
            _stop_workers(*pool)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def _iter_multiprocess(self):
        pool = self._pool or self._start_pool()
        if self.persistent_workers:
            self._pool = pool
        _, index_queues, data_queue = pool
        # results carry their epoch: a persistent pool may still send
        # batches of an epoch its consumer left early
        self._epoch += 1
        epoch = self._epoch
        try:
            batches = list(self.batch_sampler)
            n = len(batches)
            next_submit = next_yield = 0
            buffered = {}

            def submit():
                nonlocal next_submit
                index_queues[next_submit % self.num_workers].put(
                    ((epoch, next_submit), batches[next_submit]))
                next_submit += 1

            while next_submit < n \
                    and next_submit < self.num_workers * self.prefetch_factor:
                submit()
            while next_yield < n:
                while next_yield not in buffered:
                    (ep, seq), data, err = data_queue.get(
                        timeout=self.timeout if self.timeout else None)
                    if ep != epoch:
                        _from_shared(data, keep=False)
                        continue
                    if err is not None:
                        raise err
                    buffered[seq] = _from_shared(data)
                    if next_submit < n:
                        submit()
                yield _to_tensor(buffered.pop(next_yield))
                next_yield += 1
        finally:
            if not self.persistent_workers:
                _stop_workers(*pool)


def _stop_workers(workers, index_queues, data_queue, timeout=5.0):
    """Tell every worker to stop, drain what they still send (a worker
    exits only once its queue has flushed), then join; a worker still
    alive after ``timeout`` seconds is terminated."""
    for iq in index_queues:
        iq.put(None)
    deadline = time.monotonic() + timeout
    while any(w.is_alive() for w in workers) \
            and time.monotonic() < deadline:
        try:
            _from_shared(data_queue.get(timeout=0.05)[1], keep=False)
        except queue_mod.Empty:
            pass
    for w in workers:
        if w.is_alive():
            w.terminate()
        w.join()
