"""Paged-KV cache manager + continuous-batching serving engine.

Port of ``paddle_tpu/inference/paged.py``.  The model math lives in
``models/llama.build_llama_paged_decode``, the attention kernel in
``ops/paged_attention`` (CUDA, ``ops/csrc/ragged_paged_attention.cu``).

  * ``PagePool`` — refcounted page allocator over the shared KV page pool.
  * ``PrefixCache`` — automatic prefix caching over a chained SHA-256
    block-hash index; retired and preempted requests park their pages in it
    and later admissions attach the longest cached prefix read-only.  A
    cached partial page is copied before anyone writes into it
    (copy-on-write).
  * ``ServingEngine`` — a fixed set of decode slots stepped by K-step decode
    horizons; between horizons finished requests retire into the prefix
    cache and queued requests are admitted into the freed slots (dense
    prefill with the first token sampled, or suffix / chunked prefill
    after a cache hit or for a prompt longer than ``prefill_chunk``).
    ``speculative=K`` adds lossless self-speculative decoding: n-gram
    drafts (``_NgramDraft``) verified K + 1 positions at a time.
    ``kv_dtype="int8"|"fp8"`` stores the pages quantized with per-row
    scales; ``quantize=8`` snaps the weights onto the per-channel int8
    grid.

Pages are allocated lazily, one page at a time as decode crosses page
boundaries.  When the pool runs short the engine walks the degradation
ladder: evict unreferenced cached pages, then preempt the youngest slot
(its pages parked in the cache, the request requeued at the head for
re-prefill of prompt + emitted tokens, so greedy outputs stay step-exact).
Per-request deadlines (``submit(timeout=)``) retire overdue work wherever
it is, with ``Request.timed_out`` set; ``cancel`` drops a request.

Device state: the page pool ``[L, Hkv, NP + 1, ps, D]`` (the last page is
the trash page; a ``{"q": codes, "s": scales}`` dict per side with
``kv_dtype``) lives on the engine's device and is updated IN PLACE by
every prefill, chunk, decode or verify step, copy-on-write copy, restore
and KV import; the JAX engine donated and rebound it instead.  Host state
(slot table, page tables, lengths) is numpy, written once per dispatch
into static device buffers that every decode horizon and verify step
reads.  On a CUDA device each decode horizon ``(K, greedy)`` and the
verify step are captured once as CUDA graphs (one shared memory pool)
and replayed — the counterpart of the JAX engine's one compiled
executable per variant; prefill and prefill chunks stay eager, as their
shapes vary.  On the CPU the same functions run eagerly.

Double-buffered host loop (``overlap=True``): dispatch N's sampled token,
length, budget and done state stay on the device and feed dispatch N + 1,
which is enqueued before N's tokens are read; N's tokens reach the host
by one non-blocking copy into pinned memory behind a CUDA event, and the
drain waits on that event only.  CUDA launches are asynchronous, so no
host thread is needed (the JAX engine's dispatch thread exists because
buffer donation makes XLA's CPU dispatch synchronous): its ``_resolve``
(waiting on the thread's future) is the event wait of ``_Fetch.numpy``,
and stream order makes its ``_join_dispatch`` unnecessary — a prefill,
chunk or page copy issued after a dispatch runs after it on the card.
``quiesce()`` drains the pipeline to an exact host-visible boundary;
snapshots, cancellation, deadline sweeps of in-flight work, speculative
verify and the degradation ladder call it first.

Streaming: ``submit(..., on_token=cb)`` calls ``cb(tok)`` for every
emitted token in order, and ``Request.stream()`` iterates tokens as they
reach the host, driving the engine until the request retires.
``snapshot`` / ``restore`` serialize the engine (``"full_kv"``: the
referenced KV pages ride along; ``"compact"``: token prefixes, restored
by re-prefill), and ``export_kv`` / ``import_kv`` hand slot-resident
requests with their pages to another engine; the state dict and packet
keep the JAX engine's layout and numpy planes, so a packet crosses
between the two packages.

Observability: ``ServingEngine(..., telemetry=True)`` (or a configured
``observability.Telemetry``) threads request-lifecycle traces, latency
histograms (TTFT / TPOT / queue / per-phase host timing), the per-step pool
memory series, capture accounting and a crash flight recorder through the
step loop; ``stats_snapshot()`` returns an ``EngineStats`` whose ``delta``
is a window's exact activity.  Telemetry reads host clocks at the points
where the engine already syncs or launches: it adds no synchronising call
and changes no captured graph.  Off (the default) costs one ``None`` check
per hook site.

Fault points (``resilience.faults``): ``PagePool.alloc`` consults
``pagepool.alloc``; each ``step()`` consults ``serve.wedge``,
``serve.pool_pressure`` and ``serve.crash`` (phases ``sched`` and
``record``), as the JAX engine does.  ``serving.EngineSnapshotManager``
writes snapshots durably through the checkpoint commit protocol.

Tensor-parallel serving (``mesh=build_mesh({"mp": n})`` after
``init_parallel_env``): one engine a rank, each holding its shard of the
heads, the MLP and the pages; every rank runs the same host scheduler in
lockstep on the same submissions (the JAX engine is one controller over
the mesh).  Logits come out of each layer's all-reduce replicated, so
greedy tokens agree on every rank, and sampled ones too since every
rank's generator is seeded alike.  At tp > 1 the decode horizons and the
verify step run eagerly, not as CUDA graphs: collectives inside a
captured graph are not exercised on the card (one rank a card).
"""
from __future__ import annotations

import hashlib
import json
import math
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..distributed.topology import axis_group
from ..models.llama import (_mp_degree, _sample_per_request,
                            build_llama_paged_decode, gather_kv_pages,
                            make_paged_decode_horizon, scatter_kv_pages,
                            shard_llama_paged_params)
from ..observability.metrics import EngineStats
from ..observability.telemetry import Telemetry
from ..ops.paged_attention import (ragged_paged_attention,
                                   ragged_paged_attention_ref)
from ..resilience.faults import InjectedFault, fault_point
from ..serving.quant import page_bytes as _page_bytes
from ..serving.quant import quantize_params

__all__ = ["PagePool", "PrefixCache", "Request", "ServingEngine",
           "serve_requests", "prefix_chain_hashes", "PoolCapacityError",
           "AdmissionRejected", "EngineStalledError", "PageDoubleFreeError",
           "KVHandoffError"]


class PoolCapacityError(ValueError):
    """The request can NEVER fit the configured pool / page-table geometry
    (a sizing error, distinct from malformed input)."""


class AdmissionRejected(RuntimeError):
    """The bounded admission queue is full — backpressure; retry later."""


class EngineStalledError(RuntimeError):
    """run() made no progress for max_stall_steps consecutive steps (only
    reachable under a never-clearing injected pool fault or wedge)."""


class PageDoubleFreeError(RuntimeError):
    """free()/share() saw a page holding no reference (double free or
    foreign page), or the same page id twice within one free() batch."""


class KVHandoffError(RuntimeError):
    """An ``export_kv`` packet cannot splice into this engine: mismatched
    page geometry, KV dtype or tensor-parallel degree.  The caller's
    fallback is re-prefill (``adopt``)."""


class PagePool:
    """Fixed-size refcounted page allocator: page ids 0..num_pages-1, LIFO
    free list.  ``alloc`` returns pages at refcount 1; ``share`` adds a
    reference (the page appears in another page table or the prefix cache);
    ``free`` drops one and recycles the page at 0.  Double frees, foreign
    pages and duplicate ids in one batch raise ``PageDoubleFreeError``
    before any state changes."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        """Pages holding at least one reference."""
        return len(self._refs)

    @property
    def num_referenced(self) -> int:
        """Total references across all page tables + the prefix cache
        (>= num_allocated; the excess is prefix sharing)."""
        return sum(self._refs.values())

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def alloc(self, n: int):
        """Pop n pages at refcount 1; raises RuntimeError when the pool
        cannot satisfy the request (callers check ``num_free`` first).
        Consults the ``pagepool.alloc`` fault point: a 'trigger' spec forces
        the exhausted path, a 'raise' spec injects InjectedFault."""
        if n < 0:
            raise ValueError("alloc(n): n must be >= 0")
        injected = fault_point("pagepool.alloc", n=n, free=len(self._free))
        if n > len(self._free) or injected is not None:
            raise RuntimeError(
                f"PagePool exhausted{' (injected)' if injected else ''}: "
                f"requested {n} pages, {len(self._free)} free of "
                f"{self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages):
        """+1 reference on each page; sharing an unallocated page raises."""
        pages = [int(p) for p in pages]
        for p in pages:
            if p not in self._refs:
                raise PageDoubleFreeError(
                    f"PagePool.share: page {p} is not allocated")
        for p in pages:
            self._refs[p] += 1
        return pages

    def free(self, pages):
        """-1 reference on each page (the whole batch is validated first);
        a page returns to the free list when its last reference drops."""
        pages = [int(p) for p in pages]
        seen = set()
        for p in pages:
            if p in seen:
                raise PageDoubleFreeError(
                    f"PagePool.free: page {p} appears more than once in one "
                    f"free() batch")
            seen.add(p)
            if p not in self._refs:
                raise PageDoubleFreeError(
                    f"PagePool.free: page {p} is not allocated "
                    "(double free or foreign page)")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


_ROOT = b"\x00root"                   # parent digest of block 0


def _chain_digest(parent: bytes, block) -> bytes:
    """One link of the chained block hash: ``sha256(parent + tokens)``."""
    return hashlib.sha256(
        parent + np.ascontiguousarray(block, np.int32).tobytes()).digest()


def prefix_chain_hashes(tokens, page_size: int) -> list[bytes]:
    """Chained SHA-256 digests of every full ``page_size``-aligned block of
    ``tokens`` in chain order — digest i identifies the whole prefix
    through block i, exactly as :class:`PrefixCache` indexes it."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    ps = int(page_size)
    parent = _ROOT
    out: list[bytes] = []
    for i in range(len(tokens) // ps):
        parent = _chain_digest(parent, tokens[i * ps:(i + 1) * ps])
        out.append(parent)
    return out


class _CacheEntry:
    __slots__ = ("key", "parent", "page", "tokens", "tick", "children")

    def __init__(self, key, parent, page, tokens=None):
        self.key = key                # chained digest (None: partial tail)
        self.parent = parent          # parent block's digest (or _ROOT)
        self.page = page              # physical page id (cache holds 1 ref)
        self.tokens = tokens          # partial tail's token bytes, else None
        self.tick = 0
        self.children = 0             # cached entries chained under this one


class PrefixCache:
    """Automatic prefix cache over PagePool pages.

    Every page_size-aligned block hashes as ``sha256(parent_digest +
    block_tokens)``, so a dict lookup per block walks the radix path.
    Entries hold ONE pool reference each; ``lookup`` takes none (callers
    attach with ``PagePool.share``).  A retired sequence's trailing partial
    block is indexed by parent + exact token content; an admission that
    attaches it copies the page before writing into its tail.  Eviction is
    LRU over entries that are pure cache (refcount 1) and leaves of the
    hash chain."""

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = int(page_size)
        self._full: dict[bytes, _CacheEntry] = {}
        self._partial: dict[bytes, dict[bytes, _CacheEntry]] = {}
        self._tick = 0
        self.insertions = 0           # entries ever inserted
        self.evictions = 0            # entries ever evicted
        # optional ``notify(kind, digests)`` listener (kind "insert" |
        # "evict", digests = full-block chain digests): the fleet router
        # keeps its per-replica cached-chain summary current through it.
        # Partial tails are content-keyed, so they never notify.
        self.notify = None

    def __len__(self) -> int:
        return len(self._full) + sum(len(d) for d in self._partial.values())

    def pages(self):
        """Every page the cache holds a reference on (one per entry)."""
        for e in self._full.values():
            yield e.page
        for d in self._partial.values():
            for e in d.values():
                yield e.page

    def _touch(self, e: _CacheEntry):
        self._tick += 1
        e.tick = self._tick

    def chain_digests(self):
        """Every full-block chain digest indexed now (the router summary's
        seed for a replica whose cache was built before the listener
        attached, e.g. a snapshot-restored engine)."""
        return self._full.keys()

    def lookup(self, tokens):
        """Longest cached prefix of ``tokens`` -> (full_pages, partial):
        the page ids of the matched full blocks, and None or (page_id, m) —
        a cached partial page whose first m tokens extend the match.  The
        match is capped at len(tokens) - 1 so one token remains to
        prefill (its logits give the first sample)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        limit = len(tokens) - 1
        parent = _ROOT
        pages = []
        n = 0
        while (n + 1) * ps <= limit:
            key = _chain_digest(parent, tokens[n * ps:(n + 1) * ps])
            e = self._full.get(key)
            if e is None:
                break
            self._touch(e)
            pages.append(e.page)
            parent = key
            n += 1
        partial = None
        rem = tokens[n * ps:limit]
        if len(rem):
            best_m, best_e = 0, None
            for e in self._partial.get(parent, {}).values():
                et = np.frombuffer(e.tokens, np.int32)
                L = min(len(et), len(rem))
                m = 0
                while m < L and et[m] == rem[m]:
                    m += 1
                if m > best_m:
                    best_m, best_e = m, e
            if best_e is not None:
                self._touch(best_e)
                partial = (best_e.page, best_m)
        return pages, partial

    def register(self, tokens, pages, with_partial: bool = False):
        """Index this sequence's full blocks, plus the trailing partial
        block when ``with_partial`` (retire path — the page gets no more
        writes).  The cache takes its own reference on each newly inserted
        page; blocks already cached are left as they are."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        parent = _ROOT
        n_full = len(tokens) // ps
        inserted: list[bytes] = []
        for i in range(n_full):
            key = _chain_digest(parent, tokens[i * ps:(i + 1) * ps])
            e = self._full.get(key)
            if e is None:
                self.pool.share([pages[i]])
                e = _CacheEntry(key, parent, int(pages[i]))
                self._full[key] = e
                if parent in self._full:
                    self._full[parent].children += 1
                self.insertions += 1
                inserted.append(key)
            self._touch(e)
            parent = key
        if inserted and self.notify is not None:
            self.notify("insert", inserted)
        if with_partial:
            tail = np.ascontiguousarray(tokens[n_full * ps:], np.int32)
            if len(tail) and n_full < len(pages):
                tb = tail.tobytes()
                tails = self._partial.setdefault(parent, {})
                if tb not in tails:
                    self.pool.share([pages[n_full]])
                    e = _CacheEntry(None, parent, int(pages[n_full]),
                                    tokens=tb)
                    tails[tb] = e
                    if parent in self._full:
                        self._full[parent].children += 1
                    self.insertions += 1
                    self._touch(e)

    def _evictable(self):
        for d in self._partial.values():
            for e in d.values():
                if self.pool.refcount(e.page) == 1:
                    yield e
        for e in self._full.values():
            if e.children == 0 and self.pool.refcount(e.page) == 1:
                yield e

    def evict(self, n_pages: int) -> int:
        """Drop up to n_pages LRU cache-only leaf entries; returns how many
        pages went back to the free list."""
        freed = 0
        while freed < n_pages:
            cand = None
            for e in self._evictable():
                if cand is None or e.tick < cand.tick:
                    cand = e
            if cand is None:
                break
            self._drop(cand)
            freed += 1
        self.evictions += freed
        return freed

    def _drop(self, e: _CacheEntry):
        if e.tokens is None:
            del self._full[e.key]
            if self.notify is not None:
                self.notify("evict", [e.key])
        else:
            tails = self._partial[e.parent]
            del tails[e.tokens]
            if not tails:
                del self._partial[e.parent]
        if e.parent in self._full:
            self._full[e.parent].children -= 1
        self.pool.free([e.page])


class _NgramDraft:
    """Prompt-lookup n-gram draft proposer (self-speculative decoding — no
    draft model): a suffix-match index over the request's prompt + emitted
    tokens.  Each 1..max_n-gram maps to the start of its most recent
    continuation; ``propose(k)`` returns up to k tokens that followed the
    LONGEST matching suffix n-gram the last time it occurred, extended
    periodically at the match lag when the match runs off the end."""

    __slots__ = ("toks", "_idx")

    def __init__(self, tokens, max_n: int = 3):
        self._idx = [dict() for _ in range(int(max_n))]  # n-grams, n = j + 1
        self.toks: list[int] = []
        for t in np.asarray(tokens, np.int32).reshape(-1):
            self.append(int(t))

    def append(self, tok: int):
        self.toks.append(int(tok))
        # index the n-grams ending at the PREVIOUS position: every indexed
        # occurrence has a continuation, and the current suffix can never
        # match itself
        e = len(self.toks) - 1            # continuation start
        if e <= 0:
            return
        for n in range(1, min(e, len(self._idx)) + 1):
            self._idx[n - 1][tuple(self.toks[e - n:e])] = e

    def propose(self, k: int) -> list:
        """Up to k draft tokens continuing the longest-matching suffix
        n-gram's most recent earlier occurrence; [] when nothing matches."""
        if k <= 0:
            return []
        T = len(self.toks)
        for n in range(min(T, len(self._idx)), 0, -1):  # longest n first
            pos = self._idx[n - 1].get(tuple(self.toks[-n:]))
            if pos is None:
                continue
            out = []
            for i in range(k):
                src = pos + i
                out.append(self.toks[src] if src < T else out[src - T])
            return out
        return []


@dataclass
class Request:
    """One serving request: prompt + generation budget + sampling params."""
    rid: int
    prompt: np.ndarray                 # int32 [T]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int | None = None
    deadline: float | None = None      # absolute engine-clock cutoff
    # filled by the engine
    generated: list = field(default_factory=list)
    submit_time: float = 0.0
    admit_time: float = 0.0            # first admission into a slot (kept
                                       #   across preemption re-admissions)
    first_token_time: float = 0.0
    finish_time: float = 0.0
    timed_out: bool = False            # retired overdue (possibly partial)
    preemptions: int = 0               # times evicted + requeued mid-flight
    cached_prefix_tokens: int = 0      # prefix-cache tokens attached
    draft_proposed: int = 0            # speculative draft tokens proposed
    draft_accepted: int = 0            #   ... verified AND emitted
    trace_id: int | None = None        # fleet-wide stitching id (stored)
    # streaming front end (not serialized; a restored request streams
    # through a fresh subscription)
    on_token: object | None = field(default=None, repr=False, compare=False)
    _engine: object | None = field(default=None, repr=False, compare=False)

    @property
    def draft_accept_rate(self) -> float:
        """Fraction of the proposed draft tokens that were accepted."""
        return self.draft_accepted / self.draft_proposed \
            if self.draft_proposed else 0.0

    @property
    def retire_time(self) -> float:
        """When the request left the engine (finish, deadline or queued
        timeout): an alias of finish_time."""
        return self.finish_time

    @property
    def queue_time(self) -> float:
        """Seconds waiting for the first admission (0.0 until admitted)."""
        return self.admit_time - self.submit_time if self.admit_time else 0.0

    @property
    def ttft(self) -> float:
        """Time to first token, seconds (0.0 until the first token)."""
        return self.first_token_time - self.submit_time \
            if self.first_token_time else 0.0

    @property
    def prefill_time(self) -> float:
        """First-admission prefill latency: ttft minus the queue wait."""
        if not (self.first_token_time and self.admit_time):
            return 0.0
        return self.first_token_time - self.admit_time

    @property
    def tpot(self) -> float:
        """Mean seconds per output token after the first (0.0 until retired
        with at least 2 tokens)."""
        n = len(self.generated) - 1
        if n <= 0 or not self.first_token_time or not self.finish_time:
            return 0.0
        return (self.finish_time - self.first_token_time) / n

    @property
    def output_ids(self) -> np.ndarray:
        return np.concatenate([self.prompt,
                               np.asarray(self.generated, np.int32)])

    def stream(self, max_stall_steps: int = 1000,
               cancel_on_close: bool = True):
        """Iterate this request's tokens in emission order, driving the
        owning engine between yields until the request retires.  The
        streamed sequence is exactly the final ``generated`` record; after
        retirement it replays the record.  Raises ``EngineStalledError``
        after ``max_stall_steps`` consecutive no-progress engine steps.

        A consumer that exits early (``break``, ``close()``, or the
        generator being garbage-collected) cancels the request, unless
        ``cancel_on_close=False``; normal exhaustion retires the request
        first, so completion never cancels anything."""
        i = 0
        stalled = 0
        try:
            while True:
                while i < len(self.generated):
                    yield self.generated[i]
                    i += 1
                if self.finish_time:
                    return
                eng = self._engine() if self._engine is not None else None
                if eng is None:
                    raise RuntimeError(
                        "Request.stream: the owning engine is gone and the "
                        "request never retired")
                stalled = 0 if eng.step() else stalled + 1
                if stalled >= max_stall_steps:
                    raise EngineStalledError(
                        f"Request.stream: no engine progress for {stalled} "
                        f"consecutive steps waiting on rid={self.rid}")
        finally:
            if cancel_on_close and not self.finish_time:
                eng = self._engine() if self._engine is not None else None
                if eng is not None:
                    eng.cancel(self.rid)


class _Slot:
    __slots__ = ("req", "pages", "pending", "pending_dev", "admit_seq",
                 "prefill_pos", "ctx", "resuming", "chunk_step", "draft",
                 "spec_k")

    def __init__(self, req, pages, pending, admit_seq=0):
        self.req = req
        self.pages = pages             # physical page ids, in order
        self.pending = pending         # last sampled token, not yet cached
        self.pending_dev = None        # overlap mode: the admission-sampled
                                       #   first token as a _Fetch, still
                                       #   unrecorded (drained later)
        self.admit_seq = admit_seq     # monotonically increasing admit order
        self.prefill_pos = None        # tokens prefilled so far; None once
        self.ctx = None                #   decoding (chunked-prefill state)
        self.resuming = False          # re-admission after preemption
        self.chunk_step = -1           # engine step of the last chunk run
        self.draft = None              # _NgramDraft (speculative greedy)
        self.spec_k = 0                # adaptive per-slot draft length


class _LaneRec:
    """One lane of an in-flight decode dispatch: the slot it was dispatched
    for, whether the drain also records the slot's admission-deferred first
    token, and, for a budget-predicted retirement whose slot was already
    handed to a successor, the detached state (``retiring`` and the cache
    length the predecessor had when it was detached)."""
    __slots__ = ("s", "slot", "take_first", "retiring", "base_len")

    def __init__(self, s, slot, take_first):
        self.s = s
        self.slot = slot
        self.take_first = take_first
        self.retiring = False
        self.base_len = 0


class _Inflight:
    """One decode dispatch not yet drained: its tokens on their way to the
    host (``out``, a :class:`_Fetch`), its horizon ``K``, the lane records
    the drain replays, ``srcs`` — slot identity per lane at dispatch
    time, so the next dispatch carries on the device only lanes whose slot
    is unchanged — and ``overlapped``, whether an overlap engine issued it
    (the telemetry phase names of its drain)."""
    __slots__ = ("out", "K", "lanes", "srcs", "overlapped")

    def __init__(self, out, K, lanes, srcs, overlapped):
        self.out = out
        self.K = K
        self.lanes = lanes
        self.srcs = srcs
        self.overlapped = overlapped


class _Fetch:
    """A device tensor on its way to the host.  On a CUDA device: a
    non-blocking copy into pinned memory behind an event, so reading it
    waits for the work that produced it and for nothing enqueued later.
    On the CPU: a copy.  ``dev`` keeps the device tensor."""
    __slots__ = ("dev", "host", "event")

    def __init__(self, t):
        self.dev = t
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def item(self) -> int:
        return int(self.numpy())


# the launch counters a dispatch can tick: a replay adds what its capture
# added, since the wrappers' Python does not run on a replay
_COUNTED = ((ragged_paged_attention, "launches"),
            (ragged_paged_attention, "quant_launches"),
            (ragged_paged_attention, "combine_launches"),
            (ragged_paged_attention_ref, "calls"))


def _counts():
    return [getattr(fn, attr) for fn, attr in _COUNTED]


class _Captured:
    """A dispatch function ``fn()`` over an engine's static device buffers.
    On the CPU every call runs ``fn``.  On a CUDA device the first call runs
    it eagerly (this dispatch, and the warm-up: libraries load, cuBLAS
    picks its kernels), then captures it as a ``torch.cuda.CUDAGraph`` in
    the memory pool ``pool``; later calls replay the graph, whose outputs
    (``out``) the next replay of any graph of the pool may overwrite, so
    callers consume them first.  ``generator``: the torch.Generator a
    sampling graph draws from.  ``on_capture(name, n, dur_s)``, when given,
    hears of each capture with the wall seconds of its warm-up run and the
    capture together (the counterpart of a compile-cache miss).  A failed
    capture or replay raises."""

    def __init__(self, fn, pool, generator=None, name="dispatch",
                 on_capture=None):
        self.fn = fn
        self.pool = pool               # None: the CPU
        self.generator = generator
        self.name = name
        self.on_capture = on_capture
        self.graph = None
        self.out = None
        self.added = None              # launch counts one replay adds

    def __call__(self):
        if self.pool is None:
            return self.fn()
        if self.graph is None:
            t0 = time.perf_counter()
            out = self.fn()
            self._capture()
            if self.on_capture is not None:
                self.on_capture(self.name, 1, time.perf_counter() - t0)
            return out
        self.graph.replay()
        for (fn, attr), n in zip(_COUNTED, self.added):
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = _counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn()
        finally:
            after = _counts()
            for (fn, attr), n in zip(_COUNTED, before):
                setattr(fn, attr, n)
        self.added = [a - b for a, b in zip(after, before)]
        self.graph, self.out = graph, out


# every live engine, for the tests' page-refcount leak guard
_LIVE_ENGINES: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()


class ServingEngine:
    """Continuous-batching decode engine over the paged KV cache.

    ``params``: the ``(embed, block, head)`` tensor dicts
    (``models.llama.init_llama_params`` or ``models.convert``), moved to
    ``device`` if they live elsewhere.  ``device=None`` means ``"cuda"`` and
    raises without a card; the tests pass ``device="cpu"``.

    ``prefix_cache=True`` (default) turns on automatic prefix caching;
    ``prefill_chunk=N`` bounds any one prefill dispatch to N tokens,
    interleaving long prompts with decode horizons; ``decode_horizon=K``
    runs K decode steps per dispatch with per-slot freeze on EOS / budget.
    ``speculative=K`` verifies n-gram drafts (n up to ``spec_max_ngram``)
    of greedy requests K + 1 positions per dispatch, lossless under greedy
    decoding; steps with no draft run the decode horizon.
    ``kv_dtype="int8"|"fp8"`` stores the KV pages quantized with one f32
    absmax scale per (page, kv head, token row); ``quantize=8`` (or True /
    "int8") snaps the weights onto the per-channel int grid.
    ``overlap=True`` double-buffers the host loop: step N + 1 is scheduled
    and dispatched while step N's horizon is in flight, with the token /
    length / budget / done state carried on the device, and N's tokens
    drained one dispatch behind (``quiesce()`` forces an exact boundary);
    greedy outputs equal ``overlap=False``'s.
    ``attention_impl``: "auto" (the CUDA kernels on the card, the plain
    version on the CPU), "kernel", or "ref" (the plain version always).
    Sampling draws from one ``torch.Generator`` seeded with ``seed`` on the
    engine's device; on a CUDA device the decode horizons and the verify
    step run as captured CUDA graphs (module docstring), and a sampled
    graph's replays advance that generator, so sampled streams differ from
    an eager engine's draws (greedy streams are equal).
    ``telemetry=True`` (or an ``observability.Telemetry``) records
    request-lifecycle traces, latency histograms, the memory series and the
    flight recorder without touching outputs; the engine's timestamps then
    come from the telemetry's clock.  ``name`` rides the ``serve.crash`` /
    ``serve.wedge`` fault-point ctx, so a drill can target one engine.
    ``mesh`` (a ``distributed.topology.build_mesh`` mesh) with more than one
    rank on ``mp_axis`` makes this rank's engine one part of a
    tensor-parallel model (``models.llama.build_llama_paged_decode``): it
    takes the full parameters and keeps its shard, its pages hold its KV
    heads (``page_bytes`` is one rank's), and ``quantized_allreduce``
    (on only at tp > 1) sends each layer's all-reduce through the EQuARX
    int8 grid.  Every rank constructs its engine alike and makes the same
    calls in the same order; KV packets and snapshots gather the heads into
    JAX's whole planes, stamped with ``tp``.  At tp > 1 nothing is captured
    as a CUDA graph (module docstring)."""

    def __init__(self, params, config, num_slots: int = 4,
                 page_size: int = 16, num_pages: int | None = None,
                 max_pages_per_seq: int | None = None, dtype=None,
                 attention_impl: str = "auto", prompt_bucket: int = 32,
                 decode_horizon: int = 8, seed: int = 0,
                 max_queue: int | None = None, prefix_cache: bool = True,
                 prefill_chunk: int | None = None,
                 speculative: int | None = None, spec_max_ngram: int = 3,
                 overlap: bool = False,
                 telemetry: "Telemetry | bool | None" = None,
                 name: str = "engine", kv_dtype: str | None = None,
                 quantize=None, device=None, mesh=None, mp_axis: str = "mp",
                 quantized_allreduce: bool = False):
        self.device = resolve_device(device)
        self.name = str(name)
        # tensor-parallel serving: the mesh's degree over mp_axis; the
        # scheduler below never reads it (every host scalar is replicated)
        self.mesh = mesh
        self.mp_axis = str(mp_axis)
        self.tp = _mp_degree(mesh, self.mp_axis)
        self.quantized_allreduce = bool(quantized_allreduce and self.tp > 1)
        self._group = axis_group(self.mp_axis, mesh) if self.tp > 1 else None
        self.config = config
        self.params = tuple({k: v.to(self.device) for k, v in tree.items()}
                            for tree in params)
        self.kv_dtype = None if kv_dtype is None else str(kv_dtype)
        self.quantize_bits = None
        if quantize:
            self.quantize_bits = 8 if quantize is True or quantize == "int8" \
                else int(quantize)
            self.params = quantize_params(self.params,
                                          bits=self.quantize_bits)
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        cap_pages = math.ceil(config.max_position_embeddings / page_size)
        self.max_pages_per_seq = int(max_pages_per_seq or cap_pages)
        if num_pages is None:
            num_pages = self.num_slots * self.max_pages_per_seq
        self.pool = PagePool(num_pages, page_size)
        self.cache = PrefixCache(self.pool, page_size) if prefix_cache \
            else None
        self.prefill_chunk = None if prefill_chunk is None \
            else max(1, int(prefill_chunk))
        self.prompt_bucket = int(prompt_bucket)
        self.decode_horizon = max(1, int(decode_horizon))
        self.speculative = 0 if not speculative else int(speculative)
        self.spec_max_ngram = max(1, int(spec_max_ngram))
        self.overlap = bool(overlap)
        self._inflight: _Inflight | None = None
        # telemetry=True -> a default Telemetry; None/False -> off, where
        # every hook site is one `is not None` check
        self.telemetry: Telemetry | None = \
            Telemetry() if telemetry is True else (telemetry or None)
        # one clock domain: request timestamps and deadlines share the
        # telemetry's clock when one is attached
        self._clock = self.telemetry.clock if self.telemetry is not None \
            else time.perf_counter
        self._dtype = dtype
        self._page_bytes = None        # lazy page_bytes cache
        (init_pages, self._prefill, self._prefill_chunk_fn, decode_step,
         self._verify_fn) = build_llama_paged_decode(
            config, page_size=page_size, num_pages=num_pages, dtype=dtype,
            attention_impl=attention_impl, device=self.device,
            kv_dtype=self.kv_dtype, mesh=mesh, mp_axis=self.mp_axis,
            quantized_allreduce=self.quantized_allreduce)
        if self.tp > 1:
            # the engine takes the full parameters, as JAX's does, and keeps
            # this rank's shard (after the build's head-divisibility guard)
            self.params = shard_llama_paged_params(
                self.params, self._group.rank, self.tp)
        pages = init_pages()
        self._pages_k, self._pages_v = pages["k"], pages["v"]
        self._horizon = make_paged_decode_horizon(decode_step)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        # the captured graphs' one memory pool (None: eager, on the CPU and
        # at tp > 1, where a graph would hold the layers' collectives)
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" and self.tp == 1 else None
        self._horizon_runs: dict = {}  # (K, greedy) -> _Captured
        self._verify_run = None        # _Captured verify step
        self._init_buffers()

        # host-side slot state
        S, P = self.num_slots, self.max_pages_per_seq
        self._slots: list[_Slot | None] = [None] * S
        self._page_tables = np.zeros((S, P), np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._temps = np.zeros((S,), np.float32)
        self._top_ps = np.ones((S,), np.float32)
        self._queue: deque[Request] = deque()
        self._finished: dict[int, Request] = {}
        self._next_rid = 0
        self.max_queue = None if max_queue is None else int(max_queue)
        self._admit_seq = 0
        self._pressure = False         # this-step injected pool pressure
        self._step_seq = 0             # step() invocations (chunk pacing)
        self.steps_run = 0             # decode-horizon + verify dispatches
        self.decode_model_steps = 0    # decode_step calls (K per horizon)
        self.prefill_chunks = 0        # prefill_chunk dispatches
        self.verify_steps = 0          # speculative verify dispatches
        self.draft_tokens_proposed = 0  # draft tokens sent to verify
        self.draft_tokens_accepted = 0  # ... accepted and emitted
        self.tokens_generated = 0
        self.preemptions = 0
        self.timeouts = 0              # deadline retirements
        self.rejections = 0
        self.cache_hits = 0            # admissions that attached a prefix
        self.cache_hit_tokens = 0      # prefill tokens skipped via the cache
        self.prefill_tokens = 0        # prefill tokens actually executed
        self.cache_evictions = 0
        self.cow_copies = 0
        self.overlap_steps = 0         # dispatches issued while the previous
                                       #   one was still in flight
        self.fused_sample_steps = 0    # dispatches whose tokens were chosen
                                       #   on the device
        self.quiesces = 0              # pipeline drains forced by an
                                       #   exactness point
        self.kv_exports = 0            # export_kv packets produced
        self.kv_imports = 0            # import_kv packets spliced in
        self.kv_pages_exported = 0     # pages shipped in those packets
        self.kv_pages_imported = 0
        _LIVE_ENGINES.add(self)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _init_buffers(self):
        """The static device buffers every decode horizon and verify step
        reads (a captured graph holds their addresses): one int32 and one
        f32 tensor, filled from host staging arrays of the same layout by
        one copy each per dispatch (``_upload``), plus the device-written
        first tokens and the carried horizon state."""
        S, P = self.num_slots, self.max_pages_per_seq
        Q = self.speculative + 1 if self.speculative else 0
        ints = (("tables", S * P), ("toks", S), ("lengths", S),
                ("remaining", S), ("eos", S), ("active", S), ("carry", S),
                ("defer", S), ("vtoks", S * Q), ("n_q", S))
        n = sum(k for _, k in ints)
        self._host_i = np.zeros((n,), np.int32)
        self._host_f = np.zeros((2 * S,), np.float32)
        self._dev_i = torch.zeros((n,), dtype=torch.int32, device=self.device)
        self._dev_f = torch.zeros((2 * S,), dtype=torch.float32,
                                  device=self.device)
        self._h, self._d = {}, {}
        off = 0
        for name, k in ints:
            self._h[name] = self._host_i[off:off + k]
            self._d[name] = self._dev_i[off:off + k]
            off += k
        for i, name in enumerate(("temps", "top_ps")):
            self._h[name] = self._host_f[i * S:(i + 1) * S]
            self._d[name] = self._dev_f[i * S:(i + 1) * S]
        for name, shape in (("tables", (S, P)), ("vtoks", (S, Q))):
            self._h[name] = self._h[name].reshape(shape)
            self._d[name] = self._d[name].view(shape)
        z = torch.zeros((S,), dtype=torch.int32, device=self.device)
        self._d.update(first=z.clone(), c_toks=z.clone(), c_lengths=z.clone(),
                       c_rem=z.clone(), c_done=z.clone().bool())

    def _upload(self):
        """Copy the host staging arrays into the static device buffers: on
        a CUDA device through pinned memory, non-blocking (the host cache
        keeps the pinned block until the copy has run)."""
        for host, dev in ((self._host_i, self._dev_i),
                          (self._host_f, self._dev_f)):
            t = torch.from_numpy(host)
            if dev.is_cuda:
                t = t.pin_memory()
            dev.copy_(t, non_blocking=True)

    def _horizon_exec(self, K: int, greedy: bool) -> _Captured:
        """The decode horizon ``(K, greedy)`` over the static buffers: lanes
        marked ``carry`` take their token / length / budget / done from the
        previous horizon's outputs (kept on the device), lanes marked
        ``defer`` take the admission's device-sampled first token, the rest
        the host values; the outputs are carried on for the next horizon.
        Returns ``out [S, K]``.  The closure holds the tensors it reads,
        not the engine."""
        run = self._horizon_runs.get((K, greedy))
        if run is None:
            d, horizon, params, gen = self._d, self._horizon, self.params, \
                self._gen
            pk, pv = self._pages_k, self._pages_v

            def fn():
                cm = d["carry"] != 0
                toks = torch.where(d["defer"] != 0, d["first"],
                                   torch.where(cm, d["c_toks"], d["toks"]))
                out, toks, lengths, rem, done, _, _ = horizon(
                    params, toks,
                    torch.where(cm, d["c_lengths"], d["lengths"]),
                    d["tables"], pk, pv, d["active"] != 0, gen, d["temps"],
                    d["top_ps"], torch.where(cm, d["c_rem"], d["remaining"]),
                    d["eos"], cm & d["c_done"], K=K, greedy=greedy)
                for name, t in (("c_toks", toks), ("c_lengths", lengths),
                                ("c_rem", rem), ("c_done", done)):
                    d[name].copy_(t)
                return out

            run = self._horizon_runs[K, greedy] = _Captured(
                fn, self._graph_pool, None if greedy else gen,
                name="decode_step", on_capture=self._capture_hook())
        return run

    def _verify_exec(self) -> _Captured:
        """The verify step over the static buffers (``[S, K + 1]`` queries:
        one graph per engine K); returns ``(logits0, greedy tokens)``."""
        if self._verify_run is None:
            d, verify, params = self._d, self._verify_fn, self.params
            pk, pv = self._pages_k, self._pages_v

            def fn():
                logits0, gtoks, _, _ = verify(params, d["vtoks"],
                                              d["lengths"], d["tables"], pk,
                                              pv, d["n_q"])
                return logits0, gtoks

            self._verify_run = _Captured(fn, self._graph_pool,
                                         name="verify_step",
                                         on_capture=self._capture_hook())
        return self._verify_run

    def _capture_hook(self):
        """The capture-accounting callback of a ``_Captured``: reports a
        capture to the telemetry (``Telemetry.compiled``), if any.  It holds
        the engine weakly, as the dispatch closures hold no engine."""
        ref = weakref.ref(self)

        def hook(name, n, dur_s):
            eng = ref()
            if eng is not None and eng.telemetry is not None:
                eng.telemetry.compiled(name, n, dur_s)
        return hook

    def jit_variants(self) -> dict:
        """{model fn name: dispatch variants built}: the decode horizons
        (one per ``(K, greedy)``) and the verify step (one per engine).  On
        a CUDA device each is one captured CUDA graph."""
        return {"decode_step": len(self._horizon_runs),
                "verify_step": int(self._verify_run is not None)}

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_p: float = 1.0,
               eos_token_id: int | None = None, timeout: float | None = None,
               on_token=None, trace_id: int | None = None) -> int:
        """Queue one request; returns its rid.  Raises
        ``PoolCapacityError`` for a request that can never fit the pool
        geometry, ``AdmissionRejected`` when the bounded queue is full, and
        ValueError for malformed input.  ``timeout`` (seconds from now)
        retires the request wherever it is once overdue, with
        ``Request.timed_out`` set.  ``on_token(tok)`` is called for every
        emitted token in order, when the token reaches the host (the step's
        sync, or the overlap drain).  ``trace_id`` is stored on the
        request."""
        now = self._clock()
        return self._enqueue(
            prompt, [], max_new_tokens, temperature, top_p, eos_token_id,
            None if timeout is None else now + float(timeout), now,
            on_token=on_token, trace_id=trace_id)

    def adopt(self, prompt, generated=(), max_new_tokens: int = 32,
              temperature: float = 0.0, top_p: float = 1.0,
              eos_token_id: int | None = None,
              deadline: float | None = None,
              trace_id: int | None = None) -> int:
        """Queue a request mid-flight: ``prompt`` with ``generated`` tokens
        already emitted elsewhere, continued from exactly that point by the
        preemption-resume path (re-prefill of prompt + generated[:-1], the
        last token pending), so greedy continuation is bit-exact.
        ``deadline`` is an absolute engine-clock cutoff."""
        generated = [int(t) for t in generated]
        if max_new_tokens >= 1 and len(generated) >= max_new_tokens:
            raise ValueError(
                f"adopt: {len(generated)} tokens already emitted >= "
                f"max_new_tokens={max_new_tokens}: the request is complete")
        if eos_token_id is not None and eos_token_id in generated:
            raise ValueError("adopt: generated already contains "
                             "eos_token_id: the request is complete")
        return self._enqueue(prompt, generated, max_new_tokens, temperature,
                             top_p, eos_token_id, deadline, self._clock(),
                             trace_id=trace_id)

    def _enqueue(self, prompt, generated, max_new_tokens, temperature,
                 top_p, eos_token_id, deadline, now, on_token=None,
                 trace_id=None) -> int:
        """Validation, capacity check, backpressure and Request
        construction, shared by submit and adopt."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + int(max_new_tokens)
        if total > self.config.max_position_embeddings:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the model context "
                f"{self.config.max_position_embeddings}")
        # the cache holds total-1 tokens (the final sampled token is never
        # written); it must fit this request's page-table row
        need = math.ceil((total - 1) / self.page_size)
        if need > self.max_pages_per_seq:
            raise PoolCapacityError(
                f"request needs {need} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        if need > self.pool.num_pages:
            raise PoolCapacityError(
                f"request needs {need} pages but the pool only has "
                f"{self.pool.num_pages} — raise num_pages")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.rejections += 1
            if self.telemetry is not None:
                self.telemetry.rejected(len(self._queue), self.max_queue)
            raise AdmissionRejected(
                f"admission queue full ({len(self._queue)}/{self.max_queue} "
                f"waiting) — backpressure, retry later")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_p=float(top_p),
            eos_token_id=eos_token_id, submit_time=now, deadline=deadline,
            generated=list(generated), on_token=on_token,
            _engine=weakref.ref(self),
            trace_id=None if trace_id is None else int(trace_id))
        self._queue.append(req)
        if self.telemetry is not None:
            self.telemetry.submitted(req, queue_depth=len(self._queue))
        return rid

    def lookup(self, rid: int) -> Request | None:
        """The live Request for ``rid`` wherever it is (slot, queue,
        finished, or a detached retirement still in flight); None for an
        unknown rid."""
        r = self._finished.get(rid)
        if r is not None:
            return r
        for slot in self._slots:
            if slot is not None and slot.req.rid == rid:
                return slot.req
        for r in self._queue:
            if r.rid == rid:
                return r
        if self._inflight is not None:
            for lane in self._inflight.lanes:
                if lane.retiring and lane.slot.req.rid == rid:
                    return lane.slot.req
        return None

    def cancel(self, rid: int) -> bool:
        """Drop a request wherever it is, recording no result: a queued
        request leaves the queue, a running slot is released (its written
        KV parks in the prefix cache first), a finished record is
        forgotten.  A rid riding the pipeline quiesces it first.  Returns
        True when the rid was found."""
        if any(sl is not None and sl.req.rid == rid for sl in self._slots) \
                or (self._inflight is not None
                    and any(ln.slot.req.rid == rid
                            for ln in self._inflight.lanes)):
            self.quiesce()
        live = False
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.req.rid == rid:
                self._register_slot(s, with_partial=True)
                self._release_slot(s)
                live = True
                break
        if not live:
            for r in self._queue:
                if r.rid == rid:
                    self._queue.remove(r)
                    live = True
                    break
        if live and self.telemetry is not None:
            # a cancel terminates the live trace record (a finished rid's
            # record already terminated at retirement)
            self.telemetry.cancelled(rid)
        return live or self._finished.pop(rid, None) is not None

    # -- internals ---------------------------------------------------------
    def _avail(self) -> int:
        """Free pages as this step sees them: zero while an injected
        ``serve.pool_pressure`` window is active (exhaustion drills)."""
        return 0 if self._pressure else self.pool.num_free

    def _evict(self, n: int) -> int:
        """Ladder rung between stall and preempt: reclaim up to n pages
        from the prefix cache (LRU leaf-first)."""
        if self.cache is None or n <= 0:
            return 0
        freed = self.cache.evict(n)
        self.cache_evictions += freed
        if self.telemetry is not None:
            # recorded even at freed == 0: walking this rung is what the
            # flight-recorder ladder shows (admit -> evict -> preempt)
            self.telemetry.evicted(requested=n, freed=freed)
        return freed

    def _register_pages(self, slot, valid: int, with_partial: bool):
        """Index a slot's first ``valid`` written tokens into the prefix
        cache."""
        if self.cache is None or valid <= 0:
            return
        seq = np.concatenate(
            [slot.req.prompt, np.asarray(slot.req.generated, np.int32)])
        self.cache.register(seq[:valid], slot.pages,
                            with_partial=with_partial)

    def _register_slot(self, s: int, with_partial: bool):
        self._register_pages(self._slots[s], int(self._lengths[s]),
                             with_partial)

    def _release_slot(self, s: int):
        slot = self._slots[s]
        self.pool.free(slot.pages)
        self._slots[s] = None
        self._page_tables[s] = 0
        self._lengths[s] = 0
        return slot

    def _finish(self, s: int):
        # retire INTO the cache: the pages stay indexed until evicted
        self._register_slot(s, with_partial=True)
        slot = self._release_slot(s)
        slot.req.finish_time = self._clock()
        self._finished[slot.req.rid] = slot.req
        if self.telemetry is not None:
            self.telemetry.retired(slot.req)

    def _preempt(self, s: int):
        """Park the slot's written KV in the prefix cache, return its page
        references, and requeue the request at the queue head; its
        re-admission re-prefills prompt + emitted tokens (often hitting the
        blocks parked here)."""
        self._register_slot(s, with_partial=True)
        slot = self._release_slot(s)
        slot.req.preemptions += 1
        self.preemptions += 1
        if self.telemetry is not None:
            # storm detection lives in the telemetry
            self.telemetry.preempted(slot.req, step=self._step_seq)
        self._queue.appendleft(slot.req)

    def _pick_victim(self) -> int:
        """Youngest / lowest-progress victim: fewest emitted tokens, ties
        broken toward the most recent admission."""
        return min((s for s, sl in enumerate(self._slots) if sl is not None),
                   key=lambda s: (len(self._slots[s].req.generated),
                                  -self._slots[s].admit_seq))

    def _retire_overdue(self):
        """Deadline enforcement: retire overdue requests wherever they are
        (slot or queue) with ``timed_out`` set.  An overdue request riding
        the in-flight dispatch quiesces it first, so the deadline acts on
        the drained step."""
        now = self._clock()
        if self._inflight is not None:
            live = [sl.req for sl in self._slots if sl is not None]
            live += [ln.slot.req for ln in self._inflight.lanes
                     if ln.retiring]
            if any(r.deadline is not None and now > r.deadline
                   for r in live):
                self.quiesce()
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.req.deadline is not None \
                    and now > slot.req.deadline:
                slot.req.timed_out = True
                self.timeouts += 1
                self._finish(s)
        if any(r.deadline is not None and now > r.deadline
               for r in self._queue):
            keep: deque[Request] = deque()
            for req in self._queue:
                if req.deadline is not None and now > req.deadline:
                    req.timed_out = True
                    req.finish_time = now
                    self.timeouts += 1
                    self._finished[req.rid] = req
                    if self.telemetry is not None:
                        self.telemetry.retired(req)
                else:
                    keep.append(req)
            self._queue = keep

    def _emit_token(self, slot, tok: int) -> bool:
        """Append one sampled token (a host int), call the streaming hook,
        and return True when the request just finished (EOS / budget); the
        caller retires it (the slot may be attached or detached)."""
        req = slot.req
        req.generated.append(tok)
        if slot.draft is not None:
            slot.draft.append(tok)
        if req.first_token_time == 0.0:
            req.first_token_time = self._clock()
            if self.telemetry is not None:
                # once per request: the per-token path stays telemetry-free
                self.telemetry.first_token(req)
        if req.on_token is not None:
            req.on_token(tok)
        self.tokens_generated += 1
        return (req.eos_token_id is not None and tok == req.eos_token_id) \
            or len(req.generated) >= req.max_new_tokens

    def _record_token(self, s: int, tok: int) -> bool:
        """Append a sampled token; returns True when the request finished
        (and retires it in place)."""
        slot = self._slots[s]
        done = self._emit_token(slot, tok)
        if done:
            self._finish(s)
        else:
            slot.pending = tok
        return done

    def _finish_detached(self, slot, valid: int):
        """Retire a slot already detached from the slot table (a budget-
        predicted retirement whose lane was handed to a successor): park
        the written KV in the prefix cache, return the page references,
        record the result."""
        self._register_pages(slot, valid, with_partial=True)
        self.pool.free(slot.pages)
        slot.req.finish_time = self._clock()
        self._finished[slot.req.rid] = slot.req
        if self.telemetry is not None:
            self.telemetry.retired(slot.req)

    def _cow(self, s: int, idx: int, src: int | None = None):
        """Copy-on-write: give slot s its own copy of the (shared) page at
        table index idx before anything writes into it; ``src`` overrides
        the copy source (admission attaches a cached partial page without
        putting the shared id in the table).  The copy runs in place on the
        page pool, after any dispatch already issued and before the write
        that needed it."""
        slot = self._slots[s]
        dst = slot.pages[idx]
        if src is None:
            src = dst
            dst = self.pool.alloc(1)[0]
        for store in (self._pages_k, self._pages_v):
            # a quantized store copies its code pages and its scale pages
            for a in (store.values() if isinstance(store, dict) else (store,)):
                a[:, :, dst] = a[:, :, src]
        if slot.pages[idx] != dst:
            self.pool.free([slot.pages[idx]])
            slot.pages[idx] = dst
        self._page_tables[s, idx] = dst
        self.cow_copies += 1
        if self.telemetry is not None:
            self.telemetry.cow_copy(slot.req.rid, src=int(src), dst=int(dst))

    def _sample_one(self, logits, req):
        """First-token sample of a sampled (temperature > 0) request, on
        the device."""
        return _sample_per_request(
            logits[None], self._gen,
            self._tensor([req.temperature], torch.float32),
            self._tensor([req.top_p], torch.float32))[0]

    def _admit(self):
        while self._queue:
            free_slots = [i for i, sl in enumerate(self._slots) if sl is None]
            if not free_slots:
                return
            req = self._queue[0]
            # resume path (preempted request): the cache must hold prompt +
            # every emitted token but the last, which becomes the pending one
            resuming = len(req.generated) > 0
            ctx = req.prompt if not resuming else np.concatenate(
                [req.prompt, np.asarray(req.generated[:-1], np.int32)])
            T = len(ctx)
            total_pages = max(1, math.ceil(T / self.page_size))
            shared, partial = ([], None)
            if self.cache is not None:
                shared, partial = self.cache.lookup(ctx)
            n_shared = len(shared)
            # pin the matched pages now so the eviction below cannot free them
            pin = list(shared) + ([partial[0]] if partial is not None else [])
            if pin:
                self.pool.share(pin)
            need = total_pages - n_shared
            if need > self._avail():
                self._evict(need - self._avail())
            if need > self._avail():
                if pin:
                    self.pool.free(pin)
                return                 # wait for retirements to free pages
            try:
                own = self.pool.alloc(need)
            except BaseException as exc:
                if pin:                # an injected pagepool.alloc fault:
                    self.pool.free(pin)  # roll back, no reference leaks
                if self.telemetry is not None \
                        and isinstance(exc, InjectedFault):
                    self.telemetry.fault_dump("injected_fault",
                                              point="pagepool.alloc",
                                              error=str(exc)[:200])
                raise
            self._queue.popleft()
            s = free_slots[0]
            pages = shared + own
            matched = n_shared * self.page_size
            slot = _Slot(req, pages, 0, admit_seq=self._admit_seq)
            slot.resuming = resuming
            self._admit_seq += 1
            self._slots[s] = slot
            if self.speculative and req.temperature <= 0.0:
                # n-gram index over prompt + every emitted token (a
                # preemption victim's index rebuilds from its history)
                slot.spec_k = self.speculative
                slot.draft = _NgramDraft(
                    req.prompt if not resuming else np.concatenate(
                        [req.prompt, np.asarray(req.generated, np.int32)]),
                    max_n=self.spec_max_ngram)
            row = np.zeros((self.max_pages_per_seq,), np.int32)
            row[:len(pages)] = pages
            self._page_tables[s] = row
            if partial is not None:
                # copy-on-write before the suffix prefill writes the tail
                src, m = partial
                self._cow(s, n_shared, src=src)
                self.pool.free([src])
                matched += m
            self._temps[s] = req.temperature
            self._top_ps[s] = req.top_p
            if matched:
                self.cache_hits += 1
                self.cache_hit_tokens += matched
                req.cached_prefix_tokens += matched
            self.prefill_tokens += T - matched
            # first admission only, so queue_time keeps meaning "wait for a
            # slot" across preemption re-admissions
            admit_now = self._clock()
            first_admit = req.admit_time == 0.0
            if first_admit:
                req.admit_time = admit_now
            if self.telemetry is not None:
                self.telemetry.admitted(
                    req, slot=s, t=admit_now, resuming=resuming,
                    first=first_admit, cached_tokens=matched,
                    prefill_tokens=T - matched)
            chunked = self.prefill_chunk is not None \
                and (T - matched) > self.prefill_chunk
            if matched == 0 and not chunked:
                self._prefill_dense(s, ctx, row)
            else:
                slot.ctx = ctx
                slot.prefill_pos = matched
                self._lengths[s] = matched
                self._prefill_advance(s)

    def _prefill_dense(self, s: int, ctx, row):
        """Whole-prompt dense prefill + first-token sample."""
        slot = self._slots[s]
        req = slot.req
        T = len(ctx)
        self._lengths[s] = T
        # bucketed prompt pad, clamped to the rope-table length
        Tb = max(self.prompt_bucket,
                 math.ceil(T / self.prompt_bucket) * self.prompt_bucket)
        Tb = min(Tb, self.config.max_position_embeddings)
        ids = np.zeros((1, Tb), np.int32)
        ids[0, :T] = ctx
        tel = self.telemetry
        if tel is not None:
            t_pf0 = tel.clock()
            ann = tel.bridge_begin("prefill_dense")
        try:
            logits, _, _ = self._prefill(self.params, self._tensor(ids), T,
                                         self._tensor(row), self._pages_k,
                                         self._pages_v)
        finally:
            if tel is not None:
                tel.bridge_end(ann)
        if tel is not None:
            # the dispatch span lands before the first token is recorded,
            # so the request record reads admitted -> prefill_dense ->
            # first_token
            tel.prefill_dispatch(req.rid, pos=0, tokens=T, t0=t_pf0,
                                 kind="prefill_dense")
        if self.cache is not None:
            self.cache.register(ctx, slot.pages)
        if slot.resuming:
            # the re-prefill rebuilt the cache; the last emitted token is
            # still the pending one
            slot.pending = req.generated[-1]
        elif req.temperature <= 0.0:
            self._finish_admission(s, torch.argmax(logits).to(torch.int32))
        else:
            self._finish_admission(s, self._sample_one(logits, req))

    def _finish_admission(self, s: int, tok):
        """Record the first token ``tok`` (a device scalar) of a completed
        prefill.  In overlap mode it stays on the device: the next decode
        dispatch consumes it there and the drain records it, so the
        admission costs no host sync."""
        slot = self._slots[s]
        if self.overlap:
            slot.pending = None
            slot.pending_dev = _Fetch(tok)
        else:
            self._record_token(s, int(tok))

    def _prefill_advance(self, s: int):
        """Run ONE prefill chunk for slot s.  On the final chunk: index the
        prompt's full blocks into the cache and sample the first token."""
        slot = self._slots[s]
        req = slot.req
        pos = slot.prefill_pos
        T = len(slot.ctx)
        c = T - pos
        if self.prefill_chunk is not None:
            c = min(c, self.prefill_chunk)
        # bucket the chunk pad and slice the page table to the pages this
        # chunk can see (4-page granularity)
        Cb = max(self.prompt_bucket,
                 math.ceil(c / self.prompt_bucket) * self.prompt_bucket)
        if self.prefill_chunk is not None:
            Cb = min(Cb, max(self.prompt_bucket, self.prefill_chunk))
        Cb = min(Cb, self.config.max_position_embeddings)
        ctx_pages = math.ceil((pos + c) / self.page_size)
        Pb = min(self.max_pages_per_seq, math.ceil(ctx_pages / 4) * 4)
        ids = np.zeros((1, Cb), np.int32)
        ids[0, :c] = slot.ctx[pos:pos + c]
        tel = self.telemetry
        if tel is not None:
            t_ck0 = tel.clock()
            ann = tel.bridge_begin("prefill_chunk")
        try:
            logits, tok_g, _, _ = self._prefill_chunk_fn(
                self.params, self._tensor(ids), pos, c,
                self._tensor(self._page_tables[s, :Pb].copy()),
                self._pages_k, self._pages_v)
        finally:
            if tel is not None:
                tel.bridge_end(ann)
        if tel is not None:
            tel.prefill_dispatch(req.rid, pos=pos, tokens=c, t0=t_ck0)
        self.prefill_chunks += 1
        slot.chunk_step = self._step_seq
        pos += c
        slot.prefill_pos = pos
        self._lengths[s] = pos
        if pos < T:
            return
        slot.prefill_pos = None
        ctx, slot.ctx = slot.ctx, None
        if self.cache is not None:
            self.cache.register(ctx, slot.pages)
        if slot.resuming:
            slot.pending = req.generated[-1]
        elif req.temperature <= 0.0:
            self._finish_admission(s, tok_g)
        else:
            self._finish_admission(s, self._sample_one(logits, req))

    def _remaining(self, s: int) -> int:
        slot = self._slots[s]
        n = slot.req.max_new_tokens - len(slot.req.generated)
        # an admission-deferred first token (overlap mode) is spoken for
        # but not yet in `generated`
        return n - 1 if slot.pending_dev is not None else n

    def _provision(self, steps):
        """Lazy page growth for up to ``steps`` decode steps ahead: every
        decoding slot gets pages covering write positions < lengths +
        min(steps, remaining).  ``steps`` is an int, or a {slot: tokens}
        dict of per-slot needs (the verify path: 1 + draft length; the
        overlap path: 2K for lanes the in-flight dispatch carries; slots
        absent from it write one token).  A short pool evicts cached pages
        first; a slot that still cannot be covered stalls this horizon.  A
        shared page about to receive a write is copied first.  Returns the
        runnable slot indices."""
        per_slot = steps if isinstance(steps, dict) else None
        run = []
        for s, slot in enumerate(self._slots):
            if slot is None or slot.prefill_pos is not None:
                continue
            want = per_slot.get(s, 1) if per_slot is not None else steps
            w0 = int(self._lengths[s]) // self.page_size
            if w0 < len(slot.pages) \
                    and self.pool.refcount(slot.pages[w0]) > 1:
                if self._avail() < 1:
                    self._evict(1)
                if self._avail() < 1:
                    continue
                self._cow(s, w0)
            m = min(want, self._remaining(s))
            need = math.ceil((int(self._lengths[s]) + m) / self.page_size)
            grow = need - len(slot.pages)
            if grow > 0:
                if grow > self._avail():
                    self._evict(grow - self._avail())
                if grow > self._avail():
                    continue
                pages = self.pool.alloc(grow)
                start = len(slot.pages)
                slot.pages.extend(pages)
                self._page_tables[s, start:start + grow] = pages
            run.append(s)
        return run

    # -- speculative decoding ----------------------------------------------
    def _propose_drafts(self) -> dict:
        """{slot -> draft tokens} for every decoding greedy slot whose n-gram
        index matches this step.  Draft length is clamped to the slot's
        adaptive spec_k and to remaining - 1, so an accepted run plus the
        bonus token never overruns the request's budget."""
        drafts = {}
        for s, slot in enumerate(self._slots):
            if slot is None or slot.prefill_pos is not None \
                    or slot.draft is None:
                continue
            k = min(slot.spec_k, self.speculative, self._remaining(s) - 1)
            if k <= 0:
                continue
            d = slot.draft.propose(k)
            if d:
                drafts[s] = d
        return drafts

    def _verify(self, run, drafts):
        """One verify dispatch over the runnable slots: score pending +
        draft tokens at K + 1 positions, accept the longest draft prefix
        whose argmax matches (lossless under greedy decoding), emit the
        accepted tokens + the bonus token, and rewind ``lengths`` past
        rejected positions — their stale K/V sits at or past the rewound
        length, is never attended and is overwritten by the next write
        there.  EOS / budget freeze mid-run as in the decode horizon.
        Sampled slots ride along as one-token lanes drawn from the
        position-0 logits with the engine's generator."""
        h = self._h
        h["vtoks"][:] = 0
        h["n_q"][:] = 0
        for s in run:
            d = drafts.get(s, ())
            h["vtoks"][s, 0] = self._slots[s].pending
            h["vtoks"][s, 1:1 + len(d)] = d
            h["n_q"][s] = 1 + len(d)
        h["lengths"][:] = self._lengths
        h["tables"][:] = self._page_tables
        tel = self.telemetry
        if tel is not None:
            t_v0 = tel.clock()
            ann = tel.bridge_begin("verify_dispatch")
        try:
            self._upload()
            logits0, gtoks = self._verify_exec()()
        finally:
            if tel is not None:
                tel.bridge_end(ann)
        t_v1 = tel.clock() if tel is not None else 0.0
        gtoks = gtoks.cpu().numpy()    # the one per-verify sync
        self.steps_run += 1
        self.verify_steps += 1
        if all(self._slots[s].req.temperature <= 0.0 for s in run):
            # every lane took the dispatch's own argmax row
            self.fused_sample_steps += 1
        if tel is not None:
            t_v2 = tel.clock()
            tel.phase("verify_dispatch", t_v0, t_v1, slots=len(run))
            tel.phase("verify_sync", t_v1, t_v2)
            for s in run:
                tel.request_event(self._slots[s].req.rid, "verify_dispatch",
                                  drafted=len(drafts.get(s, ())))
        lens = self._lengths.tolist()
        for s in run:
            slot = self._slots[s]
            req = slot.req
            d = list(drafts.get(s, ()))
            nd = len(d)
            old = lens[s]
            if req.temperature > 0.0:
                # logits0 is the graph's output: sampled before any replay
                emitted = [int(self._sample_one(logits0[s], req))]
                acc = 0
            else:
                g = gtoks[s].tolist()
                acc = 0
                while acc < nd and g[acc] == d[acc]:
                    acc += 1
                emitted = d[:acc] + [g[acc]]
            if nd:
                if acc == nd:          # fully accepted: regrow toward K
                    slot.spec_k = min(self.speculative, slot.spec_k + 1)
                elif acc == 0:         # missed: back off (floor 1)
                    slot.spec_k = max(1, slot.spec_k // 2)
            n_emitted = 0
            for i, tok in enumerate(emitted, 1):
                # the cache now holds the pending token plus i - 1 accepted
                # drafts past the old length
                self._lengths[s] = old + i
                n_emitted = i
                if self._record_token(s, tok):
                    break
            if nd:
                # credit only drafts that were emitted: an EOS / budget
                # freeze mid-run discards the tail uncounted
                used = min(acc, n_emitted)
                self.draft_tokens_proposed += nd
                self.draft_tokens_accepted += used
                req.draft_proposed += nd
                req.draft_accepted += used
        if tel is not None:
            tel.phase("verify_record", t_v2, tel.clock())

    # -- the double-buffered host loop (overlap=True) ----------------------
    @property
    def inflight_depth(self) -> int:
        """Decode dispatches in flight and not yet drained (0 or 1)."""
        return 0 if self._inflight is None else 1

    def quiesce(self) -> bool:
        """Drain the pipeline to an exact host-visible step boundary:
        record any in-flight dispatch's tokens (retiring what finished) and
        flush admission-deferred first tokens to host ints.  Afterwards
        ``Request.generated``, slot pendings, the length mirror and the page
        accounting are what a synchronous engine would hold.  Returns True
        when anything was in flight; free on a synchronous engine."""
        rec, self._inflight = self._inflight, None
        flushed = False
        if rec is not None:
            self._drain(rec)
            self.quiesces += 1
            flushed = True
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.pending_dev is not None:
                tok0 = slot.pending_dev.item()
                slot.pending_dev = None
                if self._emit_token(slot, tok0):
                    self._finish(s)
                else:
                    slot.pending = tok0
                flushed = True
        return flushed

    def _flush_exhausted(self):
        """Record admission-deferred first tokens that already exhaust their
        request's budget (max_new_tokens == 1): such a lane never enters a
        decode dispatch.  The fetch waits only on the admission's prefill."""
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.pending_dev is not None \
                    and slot.prefill_pos is None and self._remaining(s) <= 0:
                tok0 = slot.pending_dev.item()
                slot.pending_dev = None
                self._emit_token(slot, tok0)
                self._finish(s)      # budget-exhausted by construction

    def _detach_predicted(self):
        """Budget-predicted retirement: a lane whose in-flight dispatch is
        sure to finish its request (remaining budget <= the dispatched
        horizon; an EOS could only finish it sooner) hands its slot to the
        admission queue now.  Its pages stay referenced by the lane record
        until the drain registers and frees them; the successor's prefill
        writes other pages."""
        rec = self._inflight
        if rec is None:
            return
        for lane in rec.lanes:
            s, slot = lane.s, lane.slot
            if lane.retiring or self._slots[s] is not slot \
                    or slot.prefill_pos is not None:
                continue
            if self._remaining(s) <= rec.K:
                lane.retiring = True
                lane.base_len = int(self._lengths[s])
                self._slots[s] = None
                self._page_tables[s] = 0
                self._lengths[s] = 0

    def _dispatch_decode(self, run, K: int, greedy: bool) -> _Inflight:
        """Issue one decode horizon over the runnable lanes and return its
        :class:`_Inflight` record without waiting for it.  Lanes whose slot
        rode the previous (possibly still in-flight) dispatch are carried:
        their token / length / budget / done come from its outputs on the
        device.  Freshly admitted lanes merge in host values, and an
        admission-deferred first token joins as a device scalar."""
        S = self.num_slots
        prev = self._inflight
        h = self._h
        h["toks"][:] = 0
        h["remaining"][:] = 1
        h["eos"][:] = -1
        for name in ("active", "carry", "defer"):
            h[name][:] = 0
        lanes = []
        for s in run:
            slot = self._slots[s]
            h["active"][s] = 1
            h["remaining"][s] = self._remaining(s)
            if slot.req.eos_token_id is not None:
                h["eos"][s] = slot.req.eos_token_id
            take_first = False
            if prev is not None and prev.srcs.get(s) is slot:
                h["carry"][s] = 1
            elif slot.pending_dev is not None:
                h["defer"][s] = 1
                self._d["first"][s].copy_(slot.pending_dev.dev)
                take_first = True
            else:
                h["toks"][s] = slot.pending
            lanes.append(_LaneRec(s, slot, take_first))
        h["lengths"][:] = self._lengths
        h["tables"][:] = self._page_tables
        h["temps"][:] = self._temps
        h["top_ps"][:] = self._top_ps
        tel = self.telemetry
        phase = "overlap_dispatch" if self.overlap else "decode_dispatch"
        if tel is not None:
            t_d0 = tel.clock()
            ann = tel.bridge_begin(phase)
        try:
            self._upload()
            out = self._horizon_exec(K, greedy)()
            # the carry sources are exactly the dispatched lanes: a lane
            # the provisioner skipped has filler rows in this dispatch and
            # must fall back to its host state next time
            rec = _Inflight(_Fetch(out), K, lanes,
                            {ln.s: ln.slot for ln in lanes}, self.overlap)
        finally:
            if tel is not None:
                tel.bridge_end(ann)
        self.steps_run += 1
        self.decode_model_steps += K
        self.fused_sample_steps += 1   # horizons choose tokens on the device
        if prev is not None:
            self.overlap_steps += 1
        if tel is not None:
            tel.phase(phase, t_d0, tel.clock(), slots=len(run), k=K)
            for s in run:
                tel.request_event(self._slots[s].req.rid, "decode_dispatch",
                                  k=K)
        return rec

    def _drain(self, rec):
        """Fetch one dispatch's emitted tokens (one batched copy) and replay
        the horizon's freeze logic on the host: record tokens until each
        lane's EOS / budget stop, which rebuilds the host length mirror
        without reading ``lengths`` back, then retire what finished.  Lanes
        whose slot an earlier drain already retired are skipped: their rows
        hold frozen ``eos_ids`` filler."""
        tel = self.telemetry
        t0 = tel.clock() if tel is not None else 0.0
        out = rec.out.numpy()          # waits on this dispatch alone
        t1 = tel.clock() if tel is not None else 0.0
        lens = self._lengths.tolist()
        for lane in rec.lanes:
            s, slot = lane.s, lane.slot
            if not lane.retiring and self._slots[s] is not slot:
                continue           # retired by an earlier drain
            if slot.req.finish_time:
                continue
            base = lane.base_len if lane.retiring else lens[s]
            row = out[s].tolist()
            done = False
            if lane.take_first and slot.pending_dev is not None:
                # the admission-deferred first token: its fetch waits only
                # on the admission's prefill
                tok0 = slot.pending_dev.item()
                slot.pending_dev = None
                done = self._emit_token(slot, tok0)
            emitted = 0
            if not done:
                for tok in row:
                    emitted += 1
                    done = self._emit_token(slot, tok)
                    if done:
                        break
            if done:
                if lane.retiring:
                    self._finish_detached(slot, base + emitted)
                else:
                    self._lengths[s] = base + emitted
                    self._finish(s)
            else:
                # still live: the lane's last emitted token is the next
                # pending one; the device carry holds the same state
                self._lengths[s] = base + emitted
                slot.pending = row[emitted - 1]
        if tel is not None:
            pre = "overlap" if rec.overlapped else "decode"
            t2 = tel.clock()
            tel.phase(f"{pre}_sync", t0, t1)
            tel.phase(f"{pre}_record", t1, t2)

    # -- the serving loop --------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(1 for sl in self._slots if sl is not None)

    def step(self) -> bool:
        """One engine step: retire overdue requests, admit queued requests
        into free slots (attaching cached prefixes), advance each
        mid-prefill slot by one chunk, provision pages for the decode
        horizon, dispatch it, record the tokens and retire finished
        requests into the prefix cache (in overlap mode: the previous
        dispatch's tokens, while this one runs).  When nobody can progress
        the engine evicts cached pages, then preempts a victim; under an
        injected pool-pressure window it parks and reports no progress.
        Returns True when any slot made progress.

        With telemetry on, the step's host wall time lands in the
        ``engine.step_host_s`` histogram, a per-step summary in the flight
        recorder, and an active injected pool-pressure window auto-dumps
        the recorder."""
        tel = self.telemetry
        if tel is None:
            return self._step_impl()
        t0 = tel.clock()
        pre_tok = self.tokens_generated
        progressed = self._step_impl()
        tel.step_done(self, t0, progressed,
                      self.tokens_generated - pre_tok)
        return progressed

    def _step_impl(self) -> bool:
        tel = self.telemetry
        t_s0 = tel.sched_begin() if tel is not None else 0.0
        self._step_seq += 1
        # serve.wedge: the step returns without doing any work, the stand-in
        # for an engine that stopped responding
        if fault_point("serve.wedge", engine=self.name,
                       step=self._step_seq) is not None:
            if tel is not None:
                tel.flight.record("fault", point="serve.wedge",
                                  step=self._step_seq)
            return False
        self._pressure = fault_point("serve.pool_pressure",
                                     step=self.steps_run) is not None
        pre_tokens = self.tokens_generated
        pre_finished = len(self._finished)
        # overlap: hand budget-predicted retiring lanes to the admission
        # queue before admitting
        self._detach_predicted()
        self._retire_overdue()
        pre_admit_seq = self._admit_seq
        self._admit()
        if self.overlap:
            self._flush_exhausted()
        # serve.crash phase="sched": die after admissions changed the slot
        # and pool state but before this step produced a token
        fault_point("serve.crash", engine=self.name, step=self._step_seq,
                    phase="sched")
        if tel is not None:
            # host scheduling: deadline sweep + admissions, less the
            # prefill dispatches inside it (they record their own spans)
            tel.sched_done(t_s0, tel.clock())
        # chunked prefill: each mid-prefill slot advances ONE chunk per
        # step (a slot admitted this step already ran its first chunk)
        prefilled = False
        for s, slot in enumerate(self._slots):
            if slot is not None and slot.prefill_pos is not None \
                    and slot.chunk_step != self._step_seq:
                self._prefill_advance(s)
                prefilled = True
        if prefilled:
            self._admit()              # a 1-token request may have retired
        if self.speculative:
            # one verify dispatch when any slot has a draft; slots without
            # one ride along as single-token lanes.  Acceptance is host
            # logic, so the pipeline drains first and drafts are proposed
            # again on the drained state.  Draftless or pool-tight steps
            # fall through to the decode horizon.
            drafts = self._propose_drafts()
            if drafts and (self._inflight is not None or any(
                    sl is not None and sl.pending_dev is not None
                    for sl in self._slots)):
                self.quiesce()
                drafts = self._propose_drafts()
            if drafts:
                run = self._provision(
                    {s: 1 + len(d) for s, d in drafts.items()})
                if run:
                    self._verify(run, drafts)
                    # serve.crash phase="record": die after this step's
                    # tokens were recorded, before a caller saw them
                    fault_point("serve.crash", engine=self.name,
                                step=self._step_seq, phase="record")
                    return True
        K = self.decode_horizon
        prev = self._inflight
        if prev is not None:
            # host lengths lag the in-flight dispatch by up to K tokens:
            # carried lanes provision for its writes and this dispatch's
            want = {s: 2 * K if prev.srcs.get(s) is sl else K
                    for s, sl in enumerate(self._slots)
                    if sl is not None and sl.prefill_pos is None}
            run = self._provision(want) if want else []
        else:
            run = self._provision(K)
        if not run and self._inflight is not None:
            # nobody fits while a step is in flight: drain it (its
            # retirements may free pages) and act on exact state
            self.quiesce()
            run = self._provision(K)
        if not run and K > 1:
            # no slot can cover a full horizon — single-step pacing lets
            # retirements free pages
            K = 1
            run = self._provision(1)
        admitted = self._admit_seq != pre_admit_seq
        if not run and not prefilled and not admitted \
                and self.num_active > 0:
            # deadlock: preempt ONE victim; its pages go to the stalled
            # survivors (not re-admitted this step)
            self._preempt(self._pick_victim())
            K = 1
            run = self._provision(1)
        if not run:
            return prefilled or admitted \
                or self.tokens_generated > pre_tokens \
                or len(self._finished) > pre_finished
        greedy = all(self._temps[s] <= 0.0 for s in run)
        rec = self._dispatch_decode(run, K, greedy)
        prev, self._inflight = self._inflight, rec
        if prev is not None:
            # drain step N - 1's tokens while step N runs
            self._drain(prev)
        if not self.overlap:
            self._inflight = None
            self._drain(rec)
        # serve.crash phase="record": die after this horizon's tokens were
        # recorded (and finished requests retired), before a caller saw them
        fault_point("serve.crash", engine=self.name, step=self._step_seq,
                    phase="record")
        return True

    def run(self, max_steps: int | None = None,
            max_stall_steps: int = 1000):
        """Drive until every submitted request finished; returns
        {rid: Request}.  Raises ``EngineStalledError`` after
        ``max_stall_steps`` consecutive no-progress steps."""
        steps = 0
        stalled = 0
        while self._queue or self.num_active or self._inflight is not None:
            stalled = 0 if self.step() else stalled + 1
            if stalled >= max_stall_steps:
                if self.telemetry is not None:
                    # dump the recent-event window before the engine dies
                    self.telemetry.fault_dump(
                        "engine_stalled", stalled_steps=stalled,
                        active=self.num_active, queued=len(self._queue),
                        free_pages=self.pool.num_free,
                        num_pages=self.pool.num_pages)
                raise EngineStalledError(
                    f"no engine progress for {stalled} consecutive steps "
                    f"({self.num_active} active, {len(self._queue)} queued, "
                    f"{self.pool.num_free} pages free of "
                    f"{self.pool.num_pages})")
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self._finished)

    # -- snapshot / restore ------------------------------------------------
    # Everything a restart would lose — requests with their emitted tokens,
    # the generator state, deadlines, slot table, page tables, pool
    # refcounts, the prefix-cache index and adaptive draft lengths —
    # serializes into the JAX engine's state-dict layout: "meta" (one JSON
    # string), "rng", and in "full_kv" mode the referenced pages as numpy
    # planes.  "full_kv" restores by scattering the pages back (no
    # re-prefill; same pool geometry); "compact" (or a geometry mismatch)
    # requeues every in-flight request through the preemption-resume path.

    SNAPSHOT_VERSION = 1

    def _req_state(self, r: Request) -> dict:
        eos = r.eos_token_id
        return {
            "rid": int(r.rid), "prompt": np.asarray(r.prompt).tolist(),
            "max_new_tokens": int(r.max_new_tokens),
            "temperature": float(r.temperature), "top_p": float(r.top_p),
            "eos_token_id": None if eos is None else int(eos),
            "deadline": None if r.deadline is None else float(r.deadline),
            "generated": [int(t) for t in r.generated],
            "submit_time": float(r.submit_time),
            "admit_time": float(r.admit_time),
            "first_token_time": float(r.first_token_time),
            "finish_time": float(r.finish_time),
            "timed_out": bool(r.timed_out),
            "preemptions": int(r.preemptions),
            "cached_prefix_tokens": int(r.cached_prefix_tokens),
            "draft_proposed": int(r.draft_proposed),
            "draft_accepted": int(r.draft_accepted),
            "trace_id": None if r.trace_id is None else int(r.trace_id),
        }

    def _req_from_state(self, d: dict) -> Request:
        return Request(
            rid=int(d["rid"]),
            prompt=np.asarray(d["prompt"], np.int32),
            max_new_tokens=int(d["max_new_tokens"]),
            temperature=float(d["temperature"]), top_p=float(d["top_p"]),
            eos_token_id=d["eos_token_id"], deadline=d["deadline"],
            generated=[int(t) for t in d["generated"]],
            submit_time=d["submit_time"], admit_time=d["admit_time"],
            first_token_time=d["first_token_time"],
            finish_time=d["finish_time"], timed_out=bool(d["timed_out"]),
            preemptions=int(d["preemptions"]),
            cached_prefix_tokens=int(d["cached_prefix_tokens"]),
            draft_proposed=int(d["draft_proposed"]),
            draft_accepted=int(d["draft_accepted"]),
            trace_id=d.get("trace_id"), _engine=weakref.ref(self))

    _COUNTER_ATTRS = ("steps_run", "tokens_generated", "preemptions",
                      "timeouts", "rejections", "cache_hits",
                      "cache_hit_tokens", "prefill_tokens",
                      "cache_evictions", "cow_copies", "verify_steps",
                      "draft_tokens_proposed", "draft_tokens_accepted",
                      "overlap_steps", "quiesces", "fused_sample_steps",
                      "kv_exports", "kv_imports", "kv_pages_exported",
                      "kv_pages_imported", "decode_model_steps",
                      "prefill_chunks")

    def snapshot(self, mode: str = "full_kv",
                 include_finished: bool = True) -> dict:
        """Serialize the engine state at a step boundary (the pipeline is
        quiesced first): ``meta`` is one JSON string of host state, ``rng``
        the generator state (uint8), and in ``full_kv`` mode ``kv_pages``
        with ``kv_k``/``kv_v`` (or ``kv_{k,v}_{q,s}`` for a quantized
        store) the referenced pages.  ``include_finished`` keeps retired
        requests, so a restored engine's ``run()`` still returns them."""
        if mode not in ("full_kv", "compact"):
            raise ValueError(f"unknown snapshot mode {mode!r}")
        self.quiesce()
        requests: dict[str, dict] = {}

        def _ref(r: Request) -> int:
            requests.setdefault(str(r.rid), self._req_state(r))
            return int(r.rid)

        slots = []
        for s, slot in enumerate(self._slots):
            if slot is None:
                slots.append(None)
                continue
            slots.append({
                "rid": _ref(slot.req),
                "pages": [int(p) for p in slot.pages],
                "pending": int(slot.pending),
                "admit_seq": int(slot.admit_seq),
                "prefill_pos": None if slot.prefill_pos is None
                else int(slot.prefill_pos),
                "ctx": None if slot.ctx is None
                else np.asarray(slot.ctx).tolist(),
                "resuming": bool(slot.resuming),
                "chunk_step": int(slot.chunk_step),
                "spec_k": int(slot.spec_k),
                "length": int(self._lengths[s]),
            })
        meta = {
            "version": self.SNAPSHOT_VERSION,
            "mode": mode,
            "geometry": {
                "num_slots": self.num_slots, "page_size": self.page_size,
                "num_pages": self.pool.num_pages,
                "max_pages_per_seq": self.max_pages_per_seq,
                "prefix_cache": self.cache is not None,
                "kv_dtype": self.kv_dtype,
                "tp": self.tp,
            },
            "requests": requests,
            "slots": slots,
            "queue": [_ref(r) for r in self._queue],
            "finished": [_ref(r) for r in self._finished.values()]
            if include_finished else [],
            "next_rid": int(self._next_rid),
            "admit_seq": int(self._admit_seq),
            "step_seq": int(self._step_seq),
            "counters": {k: int(getattr(self, k))
                         for k in self._COUNTER_ATTRS},
            "pool": {"free": [int(p) for p in self.pool._free],
                     "refs": [[int(p), int(c)]
                              for p, c in sorted(self.pool._refs.items())]},
        }
        state: dict = {"rng": self._gen.get_state().numpy()}
        if mode == "full_kv":
            if self.cache is not None:
                c = self.cache
                meta["cache"] = {
                    "tick": int(c._tick), "insertions": int(c.insertions),
                    "evictions": int(c.evictions),
                    "full": [[e.key.hex(), e.parent.hex(), int(e.page),
                              int(e.tick)] for e in c._full.values()],
                    "partial": [[e.parent.hex(),
                                 np.frombuffer(e.tokens, np.int32).tolist(),
                                 int(e.page), int(e.tick)]
                                for d in c._partial.values()
                                for e in d.values()],
                }
            else:
                meta["cache"] = None
            ids = sorted(self.pool._refs)
            state["kv_pages"] = np.asarray(ids, np.int32)
            state.update(self._gather_pages(ids))
        state["meta"] = json.dumps(meta)
        return state

    def _gather_pages(self, ids) -> dict:
        """Pages ``ids`` as named host planes (the read half of the
        transfer snapshot and export_kv share), gathered on the device
        first.  A quantized store ships its codes with their scales; fp8
        codes travel as their uint8 bits and bf16 values as int16 bits
        (numpy has neither type)."""
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

        def host(t):
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            elif t.dtype == torch.float8_e4m3fn:
                t = t.view(torch.uint8)
            return t.cpu().numpy()

        gk = self._whole_heads(gather_kv_pages(self._pages_k, idx))
        gv = self._whole_heads(gather_kv_pages(self._pages_v, idx))
        if self.kv_dtype is not None:
            return {"kv_k_q": host(gk["q"]), "kv_k_s": host(gk["s"]),
                    "kv_v_q": host(gv["q"]), "kv_v_s": host(gv["s"])}
        return {"kv_k": host(gk), "kv_v": host(gv)}

    def _whole_heads(self, planes):
        """Gathered page planes (a tensor or a ``{"q", "s"}`` dict) of this
        rank's KV heads -> the planes of every head, all-gathered over the
        mp group in global head order (every rank calls it), so a packet or
        snapshot keeps the one-card layout JAX's engine writes."""
        if self.tp == 1:
            return planes
        if isinstance(planes, dict):
            return {k: self._whole_heads(v) for k, v in planes.items()}
        from ..distributed.communication.collectives import all_gather
        t = planes.contiguous()
        fp8 = t.dtype == torch.float8_e4m3fn    # gathered as its bytes
        parts = all_gather(None, t.view(torch.uint8) if fp8 else t,
                           self._group)
        whole = torch.cat(parts.unbind(0), dim=1)
        return whole.view(torch.float8_e4m3fn) if fp8 else whole

    def _own_heads(self, plane):
        """This rank's block of the KV-head axis (axis 1) of a whole host
        plane."""
        if self.tp == 1:
            return plane
        a = np.asarray(plane)
        w = a.shape[1] // self.tp
        r = self._group.rank
        return a[:, r * w:(r + 1) * w]

    def _scatter_pages(self, ids, planes: dict):
        """Write host planes (a ``_gather_pages`` result, same page order)
        into this engine's pool at page ids ``ids``, in place — the write
        half of the transfer restore and import_kv share.  At tp > 1 the
        planes hold every head and this rank writes its own block."""
        planes = {k: self._own_heads(planes[k])
                  for k in ("kv_k_q", "kv_k_s", "kv_v_q", "kv_v_s", "kv_k",
                            "kv_v") if k in planes}
        if self.kv_dtype is not None:
            scatter_kv_pages(self._pages_k, ids,
                             {"q": planes["kv_k_q"], "s": planes["kv_k_s"]})
            scatter_kv_pages(self._pages_v, ids,
                             {"q": planes["kv_v_q"], "s": planes["kv_v_s"]})
        else:
            scatter_kv_pages(self._pages_k, ids, planes["kv_k"])
            scatter_kv_pages(self._pages_v, ids, planes["kv_v"])

    # -- KV handoff (disaggregated prefill/decode) -------------------------
    KV_HANDOFF_VERSION = 1

    def handoff_ready(self, rid: int) -> bool:
        """True when ``rid`` rides a slot whose prefill is complete and
        whose first token is recorded: what a prefill replica hands to a
        decode replica.  Host-only."""
        for slot in self._slots:
            if slot is not None and slot.req.rid == rid:
                return (slot.prefill_pos is None and slot.ctx is None
                        and len(slot.req.generated) > 0)
        return False

    def export_kv(self, rids) -> dict:
        """The in-flight state of ``rids`` (slot-resident requests) plus
        exactly the KV pages their page tables reference, as one packet for
        :meth:`import_kv` on another engine (the JAX engine's keys, numpy
        planes).  Read-only here: the caller decides whether to ``cancel``
        the source requests.  Raises KeyError for a rid that holds no
        slot."""
        self.quiesce()
        by_rid = {slot.req.rid: (s, slot)
                  for s, slot in enumerate(self._slots) if slot is not None}
        entries = []
        for rid in rids:
            if rid not in by_rid:
                raise KeyError(
                    f"export_kv: rid {rid} holds no slot (queued, finished "
                    "or unknown) — nothing to hand off")
            s, slot = by_rid[rid]
            entries.append({
                "req": self._req_state(slot.req),
                "pages": [int(p) for p in slot.pages],
                "pending": int(slot.pending),
                "prefill_pos": None if slot.prefill_pos is None
                else int(slot.prefill_pos),
                "ctx": None if slot.ctx is None
                else np.asarray(slot.ctx).tolist(),
                "resuming": bool(slot.resuming),
                "chunk_step": int(slot.chunk_step),
                "length": int(self._lengths[s]),
            })
        ids = sorted({p for e in entries for p in e["pages"]})
        planes = self._gather_pages(ids)
        packet = {
            "version": self.KV_HANDOFF_VERSION,
            "page_size": self.page_size,
            "kv_dtype": self.kv_dtype,
            "tp": self.tp,
            "kv_pages": [int(p) for p in ids],
            "planes": planes,
            "requests": entries,
            "bytes": int(sum(v.nbytes for v in planes.values())),
        }
        self.kv_exports += 1
        self.kv_pages_exported += len(ids)
        return packet

    def import_kv(self, packet: dict) -> dict:
        """Splice an :meth:`export_kv` packet into this running engine:
        allocate pages, write the shipped planes into them in place, remap
        each request's page table and seat the requests in free slots to
        continue from where the source stood (no re-prefill).  Raises
        :class:`KVHandoffError` when the packet can never splice here
        (version, page size, kv_dtype, tensor-parallel degree, page-table
        width) and ``AdmissionRejected`` for want of free slots or pages.
        Returns {source rid: rid here}."""
        if packet.get("version") != self.KV_HANDOFF_VERSION:
            raise KVHandoffError(
                f"kv handoff version {packet.get('version')!r} != "
                f"{self.KV_HANDOFF_VERSION}")
        if packet["page_size"] != self.page_size:
            raise KVHandoffError(
                f"page_size {packet['page_size']} != {self.page_size}: "
                "shipped pages cannot re-block without a device pass")
        if packet["kv_dtype"] != self.kv_dtype:
            raise KVHandoffError(
                f"kv_dtype {packet['kv_dtype']!r} != {self.kv_dtype!r}: "
                "stored codes/scales are the source dtype's — re-prefill "
                "requantizes for this store")
        if packet["tp"] != self.tp:
            raise KVHandoffError(
                f"mp degree {packet['tp']} != {self.tp}: head-sharded "
                "planes are rank-local only at equal mp degree — "
                "re-prefill (adopt) reshards for this submesh")
        entries = packet["requests"]
        if any(len(e["pages"]) > self.max_pages_per_seq for e in entries):
            raise KVHandoffError(
                "request page table exceeds this engine's "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        self.quiesce()
        free_slots = [i for i, sl in enumerate(self._slots) if sl is None]
        if len(entries) > len(free_slots):
            raise AdmissionRejected(
                f"import_kv: {len(entries)} requests > {len(free_slots)} "
                "free slots")
        old_ids = [int(p) for p in packet["kv_pages"]]
        n = len(old_ids)
        if n > self._avail():
            self._evict(n - self._avail())
        if n > self._avail():
            raise AdmissionRejected(
                f"import_kv: need {n} pages, {self._avail()} free after "
                "eviction")
        new_ids = self.pool.alloc(n)
        remap = dict(zip(old_ids, new_ids))
        self._scatter_pages(new_ids, packet["planes"])
        # extra references for pages several shipped tables share
        nrefs: dict[int, int] = {}
        for e in entries:
            for p in e["pages"]:
                nrefs[p] = nrefs.get(p, 0) + 1
        extra = [remap[p] for p, c in nrefs.items() for _ in range(c - 1)]
        if extra:
            self.pool.share(extra)
        mapping: dict[int, int] = {}
        now = self._clock()
        for e, s in zip(entries, free_slots):
            d = dict(e["req"])
            src_rid = int(d["rid"])
            d["rid"] = self._next_rid
            self._next_rid += 1
            req = self._req_from_state(d)
            mapping[src_rid] = req.rid
            pages = [remap[p] for p in e["pages"]]
            slot = _Slot(req, pages, int(e["pending"]),
                         admit_seq=self._admit_seq)
            self._admit_seq += 1
            slot.prefill_pos = e["prefill_pos"]
            slot.ctx = None if e["ctx"] is None \
                else np.asarray(e["ctx"], np.int32)
            slot.resuming = bool(e["resuming"])
            slot.chunk_step = int(e["chunk_step"])
            if self.speculative and req.temperature <= 0.0:
                slot.spec_k = self.speculative
                slot.draft = _NgramDraft(
                    np.concatenate([req.prompt,
                                    np.asarray(req.generated, np.int32)]),
                    max_n=self.spec_max_ngram)
            self._slots[s] = slot
            row = np.zeros((self.max_pages_per_seq,), np.int32)
            row[:len(pages)] = pages
            self._page_tables[s] = row
            self._lengths[s] = int(e["length"])
            self._temps[s] = req.temperature
            self._top_ps[s] = req.top_p
            if self.telemetry is not None:
                # the handed-off request opens a track on this engine's
                # tracer; its first event carries handoff=True
                attrs = {"handoff": True}
                if req.trace_id is not None:
                    attrs["trace_id"] = req.trace_id
                self.telemetry.request_event(req.rid, "submitted", t=now,
                                             **attrs)
        self.kv_imports += 1
        self.kv_pages_imported += n
        return mapping

    def restore(self, state: dict) -> str:
        """Load a :meth:`snapshot` state dict into this fresh engine (same
        params and config; raises if it already ran work).  Returns
        ``"full_kv"`` (geometry matched a full-KV snapshot: pages written
        back in place, decode continues with no re-prefill) or
        ``"reprefill"`` (a compact snapshot or another geometry: in-flight
        requests requeue through the preemption-resume path).  Greedy
        outputs are bit-exact against the uninterrupted engine either
        way."""
        meta = state["meta"]
        if isinstance(meta, (bytes, np.ndarray)):
            meta = bytes(meta).decode()
        if isinstance(meta, str):
            meta = json.loads(meta)
        if meta.get("version") != self.SNAPSHOT_VERSION:
            raise ValueError(
                f"engine snapshot version {meta.get('version')!r} != "
                f"{self.SNAPSHOT_VERSION}")
        if self.num_active or self._queue or self._finished or self.steps_run:
            raise RuntimeError(
                "ServingEngine.restore: target engine already holds state — "
                "restore into a freshly constructed engine")
        self._gen.set_state(torch.from_numpy(
            np.asarray(state["rng"], np.uint8).copy()))
        reqs = {int(r): self._req_from_state(d)
                for r, d in meta["requests"].items()}
        for rid in meta["finished"]:
            self._finished[rid] = reqs[rid]
        self._next_rid = max(int(meta["next_rid"]), self._next_rid)
        for k, v in meta["counters"].items():
            setattr(self, k, int(v))
        self._admit_seq = int(meta["admit_seq"])
        g = meta["geometry"]
        fast = (meta["mode"] == "full_kv"
                and g["num_slots"] == self.num_slots
                and g["page_size"] == self.page_size
                and g["num_pages"] == self.pool.num_pages
                and g["max_pages_per_seq"] == self.max_pages_per_seq
                and bool(g["prefix_cache"]) == (self.cache is not None)
                and g.get("kv_dtype") == self.kv_dtype
                and g.get("tp", 1) == self.tp)
        if fast:
            self._restore_full(meta, state, reqs)
            applied = "full_kv"
        else:
            self._restore_reprefill(meta, reqs)
            applied = "reprefill"
        if self.telemetry is not None:
            # a restored in-flight request opens a track on this engine's
            # tracer (first event restored=True); counters stay untouched,
            # as the request was submitted elsewhere
            now = self._clock()
            live = [sl.req for sl in self._slots if sl is not None]
            live.extend(self._queue)
            for r in live:
                attrs = {"restored": True}
                if r.trace_id is not None:
                    attrs["trace_id"] = r.trace_id
                self.telemetry.request_event(r.rid, "submitted", t=now,
                                             **attrs)
        return applied

    def _restore_full(self, meta, state, reqs):
        self._step_seq = int(meta["step_seq"])
        pool = self.pool
        pool._free = [int(p) for p in meta["pool"]["free"]]
        pool._refs = {int(p): int(c) for p, c in meta["pool"]["refs"]}
        ids = np.asarray(state["kv_pages"], np.int32)
        if len(ids):
            self._scatter_pages(ids, state)
        for s, sd in enumerate(meta["slots"]):
            if sd is None:
                continue
            req = reqs[sd["rid"]]
            slot = _Slot(req, [int(p) for p in sd["pages"]],
                         int(sd["pending"]), admit_seq=int(sd["admit_seq"]))
            slot.prefill_pos = sd["prefill_pos"]
            slot.ctx = None if sd["ctx"] is None \
                else np.asarray(sd["ctx"], np.int32)
            slot.resuming = bool(sd["resuming"])
            slot.chunk_step = int(sd["chunk_step"])
            slot.spec_k = int(sd["spec_k"])
            if self.speculative and req.temperature <= 0.0:
                # the n-gram index is a function of the token stream:
                # rebuilt, not serialized
                slot.draft = _NgramDraft(
                    np.concatenate([req.prompt,
                                    np.asarray(req.generated, np.int32)]),
                    max_n=self.spec_max_ngram)
            self._slots[s] = slot
            row = np.zeros((self.max_pages_per_seq,), np.int32)
            row[:len(slot.pages)] = slot.pages
            self._page_tables[s] = row
            self._lengths[s] = int(sd["length"])
            self._temps[s] = req.temperature
            self._top_ps[s] = req.top_p
        for rid in meta["queue"]:
            self._queue.append(reqs[rid])
        if self.cache is not None and meta.get("cache"):
            c = self.cache
            cm = meta["cache"]
            c._tick = int(cm["tick"])
            c.insertions = int(cm["insertions"])
            c.evictions = int(cm["evictions"])
            for key_hex, parent_hex, page, tick in cm["full"]:
                e = _CacheEntry(bytes.fromhex(key_hex),
                                bytes.fromhex(parent_hex), int(page))
                e.tick = int(tick)
                c._full[e.key] = e
            for parent_hex, toks, page, tick in cm["partial"]:
                parent = bytes.fromhex(parent_hex)
                tb = np.asarray(toks, np.int32).tobytes()
                e = _CacheEntry(None, parent, int(page), tokens=tb)
                e.tick = int(tick)
                c._partial.setdefault(parent, {})[tb] = e
            for e in list(c._full.values()) + [
                    e for d in c._partial.values() for e in d.values()]:
                if e.parent in c._full:
                    c._full[e.parent].children += 1

    def _restore_reprefill(self, meta, reqs):
        """Compact-mode (or geometry-mismatch) restore: requeue every
        in-flight request through the preemption-resume path, slots first
        in admission order, then the parked queue in its order.  The prefix
        cache starts empty and refills as re-prefills register blocks."""
        inflight = sorted((sd for sd in meta["slots"] if sd is not None),
                          key=lambda sd: sd["admit_seq"])
        for sd in inflight:
            self._queue.append(reqs[sd["rid"]])
        for rid in meta["queue"]:
            self._queue.append(reqs[rid])

    # -- accounting / invariants -------------------------------------------
    @property
    def page_bytes(self) -> int:
        """Bytes one pool page costs on the device: K + V across all
        layers, with the per-row scales of a quantized ``kv_dtype`` (the
        unit of the telemetry's byte gauges; computed once).  At tp > 1 it
        is one rank's cost: each holds 1/tp of the KV heads."""
        if self._page_bytes is None:
            self._page_bytes = _page_bytes(self.config, self.page_size,
                                           kv_dtype=self.kv_dtype,
                                           dtype=self._dtype) // self.tp
        return self._page_bytes

    def stats(self) -> dict:
        """Monotonically increasing engine counters.  ``decode_steps``
        (decode horizons) and ``verify_steps`` are disjoint dispatch
        counts; ``prefill_chunks`` counts chunked / suffix prefills."""
        prop = self.draft_tokens_proposed
        acc = self.draft_tokens_accepted
        return {
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.steps_run - self.verify_steps,
            "verify_steps": self.verify_steps,
            "fused_sample_steps": self.fused_sample_steps,
            "draft_tokens_proposed": prop,
            "draft_tokens_accepted": acc,
            "draft_accept_rate": round(acc / prop, 4) if prop else 0.0,
            "decode_model_steps": self.decode_model_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_executed": self.prefill_tokens,
            "cached_prefix_tokens": self.cache_hit_tokens,
            "cache_hits": self.cache_hits,
            "cache_evictions": self.cache_evictions,
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            "timeouts": self.timeouts,
            "rejections": self.rejections,
            "overlap_steps": self.overlap_steps,
            "quiesces": self.quiesces,
            "kv_exports": self.kv_exports,
            "kv_imports": self.kv_imports,
            "kv_pages_exported": self.kv_pages_exported,
            "kv_pages_imported": self.kv_pages_imported,
            # tensor-parallel serving: the mp degree (1: one card)
            "tp_degree": self.tp,
            "quantized_allreduce": self.quantized_allreduce,
        }

    def stats_snapshot(self) -> EngineStats:
        """Immutable flattened :class:`EngineStats` snapshot of
        ``stats()``: ``later.delta(earlier)`` is the exact activity of the
        window between two snapshots."""
        return EngineStats.capture(self.stats(), clock=self._clock)

    def release_cache(self) -> int:
        """Drop every evictable cached page back to the free list; returns
        the pages freed.  Pages attached to live requests are untouched."""
        if self.cache is None:
            return 0
        freed = self.cache.evict(self.pool.num_pages)
        self.cache_evictions += freed
        return freed

    def check_invariants(self):
        """Page-refcount accounting must equal what the live page tables,
        the detached retirements still in flight and the prefix cache
        reference; valid at any step boundary."""
        expect: dict[int, int] = {}
        for slot in self._slots:
            if slot is None:
                continue
            for p in slot.pages:
                expect[p] = expect.get(p, 0) + 1
        if self._inflight is not None:
            for lane in self._inflight.lanes:
                if lane.retiring:
                    for p in lane.slot.pages:
                        expect[p] = expect.get(p, 0) + 1
        if self.cache is not None:
            for p in self.cache.pages():
                expect[p] = expect.get(p, 0) + 1
        if expect != self.pool._refs:
            raise AssertionError(
                f"page refcount drift: tables+cache say {expect}, "
                f"pool says {self.pool._refs}")
        free = self.pool._free
        if self.pool.num_free + self.pool.num_allocated \
                != self.pool.num_pages:
            raise AssertionError("free + allocated != pool size")
        if len(set(free)) != len(free):
            raise AssertionError("duplicate page on the free list")
        if set(free) & set(self.pool._refs):
            raise AssertionError("page simultaneously free and referenced")


def serve_requests(params, config, prompts, **kw):
    """One-shot convenience: submit every prompt (a token array, or a
    ``(tokens, {request kwargs})`` pair) and run to completion; returns
    ``([Request, ...], engine)``.  Engine kwargs ride ``**kw``."""
    req_kw_keys = ("max_new_tokens", "temperature", "top_p", "eos_token_id",
                   "timeout")
    default_req = {k: kw.pop(k) for k in req_kw_keys if k in kw}
    eng = ServingEngine(params, config, **kw)
    rids = []
    for p in prompts:
        merged = dict(default_req)
        if isinstance(p, tuple):
            p, rkw = p
            merged.update(rkw)
        rids.append(eng.submit(p, **merged))
    done = eng.run()
    return [done[r] for r in rids], eng
