"""Paged-KV cache manager + continuous-batching serving engine.

Port of ``paddle_tpu/inference/paged.py`` in its synchronous form.  The model
math lives in ``models/llama.build_llama_paged_decode``, the attention kernel
in ``ops/paged_attention`` (CUDA, ``ops/csrc/ragged_paged_attention.cu``).

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

Device state: the page pool ``[L, Hkv, NP + 1, ps, D]`` (the last page is
the trash page; a ``{"q": codes, "s": scales}`` dict per side with
``kv_dtype``) lives on the engine's device and is updated IN PLACE by
every prefill, chunk, decode or verify step and copy-on-write copy; the
JAX engine donated and rebound it instead.  Host state (slot table, page
tables, lengths) is numpy, mirrored to the device once per dispatch.

Not ported yet (later slices): the overlapped host loop, telemetry,
snapshot/restore, KV export/import, tensor-parallel meshes, deadlines and
cancellation.
"""
from __future__ import annotations

import hashlib
import math
import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import (_sample_per_request, build_llama_paged_decode,
                            make_paged_decode_horizon)
from ..serving.quant import page_bytes as _page_bytes
from ..serving.quant import quantize_params

__all__ = ["PagePool", "PrefixCache", "Request", "ServingEngine",
           "serve_requests", "prefix_chain_hashes", "PoolCapacityError",
           "AdmissionRejected", "EngineStalledError", "PageDoubleFreeError"]


class PoolCapacityError(ValueError):
    """The request can NEVER fit the configured pool / page-table geometry
    (a sizing error, distinct from malformed input)."""


class AdmissionRejected(RuntimeError):
    """The bounded admission queue is full — backpressure; retry later."""


class EngineStalledError(RuntimeError):
    """run() made no progress for max_stall_steps consecutive steps."""


class PageDoubleFreeError(RuntimeError):
    """free()/share() saw a page holding no reference (double free or
    foreign page), or the same page id twice within one free() batch."""


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

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def alloc(self, n: int):
        """Pop n pages at refcount 1; raises RuntimeError when the pool
        cannot satisfy the request (callers check ``num_free`` first)."""
        if n < 0:
            raise ValueError("alloc(n): n must be >= 0")
        if n > len(self._free):
            raise RuntimeError(
                f"PagePool exhausted: requested {n} pages, "
                f"{len(self._free)} free of {self.num_pages}")
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
        for i in range(n_full):
            key = _chain_digest(parent, tokens[i * ps:(i + 1) * ps])
            e = self._full.get(key)
            if e is None:
                self.pool.share([pages[i]])
                e = _CacheEntry(key, parent, int(pages[i]))
                self._full[key] = e
                if parent in self._full:
                    self._full[parent].children += 1
            self._touch(e)
            parent = key
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
        return freed

    def _drop(self, e: _CacheEntry):
        if e.tokens is None:
            del self._full[e.key]
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
    # filled by the engine
    generated: list = field(default_factory=list)
    submit_time: float = 0.0
    admit_time: float = 0.0            # first admission into a slot
    first_token_time: float = 0.0
    finish_time: float = 0.0
    preemptions: int = 0               # times evicted + requeued mid-flight
    cached_prefix_tokens: int = 0      # prefix-cache tokens attached
    draft_proposed: int = 0            # speculative draft tokens proposed
    draft_accepted: int = 0            #   ... verified AND emitted

    @property
    def ttft(self) -> float:
        """Time to first token, seconds (0.0 until the first token)."""
        return self.first_token_time - self.submit_time \
            if self.first_token_time else 0.0


class _Slot:
    __slots__ = ("req", "pages", "pending", "admit_seq", "prefill_pos",
                 "ctx", "resuming", "chunk_step", "draft", "spec_k")

    def __init__(self, req, pages, pending, admit_seq=0):
        self.req = req
        self.pages = pages             # physical page ids, in order
        self.pending = pending         # last sampled token, not yet cached
        self.admit_seq = admit_seq     # monotonically increasing admit order
        self.prefill_pos = None        # tokens prefilled so far; None once
        self.ctx = None                #   decoding (chunked-prefill state)
        self.resuming = False          # re-admission after preemption
        self.chunk_step = -1           # engine step of the last chunk run
        self.draft = None              # _NgramDraft (speculative greedy)
        self.spec_k = 0                # adaptive per-slot draft length


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
    ``attention_impl``: "auto" (the CUDA kernels on the card, the plain
    version on the CPU), "kernel", or "ref" (the plain version always).
    Sampling draws from one ``torch.Generator`` seeded with ``seed`` on the
    engine's device."""

    def __init__(self, params, config, num_slots: int = 4,
                 page_size: int = 16, num_pages: int | None = None,
                 max_pages_per_seq: int | None = None, dtype=None,
                 attention_impl: str = "auto", prompt_bucket: int = 32,
                 decode_horizon: int = 8, seed: int = 0,
                 max_queue: int | None = None, prefix_cache: bool = True,
                 prefill_chunk: int | None = None,
                 speculative: int | None = None, spec_max_ngram: int = 3,
                 kv_dtype: str | None = None, quantize=None, device=None):
        self.device = resolve_device(device)
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
        self._dtype = dtype
        (init_pages, self._prefill, self._prefill_chunk_fn, decode_step,
         self._verify_fn) = build_llama_paged_decode(
            config, page_size=page_size, num_pages=num_pages, dtype=dtype,
            attention_impl=attention_impl, device=self.device,
            kv_dtype=self.kv_dtype)
        pages = init_pages()
        self._pages_k, self._pages_v = pages["k"], pages["v"]
        self._horizon = make_paged_decode_horizon(decode_step)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))

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
        self._step_seq = 0             # step() invocations (chunk pacing)
        self.steps_run = 0             # decode-horizon + verify dispatches
        self.decode_model_steps = 0    # decode_step calls (K per horizon)
        self.prefill_chunks = 0        # prefill_chunk dispatches
        self.verify_steps = 0          # speculative verify dispatches
        self.draft_tokens_proposed = 0  # draft tokens sent to verify
        self.draft_tokens_accepted = 0  # ... accepted and emitted
        self.tokens_generated = 0
        self.preemptions = 0
        self.rejections = 0
        self.cache_hits = 0            # admissions that attached a prefix
        self.cache_hit_tokens = 0      # prefill tokens skipped via the cache
        self.prefill_tokens = 0        # prefill tokens actually executed
        self.cache_evictions = 0
        self.cow_copies = 0
        _LIVE_ENGINES.add(self)

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0, top_p: float = 1.0,
               eos_token_id: int | None = None) -> int:
        """Queue one request; returns its rid.  Raises
        ``PoolCapacityError`` for a request that can never fit the pool
        geometry, ``AdmissionRejected`` when the bounded queue is full, and
        ValueError for malformed input."""
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
            raise AdmissionRejected(
                f"admission queue full ({len(self._queue)}/{self.max_queue} "
                f"waiting) — backpressure, retry later")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_p=float(top_p),
            eos_token_id=eos_token_id, submit_time=time.perf_counter()))
        return rid

    # -- internals ---------------------------------------------------------
    def _evict(self, n: int) -> int:
        """Ladder rung between stall and preempt: reclaim up to n pages
        from the prefix cache (LRU leaf-first)."""
        if self.cache is None or n <= 0:
            return 0
        freed = self.cache.evict(n)
        self.cache_evictions += freed
        return freed

    def _register_slot(self, s: int, with_partial: bool):
        """Index the slot's written-so-far KV (its first ``lengths[s]``
        tokens) into the prefix cache."""
        slot = self._slots[s]
        valid = int(self._lengths[s])
        if self.cache is None or valid <= 0:
            return
        seq = np.concatenate(
            [slot.req.prompt, np.asarray(slot.req.generated, np.int32)])
        self.cache.register(seq[:valid], slot.pages,
                            with_partial=with_partial)

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
        slot.req.finish_time = time.perf_counter()
        self._finished[slot.req.rid] = slot.req

    def _preempt(self, s: int):
        """Park the slot's written KV in the prefix cache, return its page
        references, and requeue the request at the queue head; its
        re-admission re-prefills prompt + emitted tokens (often hitting the
        blocks parked here)."""
        self._register_slot(s, with_partial=True)
        slot = self._release_slot(s)
        slot.req.preemptions += 1
        self.preemptions += 1
        self._queue.appendleft(slot.req)

    def _pick_victim(self) -> int:
        """Youngest / lowest-progress victim: fewest emitted tokens, ties
        broken toward the most recent admission."""
        return min((s for s, sl in enumerate(self._slots) if sl is not None),
                   key=lambda s: (len(self._slots[s].req.generated),
                                  -self._slots[s].admit_seq))

    def _record_token(self, s: int, tok: int) -> bool:
        """Append one sampled token (a host int); returns True when the
        request finished (EOS / budget) and retires it in place."""
        slot = self._slots[s]
        req = slot.req
        req.generated.append(tok)
        if slot.draft is not None:
            slot.draft.append(tok)
        if req.first_token_time == 0.0:
            req.first_token_time = time.perf_counter()
        self.tokens_generated += 1
        done = (req.eos_token_id is not None and tok == req.eos_token_id) \
            or len(req.generated) >= req.max_new_tokens
        if done:
            self._finish(s)
        else:
            slot.pending = tok
        return done

    def _cow(self, s: int, idx: int, src: int | None = None):
        """Copy-on-write: give slot s its own copy of the (shared) page at
        table index idx before anything writes into it; ``src`` overrides
        the copy source (admission attaches a cached partial page without
        putting the shared id in the table).  The copy runs in place on the
        page pool, before the write that needed it is issued."""
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

    def _sample_one(self, logits, req):
        """First-token sample of a sampled (temperature > 0) request."""
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
            if need > self.pool.num_free:
                self._evict(need - self.pool.num_free)
            if need > self.pool.num_free:
                if pin:
                    self.pool.free(pin)
                return                 # wait for retirements to free pages
            own = self.pool.alloc(need)
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
            if req.admit_time == 0.0:
                req.admit_time = time.perf_counter()
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
        logits, _, _ = self._prefill(self.params, self._tensor(ids), T,
                                     self._tensor(row), self._pages_k,
                                     self._pages_v)
        if self.cache is not None:
            self.cache.register(ctx, slot.pages)
        if slot.resuming:
            # the re-prefill rebuilt the cache; the last emitted token is
            # still the pending one
            slot.pending = req.generated[-1]
        elif req.temperature <= 0.0:
            self._record_token(s, int(torch.argmax(logits)))
        else:
            self._record_token(s, int(self._sample_one(logits, req)))

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
        logits, tok_g, _, _ = self._prefill_chunk_fn(
            self.params, self._tensor(ids), pos, c,
            self._tensor(self._page_tables[s, :Pb].copy()),
            self._pages_k, self._pages_v)
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
            self._record_token(s, int(tok_g))
        else:
            self._record_token(s, int(self._sample_one(logits, req)))

    def _remaining(self, s: int) -> int:
        slot = self._slots[s]
        return slot.req.max_new_tokens - len(slot.req.generated)

    def _provision(self, steps):
        """Lazy page growth for up to ``steps`` decode steps ahead: every
        decoding slot gets pages covering write positions < lengths +
        min(steps, remaining).  ``steps`` is an int, or a {slot: tokens}
        dict of per-slot needs (the verify path: 1 + draft length; slots
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
                if self.pool.num_free < 1:
                    self._evict(1)
                if self.pool.num_free < 1:
                    continue
                self._cow(s, w0)
            m = min(want, self._remaining(s))
            need = math.ceil((int(self._lengths[s]) + m) / self.page_size)
            grow = need - len(slot.pages)
            if grow > 0:
                if grow > self.pool.num_free:
                    self._evict(grow - self.pool.num_free)
                if grow > self.pool.num_free:
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
        Q = self.speculative + 1
        S = self.num_slots
        toks = np.zeros((S, Q), np.int32)
        n_q = np.zeros((S,), np.int32)
        for s in run:
            d = drafts.get(s, ())
            toks[s, 0] = self._slots[s].pending
            toks[s, 1:1 + len(d)] = d
            n_q[s] = 1 + len(d)
        logits0, gtoks, _, _ = self._verify_fn(
            self.params, self._tensor(toks), self._tensor(self._lengths),
            self._tensor(self._page_tables), self._pages_k, self._pages_v,
            self._tensor(n_q))
        gtoks = gtoks.cpu().numpy()    # the one per-verify sync
        self.steps_run += 1
        self.verify_steps += 1
        lens = self._lengths.tolist()
        for s in run:
            slot = self._slots[s]
            req = slot.req
            d = list(drafts.get(s, ()))
            nd = len(d)
            old = lens[s]
            if req.temperature > 0.0:
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

    def _decode(self, run, K: int, greedy: bool):
        """One K-step decode horizon over the runnable lanes, then ONE
        device->host fetch of the emitted tokens, replayed on the host with
        the horizon's freeze logic (EOS / budget)."""
        S = self.num_slots
        active = np.zeros((S,), bool)
        active[run] = True
        toks = np.zeros((S,), np.int32)
        remaining = np.ones((S,), np.int32)
        eos_ids = np.full((S,), -1, np.int32)
        for s in run:
            slot = self._slots[s]
            remaining[s] = self._remaining(s)
            if slot.req.eos_token_id is not None:
                eos_ids[s] = slot.req.eos_token_id
            toks[s] = slot.pending
        out, *_ = self._horizon(
            self.params, self._tensor(toks), self._tensor(self._lengths),
            self._tensor(self._page_tables), self._pages_k, self._pages_v,
            self._tensor(active), self._gen, self._tensor(self._temps),
            self._tensor(self._top_ps), self._tensor(remaining),
            self._tensor(eos_ids), torch.zeros(S, dtype=torch.bool,
                                               device=self.device),
            K=K, greedy=greedy)
        self.steps_run += 1
        self.decode_model_steps += K
        out = out.cpu().numpy()        # the one per-horizon sync
        for s in run:
            base = int(self._lengths[s])
            emitted = 0
            for tok in out[s].tolist():
                emitted += 1
                self._lengths[s] = base + emitted
                if self._record_token(s, tok):
                    break

    # -- the serving loop --------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(1 for sl in self._slots if sl is not None)

    def step(self) -> bool:
        """One engine step: admit queued requests into free slots
        (attaching cached prefixes), advance each mid-prefill slot by one
        chunk, provision pages for the decode horizon, run it, record the
        tokens and retire finished requests into the prefix cache.  When
        nobody can progress the engine evicts cached pages, then preempts
        a victim.  Returns True when any slot made progress."""
        self._step_seq += 1
        pre_tokens = self.tokens_generated
        pre_finished = len(self._finished)
        pre_admit_seq = self._admit_seq
        self._admit()
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
            # one ride along as single-token lanes.  Draftless or pool-tight
            # steps fall through to the decode horizon.
            drafts = self._propose_drafts()
            if drafts:
                run = self._provision(
                    {s: 1 + len(d) for s, d in drafts.items()})
                if run:
                    self._verify(run, drafts)
                    return True
        K = self.decode_horizon
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
        self._decode(run, K, greedy)
        return True

    def run(self, max_steps: int | None = None,
            max_stall_steps: int = 1000):
        """Drive until every submitted request finished; returns
        {rid: Request}.  Raises ``EngineStalledError`` after
        ``max_stall_steps`` consecutive no-progress steps."""
        steps = 0
        stalled = 0
        while self._queue or self.num_active:
            stalled = 0 if self.step() else stalled + 1
            if stalled >= max_stall_steps:
                raise EngineStalledError(
                    f"no engine progress for {stalled} consecutive steps "
                    f"({self.num_active} active, {len(self._queue)} queued, "
                    f"{self.pool.num_free} pages free of "
                    f"{self.pool.num_pages})")
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self._finished)

    # -- accounting / invariants -------------------------------------------
    @property
    def page_bytes(self) -> int:
        """Bytes one pool page costs on the device: K + V across all
        layers, with the per-row scales of a quantized ``kv_dtype``."""
        return _page_bytes(self.config, self.page_size,
                           kv_dtype=self.kv_dtype, dtype=self._dtype)

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
            "rejections": self.rejections,
        }

    def release_cache(self) -> int:
        """Drop every evictable cached page back to the free list; returns
        the pages freed.  Pages attached to live requests are untouched."""
        if self.cache is None:
            return 0
        freed = self.cache.evict(self.pool.num_pages)
        self.cache_evictions += freed
        return freed

    def check_invariants(self):
        """Page-refcount accounting must equal what the live page tables +
        prefix cache reference; valid at any step boundary."""
        expect: dict[int, int] = {}
        for slot in self._slots:
            if slot is None:
                continue
            for p in slot.pages:
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
    req_kw_keys = ("max_new_tokens", "temperature", "top_p", "eos_token_id")
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
