"""Fleet routing strategies: least-loaded and prefix-affinity placement.

Least-loaded placement is correct for interchangeable replicas and wrong
at fleet scale with per-replica prefix caches: two turns of the same
conversation land on different replicas, each re-prefills the shared
history, and the fleet-wide cache hit rate collapses to a fraction of what
a single engine gets on the identical traffic.

This module turns placement into a strategy seam:

  * :class:`Router` — the interface: ``decide(tokens, candidates)``
    returns a :class:`RoutingDecision` (candidate try-order + why).  The
    fleet walks the order and admits on the first replica that accepts;
    routers also receive replica lifecycle (``on_replica_added`` /
    ``on_replica_removed``) and cached-chain feed
    (``note_cached`` / ``note_evicted``) notifications.
  * :class:`LeastLoadedRouter` — the default policy: ascending (load,
    name).
  * :class:`PrefixAffinityRouter` — computes the prompt's page-aligned
    chained block-hash with the SAME implementation the engine-side
    :class:`~paddle_tpu_torch.inference.paged.PrefixCache` indexes
    (:func:`~paddle_tpu_torch.inference.paged.prefix_chain_hashes` — one
    function, two callers, bit-identical chains), consults a compact
    per-replica summary of cached chain digests kept current from the
    cache's insert/evict notifications, and routes to the replica holding
    the LONGEST cached chain — subject to a bounded-imbalance guard
    (``max_imbalance``): when the affinity target already carries that
    many more requests than the least-loaded replica, the router falls
    back to least-loaded so affinity can never starve load balance.

The summary stores ``digest_bytes``-truncated digests (8 bytes default):
a few MB would cover millions of cached blocks, and a truncation
collision merely makes one routing HINT wrong — correctness is untouched
(the engine's own full-digest cache decides what actually attaches).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..inference.paged import prefix_chain_hashes

__all__ = ["Router", "RoutingDecision", "LeastLoadedRouter",
           "PrefixAffinityRouter"]


@dataclass
class RoutingDecision:
    """One placement decision: the candidate try-order plus the routing
    reason (the fleet flight-records it; ``kind`` is one of
    ``least_loaded`` — no affinity information used, ``affinity`` — the
    longest-chain replica leads the order, ``affinity_fallback`` — a
    chain existed but the imbalance guard overrode it)."""
    order: list[str]
    kind: str = "least_loaded"
    target: str | None = None
    matched_blocks: int = 0


class Router:
    """Placement-strategy interface.  ``candidates`` is a list of
    ``(name, load)`` pairs for every live, routable replica (load = the
    replica's active + queued request count — the least-loaded
    metric); routers never see engine internals.  ``tokens`` is the token
    stream the placement would prefill (prompt, or prompt + streamed
    tokens for a migration) — affinity-aware routers hash it, others
    ignore it."""

    name = "base"

    def configure(self, *, page_size: int | None = None):
        """Fleet wiring hook: called once with the engine geometry before
        the first placement (routers that hash pages need ``page_size``;
        others ignore it)."""

    # -- placement ---------------------------------------------------------
    def decide(self, tokens, candidates, memo=None,
               role=None) -> RoutingDecision:
        """``memo`` (optional dict) is per-request scratch the FLEET
        clears whenever the request's token stream changes — routers may
        park derived state there (the affinity chain digests) so a
        backoff retry of an unchanged request costs no re-hashing.

        ``role`` (disaggregated fleets) names the replica role this
        placement targets — ``"prefill"`` for fresh admissions,
        ``"decode"`` for KV handoffs, None for a role-less fleet.  The
        FLEET pre-filters ``candidates`` to that role; routers order what
        they are given and record the role for ``stats()``."""
        raise NotImplementedError

    def _note_role(self, role):
        """Per-role placement accounting (lazy: a role-less fleet never
        allocates the dict)."""
        if role is None:
            return
        counts = getattr(self, "_role_counts", None)
        if counts is None:
            counts = self._role_counts = {}
        counts[role] = counts.get(role, 0) + 1

    def _role_stats(self) -> dict:
        counts = getattr(self, "_role_counts", None)
        return {} if not counts else {"routed_by_role": dict(counts)}

    # -- replica lifecycle -------------------------------------------------
    def on_replica_added(self, name: str):
        """A replica joined (initial build, scale-up, or failover
        revival) — routers reset any per-replica state they keep."""

    def on_replica_removed(self, name: str):
        """A replica left (crash or drain-retirement) — its cached state
        is gone with it."""

    # -- cached-chain feed -------------------------------------------------
    def note_cached(self, name: str, digests):
        """``digests`` full-block chain digests were inserted into
        ``name``'s prefix cache."""

    def note_evicted(self, name: str, digests):
        """``digests`` were evicted from ``name``'s prefix cache."""

    def stats(self) -> dict:
        return {"router": self.name, **self._role_stats()}


class LeastLoadedRouter(Router):
    """The default policy as a strategy: every live replica in
    ascending (load, name) order — deterministic tie-break, no state."""

    name = "least_loaded"

    def decide(self, tokens, candidates, memo=None,
               role=None) -> RoutingDecision:
        self._note_role(role)
        order = [n for n, _load in sorted(candidates,
                                          key=lambda c: (c[1], c[0]))]
        return RoutingDecision(order=order, kind="least_loaded",
                               target=order[0] if order else None)


class PrefixAffinityRouter(Router):
    """Route shared-prefix traffic to the replica already holding its KV.

    For each placement: compute the chained block-hash of the tokens to
    prefill (capped at ``len - 1``, mirroring ``PrefixCache.lookup``'s
    attach cap), count how many leading blocks each candidate's summary
    holds, and lead the try-order with the longest-chain replica —
    unless that replica's load exceeds the least-loaded candidate's by
    more than ``max_imbalance`` requests (the bounded-imbalance guard:
    affinity is a throughput hint, never a reason to queue behind a hot
    replica while others idle).  Ties break toward lower load, then
    name.  The rest of the order is least-loaded, so a full affinity
    target degrades to exactly the least-loaded behavior.

    Counters (also surfaced via ``ReplicaFleet.stats_snapshot``):
    ``affinity_hits`` placements led by a cached chain,
    ``affinity_fallbacks`` guard overrides, ``affinity_misses``
    placements where no candidate held any block."""

    name = "prefix_affinity"

    def __init__(self, *, page_size: int | None = None,
                 max_imbalance: int = 4, digest_bytes: int = 8):
        self.page_size = None if page_size is None else int(page_size)
        self.max_imbalance = int(max_imbalance)
        self.digest_bytes = int(digest_bytes)
        self._summary: dict[str, set[bytes]] = {}
        self.affinity_hits = 0
        self.affinity_fallbacks = 0
        self.affinity_misses = 0
        self.matched_blocks_total = 0

    def configure(self, *, page_size: int | None = None):
        if page_size is not None and self.page_size is None:
            self.page_size = int(page_size)

    def _trunc(self, d: bytes) -> bytes:
        return d[:self.digest_bytes]

    # -- lifecycle + feed --------------------------------------------------
    def on_replica_added(self, name: str):
        self._summary[name] = set()

    def on_replica_removed(self, name: str):
        self._summary.pop(name, None)

    def note_cached(self, name: str, digests):
        s = self._summary.setdefault(name, set())
        for d in digests:
            s.add(self._trunc(d))

    def note_evicted(self, name: str, digests):
        s = self._summary.get(name)
        if s is not None:
            for d in digests:
                s.discard(self._trunc(d))

    def summary_blocks(self, name: str) -> int:
        return len(self._summary.get(name, ()))

    # -- placement ---------------------------------------------------------
    def _matched(self, chain: list[bytes], name: str) -> int:
        s = self._summary.get(name)
        if not s:
            return 0
        n = 0
        for d in chain:
            if self._trunc(d) not in s:
                break
            n += 1
        return n

    def decide(self, tokens, candidates, memo=None,
               role=None) -> RoutingDecision:
        self._note_role(role)
        by_load = sorted(candidates, key=lambda c: (c[1], c[0]))
        order = [n for n, _load in by_load]
        if not order or self.page_size is None:
            return RoutingDecision(order=order, kind="least_loaded",
                                   target=order[0] if order else None)
        chain = memo.get("chain") if memo is not None else None
        if chain is None:
            tokens = np.asarray(tokens, np.int32).reshape(-1)
            # mirror PrefixCache.lookup's cap: at least one suffix token
            # must remain to prefill, so the final boundary block never
            # attaches
            chain = prefix_chain_hashes(tokens[:-1], self.page_size)
            if memo is not None:
                memo["chain"] = chain
        best_name, best_load, best_m = None, 0, 0
        if chain:
            for name, load in by_load:
                m = self._matched(chain, name)
                # strictly-greater: ties stay with the lower-load
                # candidate (by_load order)
                if m > best_m:
                    best_name, best_load, best_m = name, load, m
        if best_m == 0:
            self.affinity_misses += 1
            return RoutingDecision(order=order, kind="least_loaded",
                                   target=order[0] if order else None)
        min_load = by_load[0][1]
        if best_load - min_load > self.max_imbalance:
            self.affinity_fallbacks += 1
            return RoutingDecision(order=order, kind="affinity_fallback",
                                   target=order[0] if order else None,
                                   matched_blocks=best_m)
        self.affinity_hits += 1
        self.matched_blocks_total += best_m
        order = [best_name] + [n for n in order if n != best_name]
        return RoutingDecision(order=order, kind="affinity",
                               target=best_name, matched_blocks=best_m)

    def stats(self) -> dict:
        routed = self.affinity_hits + self.affinity_fallbacks \
            + self.affinity_misses
        return {
            "router": self.name,
            "max_imbalance": self.max_imbalance,
            "routed": routed,
            "affinity_hits": self.affinity_hits,
            "affinity_fallbacks": self.affinity_fallbacks,
            "affinity_misses": self.affinity_misses,
            "matched_blocks_total": self.matched_blocks_total,
            "summary_blocks": {n: len(s)
                               for n, s in sorted(self._summary.items())},
            **self._role_stats(),
        }
