"""ElasticManager (reference fleet/elastic/manager.py:125).

The reference watches an etcd prefix: each trainer registers
`/job/nodes/<host>` with a TTL lease; the manager reacts to node
join/leave by regenerating `PADDLE_TRAINER_ENDPOINTS`/rank env and
relaunching trainers (fault tolerance = relaunch from checkpoint).

The coordination role is a pluggable `Store` —
`MemoryStore` (in-process, tests), `FileStore` (shared filesystem, the
single-host/NFS analog of etcd; heartbeat files with mtime as the TTL
lease). The manager's state machine matches the reference:

  register(host)           — lease registration
  watch() -> ElasticStatus — HOLD (stable) / CHANGE (membership moved)
                             / EXIT (below np_min after grace)
  rank_map()               — deterministic host → rank assignment
  on_change(cb)            — relaunch trigger (launch_gang restart hook)
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Callable, Dict, List, Optional

__all__ = ["ElasticStatus", "ElasticManager", "FileStore", "MemoryStore"]


class ElasticStatus(enum.Enum):
    HOLD = "hold"        # membership stable
    CHANGE = "change"    # nodes joined/left within [np_min, np_max]
    EXIT = "exit"        # below np_min past the grace period


class MemoryStore:
    """In-process membership store (unit tests / single-controller).

    alive() orders by seniority (first registration time, then host name):
    every manager derives the SAME membership prefix from the same store
    state, so truncation at np_max is deterministic and joiners cannot
    evict senior members."""

    def __init__(self):
        self._beats: Dict[str, float] = {}
        self._first: Dict[str, float] = {}

    def heartbeat(self, host: str, ts: float = None, stale_after: float = None):
        now = ts if ts is not None else time.time()
        prev = self._beats.get(host)
        if prev is not None and stale_after is not None \
                and now - prev > stale_after:
            # the lease lapsed: a returning host re-enters as a JOINER —
            # it must not evict whoever replaced it (seniority resets)
            self._first.pop(host, None)
        self._beats[host] = now
        self._first.setdefault(host, now)

    def remove(self, host: str):
        self._beats.pop(host, None)
        self._first.pop(host, None)

    def alive(self, timeout: float) -> List[str]:
        now = time.time()
        live = [h for h, t in self._beats.items() if now - t <= timeout]
        return sorted(live, key=lambda h: (self._first.get(h, 0.0), h))


class FileStore:
    """Shared-filesystem membership store (the etcd-lease analog for
    single-host / NFS deployments): one heartbeat file per host, mtime is
    the lease."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, host):
        return os.path.join(self.root, f"node.{host.replace(':', '_')}")

    def heartbeat(self, host: str, ts: float = None, stale_after: float = None):
        p = self._path(host)
        now = ts if ts is not None else time.time()
        # preserve the first-registration time across beats (seniority key);
        # a lapsed lease resets it — the returning host re-enters as a joiner
        first = None
        try:
            if stale_after is None or now - os.path.getmtime(p) <= stale_after:
                first = open(p).read().split("\n")[1]
        except (OSError, IndexError):
            pass
        if first is None:
            first = repr(now)
        tmp = p + ".tmp"
        # atomic rename: a concurrent alive() must never read a truncated
        # host string (NFS deployment is this store's stated purpose)
        with open(tmp, "w") as f:
            f.write(f"{host}\n{first}")
        if ts is not None:
            os.utime(tmp, (ts, ts))
        os.replace(tmp, p)

    def remove(self, host: str):
        try:
            os.unlink(self._path(host))
        except FileNotFoundError:
            pass

    def alive(self, timeout: float) -> List[str]:
        """Live hosts ordered by (first registration, host) — the same
        deterministic prefix on every manager reading this store."""
        now = time.time()
        out = []
        for fn in os.listdir(self.root):
            if not fn.startswith("node."):
                continue
            p = os.path.join(self.root, fn)
            try:
                if now - os.path.getmtime(p) <= timeout:
                    parts = open(p).read().split("\n")
                    host = parts[0].strip()
                    first = float(parts[1]) if len(parts) > 1 else 0.0
                    if host:
                        out.append((first, host))
            except (OSError, ValueError):
                continue
        return [h for _, h in sorted(out)]


@dataclasses.dataclass
class _State:
    members: tuple = ()
    below_since: Optional[float] = None
    seen: bool = False          # first watch() is an observation, not a CHANGE


class ElasticManager:
    """reference manager.py:125: membership watch + rank regeneration.

    np_min/np_max: the elastic range (reference --np=min:max). A membership
    change inside the range returns CHANGE (caller relaunches with the new
    rank map, resuming from checkpoint); dropping below np_min starts the
    grace clock and returns EXIT once expired.
    """

    def __init__(self, store, np_min: int, np_max: int = None,
                 heartbeat_timeout: float = 10.0, grace_period: float = 30.0):
        self.store = store
        self.np_min = np_min
        self.np_max = np_max or np_min
        self.heartbeat_timeout = heartbeat_timeout
        self.grace_period = grace_period
        self._state = _State()
        self._callbacks: List[Callable] = []

    # -- lease/registration --------------------------------------------------
    def register(self, host: str):
        self.store.heartbeat(host, stale_after=self.heartbeat_timeout)

    def heartbeat(self, host: str):
        self.store.heartbeat(host, stale_after=self.heartbeat_timeout)

    def deregister(self, host: str):
        self.store.remove(host)

    # -- membership ----------------------------------------------------------
    def members(self) -> List[str]:
        """First np_max live hosts in the store's seniority order — pure
        function of store state, so every manager (including a freshly
        started one) derives the same membership, and a joiner can never
        evict a senior active worker at capacity."""
        return self.store.alive(self.heartbeat_timeout)[: self.np_max]

    def rank_map(self) -> Dict[str, int]:
        """Deterministic host→rank map (sorted order, reference re-rank)."""
        return {h: i for i, h in enumerate(self.members())}

    def endpoints(self) -> str:
        return ",".join(self.members())

    def on_change(self, cb: Callable):
        self._callbacks.append(cb)

    # -- the watch step ------------------------------------------------------
    def watch(self) -> ElasticStatus:
        cur = tuple(self.members())
        prev = self._state.members
        if len(cur) < self.np_min:
            if self._state.below_since is None:
                self._state.below_since = time.time()
            elif time.time() - self._state.below_since > self.grace_period:
                return ElasticStatus.EXIT
            self._state.members = cur
            return ElasticStatus.HOLD   # waiting out the grace period
        self._state.below_since = None
        if self._state.seen and cur != prev:
            self._state.members = cur
            for cb in self._callbacks:
                cb(self.rank_map())
            return ElasticStatus.CHANGE
        self._state.members = cur
        self._state.seen = True
        return ElasticStatus.HOLD
