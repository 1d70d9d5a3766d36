"""Length-prefixed loopback RPC for the cross-process fleet.

Port of ``paddle_tpu/serving/rpc.py``: the same frames on the wire, so a
client of either package speaks to a server of the other.

One frame = an 8-byte header (magic ``PWKR`` + big-endian body length)
followed by a UTF-8 JSON body.  Requests are ``{"m": method, "k": key,
"p": params}``; replies are ``{"ok": true, "r": result}`` or ``{"ok":
false, "etype": <exception class name>, "error": <message>}``.

The client owns the reliability story so a worker stays dumb:

* **deadline-per-call** — ``call()`` takes an absolute time budget; each
  attempt gets ``min(remaining, attempt_timeout)`` as its socket timeout
  and the loop raises :class:`RpcTimeout` when the budget is spent.
* **exponential backoff with jitter** — failed attempts sleep
  ``backoff_base * 2**attempt`` capped at ``backoff_cap``, scaled by a
  seeded jitter factor, so a wedged worker is not hammered in lockstep.
* **idempotent retry keys** — every logical call mints one key reused
  verbatim across retries; the server caches the reply per key (bounded
  LRU) and a duplicate key returns the cached reply *without re-invoking
  the handler*.  A lost response frame therefore never double-submits a
  request or double-streams a token.  A duplicate that races the original
  (still in flight) waits on a per-key event and receives the same reply.

Wire-level fault points (consulted client-side — fault plans are
in-process, and the supervisor is where chaos drills run; see the catalog
in :mod:`paddle_tpu_torch.resilience.faults`):

* ``rpc.drop_frame``     (trigger) — the request frame never reaches the
  wire; the client still waits on the reply, burning the attempt timeout
  exactly like a frame lost by the kernel.
* ``rpc.delay_frame``    (trigger) — the frame is sent ``fault_delay_s``
  late (reordering / congestion).
* ``rpc.truncate_frame`` (trigger) — half the body is sent, then the
  connection dies; the server must drop the torn frame without invoking
  the handler.
* ``rpc.half_open``      (trigger) — the frame is fully sent but the
  client's side dies before the reply; the handler runs exactly once and
  the retry must be served from the idempotency cache.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
import time
from collections import OrderedDict

import numpy as np

from ..resilience.faults import fault_point

__all__ = ["RpcError", "RpcTimeout", "RpcRemoteError", "RpcClient",
           "RpcServer"]

_MAGIC = 0x50574B52          # "PWKR"
_HEADER = struct.Struct(">II")
_MAX_FRAME = 64 * 1024 * 1024


class RpcError(RuntimeError):
    """Base class for RPC failures."""


class RpcTimeout(RpcError):
    """The per-call deadline elapsed (or retries exhausted) without a
    reply.  The call may or may not have executed on the server — callers
    that need certainty re-issue with the same semantics (submit/adopt are
    keyed, so a later health/poll reconciles)."""


class RpcRemoteError(RpcError):
    """The handler raised on the worker.  ``etype`` carries the remote
    exception class name so supervisors can map admission/capacity errors
    back onto their local types."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype
        self.emsg = message


class _WireError(Exception):
    """Internal: a retryable transport-level failure."""


def _send_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(_HEADER.pack(_MAGIC, len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise _WireError(f"connection closed after {len(buf)}/{n} bytes")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> dict:
    magic, length = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if magic != _MAGIC:
        raise _WireError(f"bad frame magic 0x{magic:08x}")
    if length > _MAX_FRAME:
        raise _WireError(f"frame length {length} exceeds cap {_MAX_FRAME}")
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


class RpcClient:
    """One logical connection to one worker, with deadlines, backoff,
    and idempotent retries.  Not thread-safe; the supervisor serialises
    calls per worker (one client per worker)."""

    def __init__(self, address, *, attempt_timeout: float = 2.0,
                 call_timeout: float = 10.0, connect_timeout: float = 1.0,
                 max_retries: int = 8, backoff_base: float = 0.02,
                 backoff_cap: float = 0.5, jitter: float = 0.5,
                 fault_delay_s: float = 0.05, seed: int = 0):
        self.address = tuple(address)
        self.attempt_timeout = float(attempt_timeout)
        self.call_timeout = float(call_timeout)
        self.connect_timeout = float(connect_timeout)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.jitter = float(jitter)
        self.fault_delay_s = float(fault_delay_s)
        self._rng = np.random.default_rng(seed)
        self._cid = f"{os.getpid():x}.{id(self) & 0xFFFFFF:x}"
        self._seq = itertools.count()
        self._sock: socket.socket | None = None
        self.stats = {"calls": 0, "retries": 0, "reconnects": 0,
                      "timeouts": 0, "backoff_s": 0.0}

    # -- transport ---------------------------------------------------------
    def _connect(self, timeout: float) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self.address,
                                         timeout=max(timeout,
                                                     self.connect_timeout))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self.stats["reconnects"] += 1
        self._sock.settimeout(timeout)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _attempt(self, frame: dict, timeout: float, attempt: int) -> dict:
        method = frame["m"]
        sock = self._connect(timeout)
        dropped = fault_point("rpc.drop_frame",
                              method=method, attempt=attempt) is not None
        if fault_point("rpc.delay_frame",
                       method=method, attempt=attempt) is not None:
            time.sleep(self.fault_delay_s)
        if not dropped:
            if fault_point("rpc.truncate_frame",
                           method=method, attempt=attempt) is not None:
                body = json.dumps(frame).encode("utf-8")
                sock.sendall(_HEADER.pack(_MAGIC, len(body))
                             + body[:max(1, len(body) // 2)])
                self.close()
                raise _WireError("frame truncated by fault plan")
            _send_frame(sock, frame)
            if fault_point("rpc.half_open",
                           method=method, attempt=attempt) is not None:
                # Request fully delivered; our side dies before the reply.
                self.close()
                raise _WireError("half-open socket (fault plan)")
        # A dropped frame still burns the attempt timeout waiting for a
        # reply that can never come — the honest shape of packet loss.
        return _recv_frame(sock)

    # -- public API --------------------------------------------------------
    def call(self, method: str, *, deadline_s: float | None = None,
             **params):
        """Invoke ``method`` on the worker.  ``deadline_s`` is this call's
        total wall-clock budget (default ``call_timeout``)."""
        deadline = time.monotonic() + (self.call_timeout
                                       if deadline_s is None
                                       else float(deadline_s))
        frame = {"m": method, "k": f"{self._cid}:{next(self._seq)}",
                 "p": params}
        self.stats["calls"] += 1
        attempt = 0
        last_err: Exception | None = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or attempt > self.max_retries:
                self.stats["timeouts"] += 1
                raise RpcTimeout(
                    f"rpc {method!r} to {self.address} exceeded deadline "
                    f"after {attempt} attempt(s); last error: {last_err!r}")
            try:
                reply = self._attempt(
                    frame, min(remaining, self.attempt_timeout), attempt)
            except (_WireError, OSError) as e:   # socket.timeout is OSError
                self.close()
                last_err = e
                attempt += 1
                self.stats["retries"] += 1
                pause = min(self.backoff_cap,
                            self.backoff_base * (2.0 ** (attempt - 1)))
                pause *= 1.0 + self.jitter * (self._rng.random() - 0.5)
                pause = max(0.0, min(pause, deadline - time.monotonic()))
                self.stats["backoff_s"] += pause
                if pause:
                    time.sleep(pause)
                continue
            if reply.get("ok"):
                return reply.get("r")
            raise RpcRemoteError(reply.get("etype", "RuntimeError"),
                                 reply.get("error", "remote failure"))


class RpcServer:
    """Threaded accept loop with a bounded idempotency reply cache.

    ``handler(method, params) -> jsonable`` runs at most once per retry
    key; exceptions become error replies (cached too — a failed submit
    retried on the same key fails the same way, it does not re-run)."""

    IDEMPOTENCY_CACHE = 1024

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self.address = self._listener.getsockname()
        self.port = self.address[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._ilock = threading.Lock()
        self._done: OrderedDict[str, dict] = OrderedDict()
        self._inflight: dict[str, threading.Event] = {}
        # stats lock: every rpc-conn thread bumps these counters and the
        # supervisor reads them live — unlocked `+=` is a lost-update
        # race; `_ilock` is not reused so a slow idempotency
        # sweep never serializes the per-frame accounting
        self._slock = threading.Lock()
        self.stats = {"frames": 0, "handler_invocations": 0,
                      "dup_hits": 0, "errors": 0, "torn_frames": 0}

        self._accept_thread: threading.Thread | None = None

    def _bump(self, key: str, by: float = 1) -> None:
        with self._slock:
            self.stats[key] += by

    def start(self) -> "RpcServer":
        t = threading.Thread(target=self._accept_loop,
                             name="rpc-accept", daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        for t in self._threads:
            t.join(timeout=1.0)

    # -- internals ---------------------------------------------------------
    # the accept thread owns the conn-thread registry; stop() only
    # reads _threads after _stop is set and the accept thread joined
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="rpc-conn", daemon=True)
            t.start()
            self._threads.append(t)
            self._threads = [th for th in self._threads if th.is_alive()]

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(0.5)
            while not self._stop.is_set():
                try:
                    frame = _recv_frame(conn)
                except socket.timeout:
                    continue
                except (_WireError, OSError, ValueError):
                    self._bump("torn_frames")
                    return
                self._bump("frames")
                reply = self._dispatch(frame)
                try:
                    _send_frame(conn, reply)
                except OSError:
                    # Half-open peer: the reply is lost but cached; the
                    # retry on the same key will pick it up.
                    return

    def _dispatch(self, frame: dict) -> dict:
        key = frame.get("k")
        waiter = None
        with self._ilock:
            if key in self._done:
                self._bump("dup_hits")
                return self._done[key]
            if key in self._inflight:
                waiter = self._inflight[key]
            else:
                self._inflight[key] = threading.Event()
        if waiter is not None:
            self._bump("dup_hits")
            waiter.wait(timeout=30.0)
            with self._ilock:
                reply = self._done.get(key)
            return reply if reply is not None else {
                "ok": False, "etype": "RpcTimeout",
                "error": "duplicate waited but original never finished"}
        try:
            self._bump("handler_invocations")
            reply = {"ok": True,
                     "r": self._handler(frame.get("m"), frame.get("p") or {})}
        except BaseException as e:  # noqa: BLE001 — wire boundary
            self._bump("errors")
            reply = {"ok": False, "etype": type(e).__name__, "error": str(e)}
        with self._ilock:
            self._done[key] = reply
            while len(self._done) > self.IDEMPOTENCY_CACHE:
                self._done.popitem(last=False)
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()
        return reply
