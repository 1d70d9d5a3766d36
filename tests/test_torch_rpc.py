"""Port parity: paddle_tpu_torch.serving.rpc, the loopback RPC of the
cross-process fleet, under the JAX suite's wire drills (tests/test_rpc.py,
run here on the port's client and server), and across packages: the JAX
package's RpcClient against the port's RpcServer and the reverse, so that
the frames on the wire are shown to be the same.

The drills: the client survives dropped, delayed and truncated frames and
half-open sockets through deadline-per-call timeouts, exponential backoff
and idempotent retry keys, with NO double-invoked handler, and torn frames
never reach the handler.  Pure host-side sockets."""
import threading
import time

import pytest

from paddle_tpu.serving import rpc as jrpc
from paddle_tpu_torch.resilience import inject
from paddle_tpu_torch.serving.rpc import (RpcClient, RpcRemoteError,
                                          RpcServer, RpcTimeout)


class _Backend:
    """Counts handler invocations per method — the double-submit meter."""

    def __init__(self, delay_s: float = 0.0):
        self.calls: dict[str, int] = {}
        self.delay_s = delay_s
        self.lock = threading.Lock()

    def __call__(self, method, params):
        with self.lock:
            self.calls[method] = self.calls.get(method, 0) + 1
        if self.delay_s:
            time.sleep(self.delay_s)
        if method == "boom":
            raise ValueError("injected remote failure")
        return {"method": method, "params": params,
                "n": self.calls[method]}


@pytest.fixture()
def server():
    backend = _Backend()
    srv = RpcServer(backend).start()
    yield srv, backend
    srv.stop()


def _eventually(pred, timeout=10.0):
    """``pred()`` turned true within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _client(srv, **kw):
    kw.setdefault("attempt_timeout", 0.25)
    kw.setdefault("backoff_base", 0.005)
    kw.setdefault("backoff_cap", 0.05)
    return RpcClient(srv.address, **kw)


class TestBasics:
    def test_round_trip(self, server):
        srv, backend = server
        c = _client(srv)
        r = c.call("submit", prompt=[1, 2, 3], max_new_tokens=4)
        assert r["params"]["prompt"] == [1, 2, 3]
        assert backend.calls["submit"] == 1
        c.close()

    def test_many_calls_one_connection(self, server):
        srv, backend = server
        c = _client(srv)
        for i in range(20):
            assert c.call("poll", i=i)["params"]["i"] == i
        assert backend.calls["poll"] == 20
        # persistent socket: exactly one connect
        assert c.stats["reconnects"] == 1
        c.close()

    def test_remote_error_maps_to_typed_exception(self, server):
        srv, _ = server
        c = _client(srv)
        with pytest.raises(RpcRemoteError) as ei:
            c.call("boom")
        assert ei.value.etype == "ValueError"
        c.close()

    def test_deadline_timeout(self):
        backend = _Backend(delay_s=5.0)       # slower than any deadline here
        srv = RpcServer(backend).start()
        try:
            c = _client(srv)
            t0 = time.monotonic()
            with pytest.raises(RpcTimeout):
                c.call("submit", deadline_s=0.4)
            assert time.monotonic() - t0 < 3.0
            assert c.stats["timeouts"] == 1
            c.close()
        finally:
            srv.stop()


class TestWireFaults:
    def test_dropped_frame_burns_timeout_then_retries(self, server):
        srv, backend = server
        c = _client(srv)
        with inject({"rpc.drop_frame": dict(action="trigger", count=1,
                                            match={"method": "submit"})}
                    ) as plan:
            t0 = time.monotonic()
            r = c.call("submit", x=1, deadline_s=5.0)
        assert plan.fired("rpc.drop_frame") == 1
        # the lost frame burned (at least) one attempt timeout waiting
        assert time.monotonic() - t0 >= 0.2
        assert r["n"] == 1 and backend.calls["submit"] == 1
        assert c.stats["retries"] >= 1
        assert c.stats["backoff_s"] > 0.0
        c.close()

    def test_delayed_frame_still_delivers(self, server):
        srv, backend = server
        c = _client(srv, fault_delay_s=0.15)
        with inject({"rpc.delay_frame": dict(action="trigger", count=1)}):
            t0 = time.monotonic()
            r = c.call("submit", x=2, deadline_s=5.0)
        assert time.monotonic() - t0 >= 0.15
        assert r["n"] == 1 and backend.calls["submit"] == 1
        c.close()

    def test_truncated_frame_never_reaches_handler(self, server):
        srv, backend = server
        c = _client(srv)
        with inject({"rpc.truncate_frame": dict(action="trigger", count=1,
                                                match={"method": "submit"})}
                    ) as plan:
            r = c.call("submit", x=3, deadline_s=5.0)
        assert plan.fired("rpc.truncate_frame") == 1
        # the torn frame was dropped by the server WITHOUT dispatch; only
        # the retry invoked the handler
        assert backend.calls["submit"] == 1 and r["n"] == 1
        # the torn connection's own thread counts it when it reads the
        # close, which may come after the retry's reply on a busy host
        assert _eventually(lambda: srv.stats["torn_frames"] >= 1)
        c.close()

    def test_half_open_socket_hits_idempotency_cache(self, server):
        """The no-double-submit drill: the request frame is fully
        delivered, the reply is lost — the retry (same key) must be
        served from the reply cache without re-invoking the handler."""
        srv, backend = server
        c = _client(srv)
        with inject({"rpc.half_open": dict(action="trigger", count=1,
                                           match={"method": "submit"})}
                    ) as plan:
            r = c.call("submit", x=4, deadline_s=5.0)
        assert plan.fired("rpc.half_open") == 1
        assert backend.calls["submit"] == 1, "handler ran twice: double-submit"
        assert r["n"] == 1
        assert srv.stats["dup_hits"] >= 1
        assert srv.stats["handler_invocations"] == 1
        c.close()

    def test_fault_storm_no_double_dispatch(self, server):
        """Several faults across a burst of calls: every call lands
        exactly once server-side despite the chaos."""
        srv, backend = server
        c = _client(srv)
        with inject({"rpc.half_open": dict(action="trigger", count=2),
                     "rpc.truncate_frame": dict(action="trigger", at=5)},
                    seed=3):
            for i in range(12):
                assert c.call("submit", i=i, deadline_s=10.0) is not None
        assert backend.calls["submit"] == 12
        c.close()


class TestIdempotencyCache:
    def test_duplicate_key_returns_cached_reply(self, server):
        srv, backend = server
        c = _client(srv)
        r1 = c.call("submit", x=1)
        # forge a duplicate of the LAST frame by replaying the same key
        from paddle_tpu_torch.serving.rpc import _recv_frame, _send_frame
        import socket as _socket
        s = _socket.create_connection(srv.address)
        key = f"{c._cid}:0"
        _send_frame(s, {"m": "submit", "k": key, "p": {"x": 1}})
        s.settimeout(2.0)
        dup = _recv_frame(s)
        s.close()
        assert dup["ok"] and dup["r"] == r1
        assert backend.calls["submit"] == 1
        c.close()

    def test_cache_is_bounded(self, server):
        srv, backend = server
        old = RpcServer.IDEMPOTENCY_CACHE
        RpcServer.IDEMPOTENCY_CACHE = 8
        try:
            c = _client(srv)
            for i in range(40):
                c.call("poll", i=i)
            assert len(srv._done) <= 8
            c.close()
        finally:
            RpcServer.IDEMPOTENCY_CACHE = old

    def test_error_replies_are_idempotent_too(self, server):
        """A failed call retried on the same key fails the same way
        without re-running the handler."""
        srv, backend = server
        c = _client(srv)
        with inject({"rpc.half_open": dict(action="trigger", at=0,
                                           match={"method": "boom"})}):
            with pytest.raises(RpcRemoteError):
                c.call("boom", deadline_s=5.0)
        assert backend.calls["boom"] == 1
        c.close()


class TestAcrossPackages:
    """The same frames both ways: a client of one package drives a server
    of the other through a round trip, a remote error and the
    idempotency cache (a retry after a half-open socket, its fault
    consulted in the client's own package)."""

    def test_jax_client_against_port_server(self):
        backend = _Backend()
        srv = RpcServer(backend).start()
        try:
            from paddle_tpu.resilience import inject as jinject
            c = jrpc.RpcClient(srv.address, attempt_timeout=0.25,
                               backoff_base=0.005, backoff_cap=0.05)
            r = c.call("submit", prompt=[1, 2, 3], max_new_tokens=4)
            assert r["params"] == {"prompt": [1, 2, 3], "max_new_tokens": 4}
            with pytest.raises(jrpc.RpcRemoteError) as ei:
                c.call("boom")
            assert ei.value.etype == "ValueError"
            with jinject({"rpc.half_open": dict(action="trigger", count=1,
                                                match={"method": "poll"})}
                         ) as plan:
                assert c.call("poll", i=7, deadline_s=5.0)["n"] == 1
            assert plan.fired("rpc.half_open") == 1
            assert backend.calls == {"submit": 1, "boom": 1, "poll": 1}
            assert srv.stats["dup_hits"] >= 1
            c.close()
        finally:
            srv.stop()

    def test_port_client_against_jax_server(self):
        backend = _Backend()
        srv = jrpc.RpcServer(backend).start()
        try:
            c = _client(srv)
            r = c.call("submit", prompt=[4, 5], max_new_tokens=2)
            assert r["params"] == {"prompt": [4, 5], "max_new_tokens": 2}
            with pytest.raises(RpcRemoteError) as ei:
                c.call("boom")
            assert ei.value.etype == "ValueError"
            with inject({"rpc.half_open": dict(action="trigger", count=1,
                                               match={"method": "poll"})}
                        ) as plan:
                assert c.call("poll", i=7, deadline_s=5.0)["n"] == 1
            assert plan.fired("rpc.half_open") == 1
            assert backend.calls == {"submit": 1, "boom": 1, "poll": 1}
            assert srv.stats["dup_hits"] >= 1
            c.close()
        finally:
            srv.stop()
