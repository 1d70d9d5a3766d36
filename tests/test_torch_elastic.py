"""Port parity: paddle_tpu_torch.distributed.fleet.elastic, the elastic
membership manager the cross-process serving fleet keeps its roster with,
under the JAX suite's store and manager drills (tests/test_elastic.py).
Each drill runs on both packages' stores and managers and must see the
same memberships, statuses and rank maps.  The launcher's elastic drills
wait for the port's launcher."""
import time

from paddle_tpu.distributed.fleet import elastic as jelastic
from paddle_tpu_torch.distributed.fleet import elastic as telastic


def _both(drill, *args):
    """The drill's observations on the port, which must equal JAX's."""
    got = drill(telastic, *args)
    assert got == drill(jelastic, *args)
    return got


def test_memory_store_membership_and_expiry():
    def drill(m):
        st = m.MemoryStore()
        st.heartbeat("a:1")
        st.heartbeat("b:2")
        seen = [st.alive(10.0)]
        st.heartbeat("a:1", ts=time.time() - 100)   # stale lease
        return seen + [st.alive(10.0)]
    assert _both(drill) == [["a:1", "b:2"], ["b:2"]]


def test_file_store_cross_process_semantics(tmp_path):
    def drill(m, root):
        st1 = m.FileStore(root)
        st2 = m.FileStore(root)                     # "another host"
        st1.heartbeat("h1:7000")
        st2.heartbeat("h2:7000")
        seen = [st1.alive(10.0)]
        st2.heartbeat("h2:7000", ts=time.time() - 60)   # lease expired
        seen.append(st1.alive(10.0))
        st1.remove("h1:7000")
        return seen + [st1.alive(10.0)]
    assert drill(telastic, str(tmp_path / "t")) \
        == drill(jelastic, str(tmp_path / "j")) \
        == [["h1:7000", "h2:7000"], ["h1:7000"], []]
    # one store directory read by both packages: the same lease files
    root = str(tmp_path / "shared")
    telastic.FileStore(root).heartbeat("t:1")
    jelastic.FileStore(root).heartbeat("j:1")
    assert telastic.FileStore(root).alive(10.0) \
        == jelastic.FileStore(root).alive(10.0) == ["t:1", "j:1"]


def test_manager_change_on_join_and_leave():
    def drill(m):
        S = m.ElasticStatus
        st = m.MemoryStore()
        mgr = m.ElasticManager(st, np_min=1, np_max=4, heartbeat_timeout=10.0)
        mgr.register("n0:1")
        mgr.register("n1:1")
        seen = [mgr.watch() == S.HOLD,              # first observation
                mgr.watch() == S.HOLD]              # stable
        events = []
        mgr.on_change(lambda rm: events.append(rm))
        mgr.register("n2:1")                        # scale out
        seen += [mgr.watch() == S.CHANGE, dict(events[-1])]
        st.remove("n2:1")                           # scale in
        seen += [mgr.watch() == S.CHANGE, dict(events[-1]), mgr.endpoints()]
        return seen
    assert _both(drill) == [True, True, True,
                            {"n0:1": 0, "n1:1": 1, "n2:1": 2}, True,
                            {"n0:1": 0, "n1:1": 1}, "n0:1,n1:1"]


def test_manager_grace_period_then_exit():
    def drill(m):
        st = m.MemoryStore()
        mgr = m.ElasticManager(st, np_min=2, np_max=4, heartbeat_timeout=10.0,
                               grace_period=0.2)
        mgr.register("n0:1")
        mgr.register("n1:1")
        seen = [mgr.watch().value]
        st.remove("n1:1")                           # below np_min
        seen.append(mgr.watch().value)              # grace clock running
        time.sleep(0.3)
        return seen + [mgr.watch().value]
    assert _both(drill) == ["hold", "hold", "exit"]


def test_manager_caps_members_at_np_max():
    def drill(m):
        mgr = m.ElasticManager(m.MemoryStore(), np_min=1, np_max=2)
        for i in range(4):
            mgr.register(f"n{i}:1")
        return mgr.members(), mgr.rank_map()
    assert _both(drill) == (["n0:1", "n1:1"], {"n0:1": 0, "n1:1": 1})


def test_manager_change_fires_after_full_replacement():
    """Members fully replaced after a transient empty window must still
    produce CHANGE (an empty previous roster is not a first observation)."""
    def drill(m):
        st = m.MemoryStore()
        mgr = m.ElasticManager(st, np_min=2, np_max=4, heartbeat_timeout=10.0,
                               grace_period=60.0)
        mgr.register("a:1")
        mgr.register("b:1")
        seen = [mgr.watch().value]
        st.remove("a:1")
        st.remove("b:1")
        seen.append(mgr.watch().value)              # grace running
        mgr.register("c:1")
        mgr.register("d:1")
        return seen + [mgr.watch().value, mgr.rank_map()]
    assert _both(drill) == ["hold", "hold", "change", {"c:1": 0, "d:1": 1}]


def test_joiner_does_not_evict_active_member_at_capacity():
    def drill(m):
        mgr = m.ElasticManager(m.MemoryStore(), np_min=1, np_max=2,
                               heartbeat_timeout=10.0)
        mgr.register("b:1")
        mgr.register("c:1")
        seen = [mgr.watch().value]
        mgr.register("a:1")                         # lexicographically first
        return seen + [mgr.watch().value, mgr.members()]
    assert _both(drill) == ["hold", "hold", ["b:1", "c:1"]]


def test_returning_host_after_lapse_is_a_joiner():
    """A host whose lease lapsed must not reclaim seniority and evict the
    junior that replaced it."""
    def drill(m):
        st = m.MemoryStore()
        mgr = m.ElasticManager(st, np_min=1, np_max=2, heartbeat_timeout=10.0)
        st.heartbeat("a:1", ts=time.time() - 100, stale_after=10.0)
        mgr.register("b:1")
        mgr.register("c:1")                         # a already stale
        seen = [mgr.watch().value, mgr.members()]
        mgr.heartbeat("a:1")                        # a returns, as a joiner
        return seen + [mgr.members()]
    assert _both(drill) == ["hold", ["b:1", "c:1"], ["b:1", "c:1"]]
