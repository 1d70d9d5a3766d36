"""The port's collectives across real processes (the counterpart of
``tests/test_launch_multiprocess.py``'s all-reduce, full-collective-set,
p2p, watcher and restart cases): one gang of two ranks on gloo, started
through the port's launcher, runs every collective and point-to-point
call, the watchdog and the per-kind counters
(``tests/torch_launch_scripts/collectives_rank.py``); each test holds its
own entry of the gang's results against the analytic value.  The watcher
and ``--max_restarts`` gangs run through the launcher's CLI, as JAX's
tests run theirs."""
import numpy as np
import pytest
import torch

from torch_gang import launch_cli, run_gang


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return run_gang("collectives_rank.py",
                    str(tmp_path_factory.mktemp("collectives")))


def test_all_reduce_sums_over_two_processes(gang):
    for r in gang:
        assert r["backend"] == "gloo" and r["world"] == 2
        assert r["all_reduce"] == [3.0, 3.0, 3.0]


# (name, rank 0's value, rank 1's value): ranks hold rank + 1 (and the
# per-collective inputs of the rank script)
EXPECTED = [
    ("all_reduce_max", [3.0, -1.0], [3.0, -1.0]),
    ("all_reduce_min", [2.0, -2.0], [2.0, -2.0]),
    ("all_reduce_prod", [6.0, 2.0], [6.0, 2.0]),
    ("all_reduce_avg", [2.5, -1.5], [2.5, -1.5]),
    ("reduce", [3.0, 3.0], None),
    ("all_gather", [[0.0, 0.0], [1.0, 10.0]], [[0.0, 0.0], [1.0, 10.0]]),
    ("all_gather_stacked", [[0.0, 0.0], [1.0, 10.0]],
     [[0.0, 0.0], [1.0, 10.0]]),
    ("all_gather_object", [{"rank": 0, "tag": "r0"}, {"rank": 1, "tag": "r1"}],
     [{"rank": 0, "tag": "r0"}, {"rank": 1, "tag": "r1"}]),
    ("broadcast", [7.0, 7.0], [7.0, 7.0]),
    ("scatter", [1.0, 2.0], [3.0, 4.0]),
    ("reduce_scatter", [3.0, 6.0], [9.0, 12.0]),
    ("reduce_scatter_stacked", [1.0, 3.0], [5.0, 7.0]),
    ("all_to_all", [[0.0], [10.0]], [[1.0], [11.0]]),
    ("all_to_all_single", [0.0, 1.0, 100.0, 101.0],
     [2.0, 3.0, 102.0, 103.0]),
    ("gather", [[0.5], [1.5]], None),
    ("new_group", [3.0], [3.0]),
]


@pytest.mark.parametrize("name,want0,want1", EXPECTED,
                         ids=[e[0] for e in EXPECTED])
def test_collective_set(gang, name, want0, want1):
    assert gang[0][name] == want0
    assert gang[1][name] == want1


@pytest.mark.parametrize("name,want0,want1", [
    ("send_recv", [9.0, 8.0], [1.0, 2.0, 3.0]),
    ("isend_irecv", [1.25, 1.75], [0.25, 0.75]),
    ("batch_isend_irecv", [101.0], [100.0]),
], ids=["send_recv", "isend_irecv", "batch_isend_irecv"])
def test_point_to_point(gang, name, want0, want1):
    assert gang[0][name] == want0
    assert gang[1][name] == want1


def test_counters_count_every_collective_by_kind(gang):
    want = {"all_reduce": 7, "reduce": 1, "all_gather": 2, "broadcast": 1,
            "scatter": 1, "reduce_scatter": 2, "all_to_all": 2, "gather": 1}
    for r in gang:
        assert r["counts"] == want
        assert r["p2p_counts"] == {"send": 3, "recv": 3}


def test_mesh_axis_is_a_named_group(gang):
    for rank, r in enumerate(gang):
        assert r["mesh_group"] == {"ranks": [0, 1], "axis": "dp",
                                   "rank": rank, "sum": [3.0],
                                   "dims": ["dp"]}


def test_watchdog_tracks_and_times_out_a_dead_peer(gang):
    """A tracked async all-reduce lands; a receive from a peer that never
    sends raises CommTimeoutError at its 1 s deadline instead of
    hanging."""
    for r in gang:
        assert r["tracked"] == [1.0] * 4
    assert gang[0]["timeout"] == "CommTimeoutError"
    assert 1.0 <= gang[0]["timeout_s"] < 5.0


def test_comm_ready_fault_point_raises_timeout():
    from paddle_tpu_torch.distributed.communication import watchdog
    from paddle_tpu_torch.resilience import inject
    with inject({"comm.ready": dict(action="trigger")}):
        with pytest.raises(watchdog.CommTimeoutError, match="injected"):
            watchdog.wait_with_timeout(torch.zeros(1), 5.0, "all_reduce")
    assert watchdog.wait_with_timeout(torch.ones(1), 5.0).item() == 1.0


def test_one_participant_is_the_identity():
    """Before init_parallel_env every collective is the identity, as JAX's
    single-participant path, and none is counted."""
    import paddle_tpu_torch.distributed as dist
    assert not dist.is_initialized() and dist.get_world_size() == 1
    dist.reset_collective_counts()
    t = torch.tensor([1.0, 2.0])
    dist.all_reduce(t)
    got = []
    dist.all_gather(got, t)
    assert t.tolist() == [1.0, 2.0] and len(got) == 1
    assert dist.collective_counts() == {}
    with pytest.raises(RuntimeError, match="peer"):
        dist.send(t, dst=1)


def test_watcher_kills_gang_on_failure(tmp_path):
    script = tmp_path / "failing_rank.py"
    script.write_text(
        "import os, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if rank == 1:\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")  # rank 0 hangs; the watcher must kill it
    proc = launch_cli(script, timeout=120)
    assert proc.returncode == 3, proc.stdout


def test_max_restarts_recovers(tmp_path):
    script = tmp_path / "flaky_rank.py"
    script.write_text(
        "import os, sys\n"
        f"base = {repr(str(tmp_path))}\n"
        "m = os.path.join(base, 'attempt')\n"
        "rank = int(os.environ['RANK'])\n"
        "if rank == 0 and not os.path.exists(m):\n"
        "    open(m, 'w').write('1'); sys.exit(1)\n"
        "open(os.path.join(base, f'done.{rank}'), 'w').write('ok')\n")
    proc = launch_cli(script, extra=["--max_restarts=1"], timeout=120,
                      log_dir=str(tmp_path / "logs"))
    assert proc.returncode == 0, proc.stdout
    assert (tmp_path / "done.0").exists() and (tmp_path / "done.1").exists()
    assert np.all([(tmp_path / "logs" / f"workerlog.{r}").exists()
                   for r in (0, 1)])
