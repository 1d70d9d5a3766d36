"""Rank script: the collective set, point-to-point, the watchdog and the
counters across two real processes (gloo).  Each check records what this
rank received; the test holds it against the analytic value."""
import os
import sys
import time

import torch

from _rank import as_list, dist, dump, start

from paddle_tpu_torch.distributed.communication import watchdog
from paddle_tpu_torch.distributed.communication.collectives import \
    COLLECTIVE_COUNTS


def main(out_dir):
    rank, world = start()
    assert world == 2, world
    peer = 1 - rank
    res = {"backend": dist.get_backend(), "world": world, "rank": rank}
    dist.reset_collective_counts()

    t = torch.full((3,), float(rank + 1))
    dist.all_reduce(t)
    res["all_reduce"] = as_list(t)
    for name, op in (("max", dist.ReduceOp.MAX), ("min", dist.ReduceOp.MIN),
                     ("prod", dist.ReduceOp.PROD),
                     ("avg", dist.ReduceOp.AVG)):
        t = torch.tensor([rank + 2.0, -rank - 1.0])
        dist.all_reduce(t, op=op)
        res[f"all_reduce_{name}"] = as_list(t)
    t = torch.full((2,), float(rank + 1))
    dist.reduce(t, dst=0)
    res["reduce"] = as_list(t) if rank == 0 else None
    got = []
    stacked = dist.all_gather(got, torch.tensor([rank, 10.0 * rank]))
    res["all_gather"] = [as_list(x) for x in got]
    res["all_gather_stacked"] = as_list(stacked)
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "tag": f"r{rank}"})
    res["all_gather_object"] = objs
    t = torch.full((2,), 7.0) if rank == 1 else torch.zeros(2)
    dist.broadcast(t, src=1)
    res["broadcast"] = as_list(t)
    t = torch.zeros(2)
    dist.scatter(t, [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])]
                 if rank == 0 else None, src=0)
    res["scatter"] = as_list(t)
    t = torch.zeros(2)
    dist.reduce_scatter(t, [torch.tensor([1.0, 2.0]) * (rank + 1),
                            torch.tensor([3.0, 4.0]) * (rank + 1)])
    res["reduce_scatter"] = as_list(t)
    t = torch.zeros(2)
    dist.reduce_scatter(t, torch.arange(4.0).reshape(2, 2) + rank)
    res["reduce_scatter_stacked"] = as_list(t)
    out = []
    dist.all_to_all(out, [torch.tensor([10.0 * rank + 0]),
                          torch.tensor([10.0 * rank + 1])])
    res["all_to_all"] = [as_list(x) for x in out]
    o = torch.zeros(4)
    dist.all_to_all_single(o, torch.arange(4.0) + 100 * rank)
    res["all_to_all_single"] = as_list(o)
    lst = []
    dist.gather(torch.tensor([rank + 0.5]), lst, dst=0)
    res["gather"] = [as_list(x) for x in lst] if rank == 0 else None
    # the groups a mesh cuts, and an explicit one
    from paddle_tpu_torch.distributed import topology
    mesh = topology.build_mesh({"dp": 2})
    g = topology.axis_group("dp", mesh)
    t = torch.ones(1) * (rank + 1)
    dist.all_reduce(t, group=g)
    res["mesh_group"] = {"ranks": g.ranks, "axis": g.axis_name,
                         "rank": g.rank, "sum": as_list(t),
                         "dims": list(mesh.mesh_dim_names)}
    g2 = dist.new_group([0, 1])
    t = torch.ones(1) * (rank + 1)
    dist.all_reduce(t, group=g2)
    res["new_group"] = as_list(t)
    res["counts"] = dict(COLLECTIVE_COUNTS)

    # point-to-point
    dist.reset_collective_counts()
    if rank == 0:
        dist.send(torch.tensor([1.0, 2.0, 3.0]), dst=1)
        r = torch.zeros(2)
        dist.recv(r, src=1)
    else:
        r = torch.zeros(3)
        dist.recv(r, src=0)
        dist.send(torch.tensor([9.0, 8.0]), dst=0)
    res["send_recv"] = as_list(r)
    buf = torch.zeros(2)
    tasks = [dist.isend(torch.tensor([rank + 0.25, rank + 0.75]), dst=peer),
             dist.irecv(buf, src=peer)]
    for task in tasks:
        task.wait()
    res["isend_irecv"] = as_list(buf)
    buf = torch.zeros(1)
    ops = [dist.P2POp(dist.isend, torch.tensor([100.0 + rank]), peer),
           dist.P2POp(dist.irecv, buf, peer)]
    for task in dist.batch_isend_irecv(ops):
        task.wait()
    res["batch_isend_irecv"] = as_list(buf)
    res["p2p_counts"] = dict(COLLECTIVE_COUNTS)

    # the watchdog: tracked async collectives land and are scanned; a
    # receive from a peer that never sends times out at the deadline
    mgr = watchdog.CommTaskManager(default_timeout=30.0)
    t = torch.ones(4) * rank
    mgr.track("all_reduce", dist.all_reduce(t, sync_op=False), t)
    mgr.wait_all()
    res["tracked"] = as_list(t)
    # ReduceOp.AVG with sync_op=False: the mean lands when the task is
    # waited on (directly, or through the watchdog's manager)
    t = torch.tensor([rank + 2.0, -rank - 1.0])
    dist.all_reduce(t, op=dist.ReduceOp.AVG, sync_op=False).wait()
    res["async_avg_all_reduce"] = as_list(t)
    t = torch.tensor([rank + 2.0, -rank - 1.0])
    mgr.track("all_reduce", dist.all_reduce(t, op=dist.ReduceOp.AVG,
                                            sync_op=False), t)
    mgr.wait_all()
    res["async_avg_tracked"] = as_list(t)
    t = torch.tensor([rank + 2.0, -rank - 1.0])
    task = dist.reduce(t, dst=0, op=dist.ReduceOp.AVG, sync_op=False)
    task.wait()
    res["async_avg_reduce"] = as_list(t) if rank == 0 else None
    t = torch.zeros(2)
    dist.reduce_scatter(t, torch.arange(4.0).reshape(2, 2) + rank,
                        op=dist.ReduceOp.AVG, sync_op=False).wait()
    res["async_avg_reduce_scatter"] = as_list(t)
    t = torch.zeros(2)
    dist.reduce_scatter(t, torch.arange(4.0).reshape(2, 2) + rank,
                        op=dist.ReduceOp.AVG)
    res["sync_avg_reduce_scatter"] = as_list(t)
    # last (a timed-out gloo pair is not used again): rank 0 waits on a
    # receive rank 1 never sends; rank 1 stays alive past the deadline
    if rank == 0:
        task = dist.irecv(torch.zeros(1), src=1)
        t0 = time.monotonic()
        try:
            task.wait(timeout=1.0)
            res["timeout"] = "no timeout"
        except watchdog.CommTimeoutError as e:
            res["timeout"] = type(e).__name__
        except RuntimeError as e:           # e.g. the peer left first
            res["timeout"] = f"{type(e).__name__}: {e}"
        res["timeout_s"] = time.monotonic() - t0
    else:
        time.sleep(5.0)     # alive well past rank 0's deadline
    dump(out_dir, res, finish=False)
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
