"""The launch CLI (port of ``paddle_tpu/distributed/launch/main.py``;
reference python/paddle/distributed/launch/main.py:23,
controllers/collective.py:22 CollectiveController, controllers/watcher.py):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \
        train.py [args...]

spawns one process per rank with the PADDLE_* environment contract the
reference's controller exports (collective.py:76, 139), which
:func:`paddle_tpu_torch.distributed.init_parallel_env` reads (and which
:class:`paddle_tpu_torch.serving.ProcessFleet` spawns its workers with):

    PADDLE_MASTER            coordinator host:port
    PADDLE_TRAINER_ID        global rank
    PADDLE_TRAINERS_NUM      world size
    PADDLE_TRAINER_ENDPOINTS comma list of all rank endpoints
    PADDLE_LOCAL_RANK        rank on this node
    PADDLE_NNODES / PADDLE_NODE_RANK

plus the torch-style aliases (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) that ``torch.distributed.init_process_group`` reads with
``init_method="env://"``.

The watcher polls the ranks: when one exits non-zero the rest are
terminated and the gang's code is the failed rank's (reference
controller.py:35).  ``--max_restarts N`` relaunches the whole gang on a
fresh rendezvous port up to N times.  ``--log_dir`` sends rank r's output
to ``workerlog.r`` there.  The elastic loop (``--np``, ``--elastic_store``)
is not ported yet.  NCCL takes one rank per card: on a host with one card
``--nproc_per_node`` is 1 there, and gangs of more ranks run on the CPU
(``device="cpu"``, gloo).
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["main", "launch_gang", "_free_port", "_rank_env"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_env(base_env, *, rank, local_rank, world, master, endpoints,
              nnodes, node_rank, devices=None):
    env = dict(base_env)
    env.update({
        "PADDLE_MASTER": master,
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoints,
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_NNODES": str(nnodes),
        "PADDLE_NODE_RANK": str(node_rank),
        "PADDLE_RANK_IN_NODE": str(local_rank),
        # torch-style aliases many scripts read
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local_rank),
        "MASTER_ADDR": master.split(":")[0],
        "MASTER_PORT": master.split(":")[1],
    })
    if devices is not None:
        dev = devices[local_rank % len(devices)]
        env["PADDLE_SELECTED_DEVICES"] = dev
        # pin the rank to its card (the reference launch exports
        # CUDA_VISIBLE_DEVICES)
        env["CUDA_VISIBLE_DEVICES"] = dev
    return env


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="paddle_tpu_torch distributed launcher",
        allow_abbrev=False)
    p.add_argument("--nproc_per_node", type=int, default=None)
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", type=str, default=None,
                   help="host:port of the rendezvous (default: a free local "
                        "port; required multi-node)")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=0,
                   help="relaunch the gang up to N times on failure")
    p.add_argument("--devices", type=str, default=None,
                   help="comma list of card ids to pin per local rank")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch_gang(cmd, *, nproc, master=None, nnodes=1, node_rank=0,
                env=None, log_dir=None, max_restarts=0, devices=None,
                poll_interval=0.1):
    """Spawn and watch a gang of ``nproc`` rank processes running ``cmd``
    (the per-rank argv).  Returns 0, or the failed rank's exit code."""
    base_env = dict(os.environ if env is None else env)
    if master is None:
        master = f"127.0.0.1:{_free_port()}"
    world = nproc * nnodes
    rank0 = node_rank * nproc
    host = master.split(":")[0]
    endpoints = ",".join(f"{host}:{_free_port()}" for _ in range(world))
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    attempts = 0
    while True:
        procs, logs = [], []
        for lr in range(nproc):
            rank = rank0 + lr
            renv = _rank_env(base_env, rank=rank, local_rank=lr, world=world,
                             master=master, endpoints=endpoints,
                             nnodes=nnodes, node_rank=node_rank,
                             devices=devices)
            out = None
            if log_dir:
                out = open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
                logs.append(out)
            procs.append(subprocess.Popen(
                cmd, env=renv, stdout=out,
                stderr=subprocess.STDOUT if out else None))

        def _terminate_all(sig=signal.SIGTERM):
            for pr in procs:
                if pr.poll() is None:
                    try:
                        pr.send_signal(sig)
                    except OSError:
                        pass

        def _stop_gang():
            _terminate_all()
            deadline = time.time() + 10
            for pr in procs:
                try:
                    pr.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    pr.kill()
                    pr.wait()

        prev = {}
        for s in (signal.SIGINT, signal.SIGTERM):
            try:
                prev[s] = signal.signal(
                    s, lambda *_: (_stop_gang(), sys.exit(1)))
            except ValueError:
                pass                      # not the main thread
        try:
            while True:
                codes = [pr.poll() for pr in procs]
                failed = [c for c in codes if c not in (None, 0)]
                if failed:
                    _stop_gang()
                    rc = max(max(failed), 1)
                    break
                if all(c == 0 for c in codes):
                    rc = 0
                    break
                time.sleep(poll_interval)
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
            for lf in logs:
                lf.close()
        if rc == 0 or attempts >= max_restarts:
            return rc
        attempts += 1
        master = f"{host}:{_free_port()}"
        print(f"[launch] gang failed rc={rc}; restart {attempts}/"
              f"{max_restarts}", file=sys.stderr)


def main(argv=None):
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    script_args = list(args.script_args)
    if script_args and script_args[0] == "--":
        script_args = script_args[1:]
    cmd = [sys.executable, "-u", args.script] + script_args
    nproc = args.nproc_per_node if args.nproc_per_node is not None else \
        int(os.environ.get("PADDLE_NPROC_PER_NODE", 1))
    rc = launch_gang(cmd, nproc=nproc, master=args.master,
                     nnodes=args.nnodes, node_rank=args.node_rank,
                     log_dir=args.log_dir, max_restarts=args.max_restarts,
                     devices=args.devices.split(",") if args.devices
                     else None)
    sys.exit(rc)
