"""The launcher's port assignment and its PADDLE_* environment contract
(reference: python/paddle/distributed/launch/controllers/collective.py:76,
139), the pieces :class:`paddle_tpu_torch.serving.ProcessFleet` spawns its
workers with:

    PADDLE_MASTER            coordinator host:port
    PADDLE_TRAINER_ID        global rank
    PADDLE_TRAINERS_NUM      world size
    PADDLE_TRAINER_ENDPOINTS comma list of all rank endpoints
    PADDLE_LOCAL_RANK        rank on this node
    PADDLE_NNODES / PADDLE_NODE_RANK

plus the torch-style aliases (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) that ``torch.distributed.init_process_group`` reads with
``init_method="env://"``.
"""
from __future__ import annotations

import socket

__all__ = ["_free_port", "_rank_env"]


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
