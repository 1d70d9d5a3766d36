"""Small distributed helpers (port of ``paddle_tpu/distributed/utils.py``)."""
from __future__ import annotations

import os

__all__ = ["get_local_rank", "get_node_count"]


def get_local_rank():
    return int(os.environ.get("PADDLE_LOCAL_RANK",
                              os.environ.get("LOCAL_RANK", 0)))


def get_node_count():
    return max(int(os.environ.get("PADDLE_NNODES", 1)), 1)
