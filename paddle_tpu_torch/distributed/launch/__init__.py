"""The launch CLI of the port (reference:
python/paddle/distributed/launch/): ``python -m
paddle_tpu_torch.distributed.launch``."""
from .main import _free_port, _rank_env, launch_gang, main

__all__ = ["main", "launch_gang", "_free_port", "_rank_env"]
