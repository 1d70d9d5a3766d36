"""What every rank script shares: join the gang on the CPU (gloo), one
thread a rank, and write this rank's results as ``out_dir/rank{r}.json``."""
import json
import os

import torch

torch.set_num_threads(1)

import paddle_tpu_torch.distributed as dist  # noqa: E402


def start():
    dist.init_parallel_env(device="cpu")
    return dist.get_rank(), dist.get_world_size()


def as_list(t):
    return t.detach().cpu().double().numpy().tolist()


def dump(out_dir, results, finish=True):
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(results, f)
    if finish:
        dist.barrier()
        dist.destroy_process_group()
