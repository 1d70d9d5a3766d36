"""Rank script: the distributed checkpoint at world 2 (gloo) — each rank
saves its slices of a ZeRO step (``ShardedTrainStep.sharded_state_dict``)
into one directory the JAX package's loader reads, and loads a directory
the JAX package wrote from its own 2-device ``ShardedTrainStep``."""
import os
import sys
import time

import numpy as np
import torch

from _rank import as_list, dump, start
from zero_rank import NAMES, data, make

from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                     save_state_dict)


def main(out_dir):
    rank, world = start()
    npz = np.load(os.path.join(out_dir, "params.npz"))
    params = {k: torch.from_numpy(npz[k]) for k in NAMES}
    x, y = data()
    res = {}
    # stage 3: parameters and moments sharded, each rank its extents
    s3 = make(params, 3)
    res["s3_losses"] = [float(s3((x, y))) for _ in range(3)]
    sd = s3.sharded_state_dict()
    sd["step"] = 3
    save_state_dict(sd, os.path.join(out_dir, "port_s3"))
    res["s3_local"] = {k: as_list(v) for k, v in s3.flat_params.items()}
    # stage 2, bucketed: parameters replicated (the coordinator writes
    # them once), moments sharded
    s2 = make(params, 2, bucket=True)
    for _ in range(2):
        s2((x, y))
    save_state_dict(s2.sharded_state_dict(), os.path.join(out_dir, "port_s2"))
    # a directory the JAX package wrote (the test writes it while the gang
    # runs; its commit is one rename), into a fresh stage-3 step
    jax_dir = os.path.join(out_dir, "jax_s3")
    deadline = time.monotonic() + 300
    while not os.path.exists(os.path.join(jax_dir, "manifest.json")):
        assert time.monotonic() < deadline, "no JAX checkpoint after 300 s"
        time.sleep(0.1)
    fresh = make(params, 3)
    got = fresh.sharded_state_dict()
    load_state_dict(got, jax_dir)
    res["loaded"] = {
        "params": {k: as_list(v) for k, v in fresh.flat_params.items()},
        "opt": {k: {m: as_list(t) for m, t in st.items()}
                for k, st in fresh.opt_state.items()}}
    fresh.opt._global_step = 3
    res["resumed_loss"] = float(fresh((x, y)))
    dump(out_dir, res)


if __name__ == "__main__":
    main(sys.argv[1])
