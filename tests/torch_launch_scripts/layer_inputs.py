"""The fixed inputs of the tensor-parallel layer checks, shared by the
rank script and the test (numpy only)."""
import numpy as np


def inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    labels = rng.integers(0, 10, (4,)).astype(np.int64)
    labels[2] = -100                                  # an ignored row
    return {"x8": f(3, 8), "wc": f(8, 6), "bc": f(6), "dy6": f(3, 6),
            "x6": f(3, 6), "wr": f(6, 4), "br": f(4), "dy4": f(3, 4),
            "emb": f(10, 4),
            "ids": rng.integers(0, 10, (3, 5)).astype(np.int64),
            "dye": f(3, 5, 4), "logits": f(4, 10), "labels": labels}
