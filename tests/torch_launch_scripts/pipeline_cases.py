"""What the pipeline gang (``pipeline_rank.py``) and its test share: the
cases, the step count and learning rate, and the data of the ``Linear``
pipeline layer.  numpy only, so the test process imports it as it is."""
import numpy as np

STEPS = 3
LR = 1e-2
# the tiny LLaMA of JAX's pipeline tests
TINY = dict(vocab=64, hidden=32, layers=4, heads=4, seq=16)
B, S = 8, 16
# name: (mesh axes, n_micro, schedule, n_chunks, tensor-parallel blocks)
CASES = {
    "pp4_1f1b_m4": ({"pp": 4}, 4, "1f1b", 1, False),
    "pp4_1f1b_m8": ({"pp": 4}, 8, "1f1b", 1, False),
    "pp4_zb_m8": ({"pp": 4}, 8, "zero_bubble", 1, False),
    "pp2dp2_1f1b": ({"dp": 2, "pp": 2}, 4, "1f1b", 1, False),
    "pp2dp2_zb": ({"dp": 2, "pp": 2}, 4, "zero_bubble", 1, False),
    "pp2dp2_vpp": ({"dp": 2, "pp": 2}, 4, "1f1b", 2, False),
    "pp2mp2_1f1b": ({"pp": 2, "mp": 2}, 4, "1f1b", 1, True),
    "pp2mp2_vpp": ({"pp": 2, "mp": 2}, 4, "1f1b", 2, True),
    "pp4_gpipe": ({"pp": 4}, 4, "gpipe", 1, False),
}
# PipelineParallel over four Linear(16, 16) at pp 2 x dp 2, and the pp 4
# layer whose stage widths change (the fallback)
PP_WIDTHS = [16] * 5
PP_STEPS = 4
FALLBACK_WIDTHS = [16, 16, 8, 8, 4]
FALLBACK_STEPS = 2


def linear_data():
    """Four (weight [16, 16], bias [16]) pairs, x [8, 16], y [8, 16]."""
    rng = np.random.default_rng(11)
    ws = [(rng.normal(0, 0.3, (16, 16)).astype(np.float32),
           rng.normal(0, 0.1, (16,)).astype(np.float32)) for _ in range(4)]
    x = rng.normal(size=(8, 16)).astype(np.float32)
    y = rng.normal(size=(8, 16)).astype(np.float32)
    return ws, x, y


def batch():
    """The LLaMA batch: ids and labels [B, S]."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY["vocab"], (B, S)).astype(np.int32)
    labels = rng.integers(0, TINY["vocab"], (B, S)).astype(np.int32)
    return ids, labels
