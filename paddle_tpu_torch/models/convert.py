"""Weight conversion from the JAX package's parameter layout."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def params_from_numpy(ep, bp, hp, device=None, dtype=torch.float32):
    """Turn ``(embed, block, head)`` dicts of numpy arrays (the JAX
    package's parameters passed through ``np.asarray``) into the port's
    dicts of tensors on ``device`` in ``dtype``.  The two packages share leaf
    names, stacking and the ``[in, out]`` weight layout, so each leaf is a
    plain copy; values go through float32 so that bfloat16 arrays convert
    too."""
    dev = torch.device("cpu" if device is None else device)

    def conv(tree):
        return {k: torch.from_numpy(np.asarray(v, np.float32).copy())
                .to(device=dev, dtype=dtype) for k, v in tree.items()}

    return conv(ep), conv(bp), conv(hp)
