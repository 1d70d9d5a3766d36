"""RMSNorm, plain PyTorch (port of ``paddle_tpu.nn.functional.norm``)."""
from __future__ import annotations

import torch

__all__ = ["rms_norm_ref"]


def rms_norm_ref(v, w=None, epsilon=1e-6):
    """RMSNorm over the last axis with f32 statistics; the weight is applied
    in f32 and the result cast back to ``v.dtype`` — the same convention as
    the JAX package's ``rms_norm_ref``, which the paged serving path uses
    for every norm."""
    vf = v.float()
    ms = vf.square().mean(dim=-1, keepdim=True)
    out = vf * torch.rsqrt(ms + epsilon)
    if w is not None:
        out = out * w.float()
    return out.to(v.dtype)
