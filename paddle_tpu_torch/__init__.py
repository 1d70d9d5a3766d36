"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
paged LLaMA serving path (``inference.paged.ServingEngine`` over
``models.llama.build_llama_paged_decode``) in PyTorch, with the TPU's Pallas
ragged paged-attention kernel rewritten by hand in CUDA C++ for ``sm_90a``
(``ops/csrc/ragged_paged_attention.cu``).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` resolves to ``"cuda"`` and raises when no CUDA device is
visible.  The CPU (``device="cpu"``) runs every kernel's plain PyTorch
version — that is how the parity tests run without a card.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device", "on_device", "__version__"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the current CUDA
    device, which must exist — a missing card raises instead of quietly
    falling back to the CPU.  An explicit ``"cpu"`` (the tests) or
    ``"cuda[:n]"`` passes through."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: no CUDA device is visible; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether tensor ``t`` lies on ``dev``; a CUDA device without an index
    is the current one."""
    if t.device.type != dev.type:
        return False
    if dev.type != "cuda" or dev.index is None and t.device.index is None:
        return True
    cur = torch.cuda.current_device()
    return (t.device.index if t.device.index is not None else cur) \
        == (dev.index if dev.index is not None else cur)
