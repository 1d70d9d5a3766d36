"""The quantized all-reduce of tensor-parallel serving (port of
``paddle_tpu/distributed/quant_collectives.py``; EQuARX, arxiv
2506.17615): each rank's partial sum is snapped onto an int8 per-chunk
absmax grid before the reduction, so the payload a real ring would move
per hop is about four times smaller than f32.

The semantics are JAX's emulation, exactly: :func:`quantized_allreduce`
fake-quantizes the LOCAL partial — one absmax scale per ``chunk``
elements, through the port's KV codec (``serving.quant.quantize_kv`` /
``dequantize_kv``, bit-equal to JAX's) — then issues ONE f32
``all_reduce(SUM)`` of the dequantized partials over the group
(``communication.all_reduce``, counted there).  That is what a ring
computes when every hop carries int8 codes plus f32 scales and
accumulates in f32: the quantization error enters once per rank, the
reduction itself is exact.  The wire stays f32, as in JAX.

Error bound: symmetric absmax rounding gives each element an error of at
most ``chunk_absmax / (2 qmax)`` per rank, so the reduced value is within
``n_ranks * max_r(chunk_absmax_r) / (2 qmax)`` of the f32 sum
(:func:`quantized_allreduce_ref`, the single-process reference, pairs
with the collective as a kernel pairs with its plain version).

``allreduce(x, axis_name, quantized=False)`` is the f32 path the serving
engine's ``quantized_allreduce=False`` takes: a plain sum.  ``axis_name``
is an axis of the default mesh, as JAX's is a ``shard_map`` axis, or the
``Group`` itself.
"""
from __future__ import annotations

import torch

from ..serving.quant import dequantize_kv, quantize_kv
from .communication.collectives import ReduceOp, all_reduce

__all__ = ["DEFAULT_CHUNK", "DEFAULT_QMAX", "allreduce", "fake_quant_chunks",
           "quantized_allreduce", "quantized_allreduce_ref"]

# the int8 symmetric grid (serving.quant.KV_DTYPES' int8 row); 256 elements
# per absmax chunk keep the scales at f32/256 per element
DEFAULT_CHUNK = 256
DEFAULT_QMAX = 127.0


def fake_quant_chunks(x, *, chunk: int = DEFAULT_CHUNK,
                      qmax: float = DEFAULT_QMAX, dtype=torch.int8):
    """``x`` rounded onto the per-chunk absmax int grid and back: the value
    an EQuARX hop reconstructs from its payload.  The flattened tensor is
    cut into ``chunk``-wide rows (the tail zero-padded: zeros round-trip
    exactly), each quantized with its own scale and dequantized; the
    result has ``x``'s shape and dtype."""
    shape, d = x.shape, x.dtype
    flat = x.reshape(-1)
    n = flat.shape[0]
    c = max(1, int(chunk))
    pad = (-n) % c
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    q, s = quantize_kv(flat.reshape(-1, c), qmax=qmax, dtype=dtype)
    return dequantize_kv(q, s).reshape(-1)[:n].reshape(shape).to(d)


def _group(axis_name):
    """A mesh axis's name -> this rank's group along it on the default mesh
    (``topology.axis_group``); a ``Group`` passes as it is."""
    if isinstance(axis_name, str):
        from .topology import axis_group
        return axis_group(axis_name)
    return axis_name


def quantized_allreduce(x, axis_name, *, chunk: int = DEFAULT_CHUNK,
                        qmax: float = DEFAULT_QMAX, dtype=torch.int8):
    """The EQuARX all-reduce over ``axis_name`` (an axis of the default
    mesh, or a ``Group``): this rank's partial quantized per chunk, the
    dequantized partials summed by ONE all-reduce.  Returns a new tensor
    (``x`` is left as it is)."""
    out = fake_quant_chunks(x, chunk=chunk, qmax=qmax, dtype=dtype)
    all_reduce(out, ReduceOp.SUM, _group(axis_name))
    return out


def allreduce(x, axis_name, *, quantized: bool = False,
              chunk: int = DEFAULT_CHUNK, qmax: float = DEFAULT_QMAX,
              dtype=torch.int8):
    """The serving engine's one all-reduce a layer over ``axis_name`` (as
    :func:`quantized_allreduce`): the f32 sum, or with ``quantized`` the
    EQuARX grid; one collective either way.  Returns a new tensor."""
    if quantized:
        return quantized_allreduce(x, axis_name, chunk=chunk, qmax=qmax,
                                   dtype=dtype)
    out = x.clone()
    all_reduce(out, ReduceOp.SUM, _group(axis_name))
    return out


def quantized_allreduce_ref(partials, *, chunk: int = DEFAULT_CHUNK,
                            qmax: float = DEFAULT_QMAX, dtype=torch.int8):
    """The single-process reference: ``partials [R, ...]``, the ranks'
    partial sums stacked, -> the value every rank holds after
    :func:`quantized_allreduce` (the sum of each rank's fake-quantized
    partial, in rank order)."""
    return torch.stack([fake_quant_chunks(p, chunk=chunk, qmax=qmax,
                                          dtype=dtype)
                        for p in partials]).sum(0)
