"""The pipeline layer description (port of ``paddle_tpu/distributed/fleet/
meta_parallel/pp_layers.py``; reference fleet/meta_parallel/parallel_layers/
pp_layers.py — PipelineLayer :258, LayerDesc :57, SegmentLayers :93).

``PipelineLayer`` declares the model as an ordered list of ``LayerDesc``s
and cuts it into stages (``segment_parts``).  As in JAX it builds every
stage's layers on every rank; ``GenericPipeline1F1BTrainStep`` runs only
this rank's stage of them, with the parameters replicated over pp.
"""
from __future__ import annotations

from typing import List

from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_cls, type) and issubclass(layer_cls,
                                                           nn.Module)) \
                and not callable(layer_cls):
            raise TypeError("LayerDesc expects an nn.Module subclass")

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer whose weights several places of the model tie (the
    embedding and the output head, reference pp_layers.py
    SharedLayerDesc): built once per ``key``."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Cut N layer descs into ``num_parts`` stages (reference :93):
    ``"uniform"`` or ``"layer:<ClassName>"`` (the named layers spread
    evenly over the stages; fewer of them than stages falls back to
    uniform).  ``do_segment`` returns the num_parts + 1 bounds."""

    def __init__(self, layers_desc, num_parts, method="uniform",
                 num_virtual_pipeline_stage=None):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method

    def do_segment(self) -> List[int]:
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            idxs = [i for i, d in enumerate(self.descs)
                    if getattr(getattr(d, "layer_cls", type(d)), "__name__",
                               "") == name]
            if len(idxs) < self.num_parts:
                return self.uniform(n, self.num_parts)
            per = len(idxs) / self.num_parts
            bounds = [0]
            for p in range(1, self.num_parts):
                bounds.append(idxs[int(round(p * per))])
            bounds.append(n)
            return bounds
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts):
        base = num_items // num_parts
        rem = num_items % num_parts
        bounds = [0]
        for i in range(num_parts):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        return bounds


class _SharedForward(nn.Module):
    """A ``SharedLayerDesc`` place with its own ``forward_func`` over the
    shared layer."""

    def __init__(self, inner, fwd):
        super().__init__()
        self.inner = inner
        self._fwd = fwd

    def forward(self, *args, **kw):
        return self._fwd(self.inner, *args, **kw)


class _Call(nn.Module):
    """A plain callable of the desc list as a layer."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args, **kw):
        return self._fn(*args, **kw)


class PipelineLayer(nn.Module):
    """reference pp_layers.py:258: every desc built, in order, into
    ``run_function`` (a ``LayerList``); ``segment_parts`` holds the stage
    bounds; ``get_stage_layers(s)`` a stage's layers; ``forward`` runs them
    all."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        from ....nn.layers import LayerList
        super().__init__()
        self._descs = list(layers)
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._loss_fn = loss_fn
        self.segment_parts = SegmentLayers(self._descs, self._num_stages,
                                           seg_method).do_segment()
        self._shared = {}
        self.run_function = LayerList([self._build_one(d)
                                       for d in self._descs])

    def _build_one(self, d):
        if isinstance(d, SharedLayerDesc):
            if d.layer_name not in self._shared:
                self._shared[d.layer_name] = d.build_layer()
            base = self._shared[d.layer_name]
            if d.forward_func is None:
                return base
            return _SharedForward(base, d.forward_func)
        if isinstance(d, LayerDesc):
            return d.build_layer()
        if isinstance(d, nn.Module):
            return d
        if callable(d):
            return _Call(d)
        raise TypeError(f"bad pipeline item {d!r}")

    def get_stage_layers(self, stage: int):
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return [self.run_function[i] for i in range(lo, hi)]

    @property
    def loss_fn(self):
        return self._loss_fn

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x) if not isinstance(x, tuple) else layer(*x)
        return x
