"""DistributedStrategy (port of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``; reference
python/paddle/distributed/fleet/base/distributed_strategy.py, backed by
distributed_strategy.proto).

A plain-Python config of the proto fields the package reads: the
hybrid_configs degrees, amp, recompute, sharding, pipeline,
gradient_merge.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class _Cfg(dict):
    __getattr__ = dict.get

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
            "order": ["dp", "pp", "sharding", "sep", "mp"],
            "mp_configs": _Cfg(), "pp_configs": _Cfg(
                micro_batch_size=1, accumulate_steps=1, schedule_mode="1F1B"),
        }
        self.amp = False
        self.amp_configs = _Cfg(init_loss_scaling=65536.0, use_pure_fp16=False,
                                custom_white_list=[], custom_black_list=[])
        self.recompute = False
        self.recompute_configs = _Cfg(checkpoints=[])
        self.sharding = False
        self.sharding_configs = _Cfg(stage=1, degree=1)
        self.gradient_merge = False
        self.gradient_merge_configs = _Cfg(k_steps=1, avg=True)
        self.pipeline = False
        self.pipeline_configs = _Cfg(micro_batch_size=1, accumulate_steps=1)
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Cfg(tensor_parallel_degree=1)

    def __setattr__(self, key, value):
        if key == "hybrid_configs" and hasattr(self, "hybrid_configs") \
                and isinstance(value, dict):
            merged = dict(self.__dict__["hybrid_configs"])
            merged.update(value)
            self.__dict__["hybrid_configs"] = merged
        else:
            self.__dict__[key] = value

    def __repr__(self):
        return f"DistributedStrategy(hybrid_configs={self.hybrid_configs})"
