from .activation import (gelu, hardsigmoid, hardswish, relu, relu6, silu,
                         softmax, softmax_)
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention)
from .common import dropout, interpolate
from .loss import cross_entropy
from .norm import (batch_norm, group_norm, layer_norm, layer_norm_ref,
                   rms_norm_ref)
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm", "cross_entropy",
           "dropout",
           "flash_attention", "flash_attn_unpadded", "gelu", "group_norm",
           "hardsigmoid", "hardswish", "interpolate", "layer_norm",
           "layer_norm_ref", "max_pool2d", "relu", "relu6", "rms_norm_ref",
           "scaled_dot_product_attention", "silu", "softmax", "softmax_"]
