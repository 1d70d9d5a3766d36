from .activation import gelu, silu, softmax
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention)
from .common import dropout, interpolate
from .norm import group_norm, layer_norm, layer_norm_ref, rms_norm_ref

__all__ = ["dropout", "flash_attention", "flash_attn_unpadded", "gelu",
           "group_norm", "interpolate", "layer_norm", "layer_norm_ref",
           "rms_norm_ref", "scaled_dot_product_attention", "silu", "softmax"]
