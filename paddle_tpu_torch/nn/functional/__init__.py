from .activation import gelu, softmax
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention)
from .common import dropout
from .norm import layer_norm, layer_norm_ref, rms_norm_ref

__all__ = ["dropout", "flash_attention", "flash_attn_unpadded", "gelu",
           "layer_norm", "layer_norm_ref", "rms_norm_ref",
           "scaled_dot_product_attention", "softmax"]
