from .activation import gelu, softmax
from .attention import scaled_dot_product_attention
from .norm import layer_norm, layer_norm_ref, rms_norm_ref

__all__ = ["gelu", "layer_norm", "layer_norm_ref", "rms_norm_ref",
           "scaled_dot_product_attention", "softmax"]
