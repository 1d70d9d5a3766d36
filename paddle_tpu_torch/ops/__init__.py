# the differentiable op stays ``ops.flash_attention.flash_attention``: a
# package-level name would hide the module
from .flash_attention import (flash_attention_bwd_dkv, flash_attention_bwd_dq,
                              flash_attention_fwd, flash_attention_ref,
                              pack_lse)
from .fused import (adamw_update, layer_norm, layer_norm_bwd, layer_norm_fwd,
                    rms_norm, rms_norm_bwd, rms_norm_fwd, softmax,
                    softmax_bwd, softmax_fwd)
from .paged_attention import (NEG_INF, paged_attention_decode_ref,
                              paged_gather_kv, paged_gather_scales,
                              ragged_paged_attention,
                              ragged_paged_attention_decode,
                              ragged_paged_attention_ref)

__all__ = ["NEG_INF", "adamw_update", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_fwd",
           "flash_attention_ref", "pack_lse", "paged_attention_decode_ref",
           "paged_gather_kv", "paged_gather_scales", "ragged_paged_attention",
           "ragged_paged_attention_decode", "ragged_paged_attention_ref",
           "layer_norm", "layer_norm_bwd", "layer_norm_fwd", "rms_norm",
           "rms_norm_bwd", "rms_norm_fwd", "softmax", "softmax_bwd",
           "softmax_fwd"]
