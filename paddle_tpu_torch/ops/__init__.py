from .paged_attention import (NEG_INF, paged_attention_decode_ref,
                              paged_gather_kv, paged_gather_scales,
                              ragged_paged_attention,
                              ragged_paged_attention_decode,
                              ragged_paged_attention_ref)

__all__ = ["NEG_INF", "paged_attention_decode_ref", "paged_gather_kv",
           "paged_gather_scales", "ragged_paged_attention",
           "ragged_paged_attention_decode", "ragged_paged_attention_ref"]
