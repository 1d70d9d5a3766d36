from .quant import (KV_DTYPES, dequantize_kv, kv_spec, page_bytes,
                    quantize_kv, quantize_params)

__all__ = ["KV_DTYPES", "dequantize_kv", "kv_spec", "page_bytes",
           "quantize_kv", "quantize_params"]
