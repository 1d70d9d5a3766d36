from .quant import (KV_DTYPES, dequantize_kv, kv_spec, page_bytes,
                    quantize_kv, quantize_params)
from .snapshot import EngineSnapshotManager, load_engine_snapshot

__all__ = ["KV_DTYPES", "dequantize_kv", "kv_spec", "page_bytes",
           "quantize_kv", "quantize_params", "EngineSnapshotManager",
           "load_engine_snapshot"]
