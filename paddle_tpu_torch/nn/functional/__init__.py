from .norm import rms_norm_ref

__all__ = ["rms_norm_ref"]
