from .functional import (fused_linear_cross_entropy,
                         fused_linear_cross_entropy_impl)

__all__ = ["fused_linear_cross_entropy", "fused_linear_cross_entropy_impl"]
