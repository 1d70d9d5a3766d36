"""Mixed precision: the loss scaler.  ``auto_cast`` / ``decorate`` are not
ported (ROADMAP A item 7): JAX's ``auto_cast`` is a hook in its op-dispatch
layer, which the port does not have."""
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["GradScaler", "AmpScaler"]
