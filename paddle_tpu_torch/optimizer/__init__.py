from .optimizers import Adam, AdamW, Momentum

__all__ = ["Adam", "AdamW", "Momentum"]
