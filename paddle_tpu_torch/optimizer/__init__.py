from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW"]
