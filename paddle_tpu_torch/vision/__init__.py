from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms"]
