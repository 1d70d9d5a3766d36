from . import models, ops, transforms

__all__ = ["models", "ops", "transforms"]
