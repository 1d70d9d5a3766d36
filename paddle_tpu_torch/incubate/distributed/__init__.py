"""paddle.incubate.distributed's port (JAX ``paddle_tpu/incubate/
distributed/``)."""
from . import models

__all__ = ["models"]
