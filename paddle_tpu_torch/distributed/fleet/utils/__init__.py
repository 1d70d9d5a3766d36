from . import hybrid_parallel_util  # noqa: F401
