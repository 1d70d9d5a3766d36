from . import hybrid_parallel_util  # noqa: F401
from ..recompute import recompute, recompute_sequential  # noqa: F401
from . import sequence_parallel_utils  # noqa: F401
