"""Launch helpers of the port (reference:
python/paddle/distributed/launch/).  So far the two pieces the
cross-process serving fleet spawns its workers with: :func:`_free_port`
and :func:`_rank_env`; the launcher itself is not ported yet."""
from .main import _free_port, _rank_env

__all__ = ["_free_port", "_rank_env"]
