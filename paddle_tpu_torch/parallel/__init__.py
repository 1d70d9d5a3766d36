from .pipeline import _flatten, _unflatten  # noqa: F401
