"""paddle.nn's port: the layers (``layers.py``), the loss layer
(``loss.py``), gradient clipping (``clip.py``) and the functionals
(``functional/``)."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .loss import CrossEntropyLoss

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "CrossEntropyLoss"]
