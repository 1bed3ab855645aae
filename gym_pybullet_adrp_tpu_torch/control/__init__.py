"""Flight controllers: function cores and the object-style API wrappers
(control/api.py)."""

from .api import BaseControl, CTBRControl, DSLPIDControl, MellingerControl

__all__ = ["BaseControl", "CTBRControl", "DSLPIDControl", "MellingerControl"]
