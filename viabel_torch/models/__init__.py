from . import zoo
from .base import Model

__all__ = ["Model", "zoo"]
