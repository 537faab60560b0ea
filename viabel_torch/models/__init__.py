from . import zoo
from .base import Model, SubsampledModel, TemperedModel

__all__ = ["Model", "TemperedModel", "SubsampledModel", "zoo"]
