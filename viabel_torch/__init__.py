"""viabel_torch: black-box variational inference in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`viabel_tpu` (the JAX package, which stays the reference)
that keeps its module names, public function names and flat parameter
layouts. It covers ``bbvi``'s adaptive path (the MFGaussian and
FullRankGaussian families, the ExclusiveKL objective, RMSProp, FASO and
RAABBVI) and the ``vi_diagnostics`` front door (PSIS, the error bounds,
the KSD test). Kernels live in :mod:`viabel_torch.ops`. Every entry point
runs on the CUDA card unless the caller passes ``device="cpu"``.
"""

from . import (convert, diagnostics, families, hmc, mc_diagnostics, objectives,
               ops, optimizers, psis)
from .convenience import bbvi, vi_diagnostics
from .faso import FASO, RAABBVI
from .families import ApproximationFamily, FullRankGaussian, MFGaussian
from .models import Model, zoo
from .objectives import (ExclusiveKL, StochasticVariationalObjective,
                         VariationalObjective)
from .optimizers import (AveragedRMSProp, Optimizer, RMSProp,
                         StochasticGradientOptimizer)
from .utils import deferred_names

__getattr__ = deferred_names(__name__, {
    **families.NOT_PORTED, **objectives.NOT_PORTED, **optimizers.NOT_PORTED})

__version__ = "0.1.0"

__all__ = [
    "ApproximationFamily", "MFGaussian", "FullRankGaussian",
    "Model", "zoo",
    "VariationalObjective", "StochasticVariationalObjective", "ExclusiveKL",
    "Optimizer", "StochasticGradientOptimizer", "RMSProp", "AveragedRMSProp",
    "FASO", "RAABBVI", "bbvi", "vi_diagnostics",
    "convert", "diagnostics", "hmc", "mc_diagnostics", "ops", "psis",
]
