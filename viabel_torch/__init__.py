"""viabel_torch: black-box variational inference in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`viabel_tpu` (the JAX package, which stays the reference)
that keeps its module names, public function names and flat parameter
layouts. It covers ``bbvi``'s adaptive path (FASO and RAABBVI), the
parametric families (MFGaussian, MFStudentT, FullRankGaussian,
MultivariateT, LRGaussian) and the neural ones (NeuralNet, NVPFlow, RealNVP), the
ExclusiveKL (with its control variates), IWELBO, AlphaDivergence and
DISInclusiveKL objectives, every step rule, FASO and RAABBVI resume and
wall-clock budgets with the ``.npz`` checkpoint, the tempered and
subsampled models, constrained-parameter transforms, randomized
quasi-Monte Carlo base samplers, Pathfinder, ``bbvi``'s pilot
standardization and Pathfinder initialization, the single-device
multistart engines (:mod:`viabel_torch.parallel`: ``multistart_optimize``,
``multistart_faso``, ``multistart_raabbvi`` on the lockstep and the async
schedule) with ``bbvi(num_restarts=...)`` and its restart selection
(``elbo_estimates``, ``select_best_restart``), Monte Carlo sample-axis
data parallelism over ``torch.distributed`` (``make_mesh``,
``distributed_init``, ``ShardedExclusiveKL``, ``shard_mc_objective``),
the C++ model bridge
(:mod:`viabel_torch.external`), and the ``vi_diagnostics`` front door
(PSIS with ``psislw``, ``psisloo``, ``gpdfitnew``, ``gpinv`` and
``sumlogs``; ``all_diagnostics``, ``error_bounds``,
``wasserstein_bounds``, ``divergence_bound``; the KSD and its test,
``ksd`` and ``ksd_test``). Kernels live in :mod:`viabel_torch.ops`. Every entry point runs on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from . import (checkpoint, convert, diagnostics, distributions, families, hmc,
               mc_diagnostics, objectives, ops, optimizers, parallel, psis, qmc,
               transforms)
from .convenience import (bbvi, elbo_estimates, pilot_standardize, select_best_restart,
                          vi_diagnostics)
from .diagnostics import (all_diagnostics, divergence_bound, error_bounds, ksd, ksd_test,
                          wasserstein_bounds)
from .distributions import multivariate_normal_logpdf, multivariate_t_logpdf
from .faso import FASO, RAABBVI
from .families import (ApproximationFamily, FullRankGaussian, LRGaussian, MFGaussian,
                       MFStudentT, MultivariateT, NeuralNet, NVPFlow, RealNVP)
from .models import Model, SubsampledModel, TemperedModel, zoo
from .objectives import (AlphaDivergence, DISInclusiveKL, ExclusiveKL, IWELBO,
                         StochasticVariationalObjective, VariationalObjective)
from .optimizers import (Adagrad, Adam, AveragedAdam, AveragedRMSProp, Optimizer,
                         RMSProp, StochasticGradientOptimizer, WindowedAdagrad)
from .pathfinder import multipath_pathfinder, pathfinder, pathfinder_init
from .psis import gpdfitnew, gpinv, psisloo, psislw, sumlogs
from .qmc import AntitheticNormal, SobolNormal
from .transforms import ParamSpec, TransformedModel

__version__ = "0.1.0"

__all__ = [
    "ApproximationFamily", "MFGaussian", "MFStudentT", "FullRankGaussian",
    "MultivariateT", "LRGaussian", "NeuralNet", "NVPFlow", "RealNVP",
    "Model", "SubsampledModel", "TemperedModel", "zoo",
    "VariationalObjective", "StochasticVariationalObjective", "ExclusiveKL",
    "IWELBO", "AlphaDivergence", "DISInclusiveKL",
    "Optimizer", "StochasticGradientOptimizer", "RMSProp", "AveragedRMSProp",
    "Adam", "AveragedAdam", "Adagrad", "WindowedAdagrad",
    "FASO", "RAABBVI", "bbvi", "vi_diagnostics", "pilot_standardize",
    "elbo_estimates", "select_best_restart", "parallel",
    "all_diagnostics", "error_bounds", "wasserstein_bounds", "divergence_bound",
    "ksd", "ksd_test", "psislw", "psisloo", "gpdfitnew", "gpinv", "sumlogs",
    "pathfinder", "multipath_pathfinder", "pathfinder_init",
    "ParamSpec", "TransformedModel", "transforms",
    "SobolNormal", "AntitheticNormal", "qmc",
    "multivariate_normal_logpdf", "multivariate_t_logpdf",
    "checkpoint", "convert", "diagnostics", "distributions", "hmc",
    "mc_diagnostics", "ops", "psis",
]
