"""High-level entry point ``bbvi`` (counterpart of ``viabel_tpu/convenience.py``).

Same wiring as the JAX package: default MFGaussian family, ExclusiveKL
objective, RMSProp base optimizer, RAABBVI unless ``fixed_lr``, with
``mc_escalation=4.0`` armed on the adaptive paths. A ``torch.Generator``
replaces the PRNG key. ``vi_diagnostics`` and the multistart, standardize
and Pathfinder routes are not ported yet (ROADMAP.md).
"""

from .faso import FASO, RAABBVI
from .families import MFGaussian
from .models import Model
from .objectives import ExclusiveKL
from .optimizers import RMSProp, default_generator
from .utils import not_ported

__all__ = ["bbvi"]


def bbvi(dimension, *, n_iters=10000, num_mc_samples=10, log_density=None,
         approx=None, objective=None, fit=None, adaptive=True, fixed_lr=False,
         init_var_param=None, learning_rate=0.01, generator=None,
         progress_callback=None, num_restarts=None, standardize=False,
         init_method=None, RMS_kwargs=None, FASO_kwargs=None,
         RAABBVI_kwargs=None, device="cpu", dtype=None):
    """Fit a model using black-box variational inference
    (reference convenience.py:14-94).

    ``log_density`` is a callable (or :class:`~viabel_torch.models.Model`)
    mapping ``(n, dimension)`` tensors to ``(n,)`` log densities; a
    prebuilt ``objective`` carries its own model and family instead.
    ``device``/``dtype`` place the default MFGaussian family; ``generator``
    (default: seed 0 on the family's device) drives all sampling.
    ``progress_callback(k, avg_loss)`` fires at segment boundaries.

    Per-step gradient/direction histories are on by default like the
    reference; at d=1000 full-rank they cost 8 MB per step, so pass
    ``RMS_kwargs=dict(diagnostics=False)`` unless you need them (this also
    turns on the pipelined R-hat verdicts).
    """
    if fit is not None:
        raise not_ported("bbvi(fit=...) (PyStan fits)", 8)
    if num_restarts is not None:
        raise not_ported("bbvi(num_restarts=...)", 13)
    if standardize:
        raise not_ported("bbvi(standardize=True)", 10)
    if init_method is not None:
        raise not_ported("bbvi(init_method=...)", 11)
    RMS_kwargs = dict(RMS_kwargs or {})
    FASO_kwargs = dict(FASO_kwargs or {})
    RAABBVI_kwargs = dict(RAABBVI_kwargs or {})

    if objective is not None:
        if log_density is not None or approx is not None:
            raise ValueError(
                "an objective already carries its model and family; drop the "
                "log_density/approx arguments")
        approx = objective.approx
    else:
        if log_density is None:
            raise ValueError(
                "nothing to optimize: pass a log_density (or a prebuilt objective)")
        model = log_density if isinstance(log_density, Model) else Model(log_density)
        if approx is None:
            approx = MFGaussian(dimension, device=device, dtype=dtype)
        objective = ExclusiveKL(approx, model, num_mc_samples)
    if generator is None:
        generator = default_generator(approx.device)
    if init_var_param is None:
        init_var_param = approx.init_param()
    if not isinstance(learning_rate, (int, float)):
        raise ValueError("a per-restart learning_rate array needs a "
                         "multistart run, which is not ported yet")
    # diagnostics (full per-step histories) on by default like the reference
    RMS_kwargs.setdefault("diagnostics", True)
    base_opt = RMSProp(learning_rate, **RMS_kwargs)
    # the SNR-wall cure is on by default on the adaptive paths: escalation
    # only fires when a gate statistic has provably plateaued
    if adaptive and getattr(objective, "num_mc_samples", None) is not None:
        RAABBVI_kwargs.setdefault("mc_escalation", 4.0)
        FASO_kwargs.setdefault("mc_escalation", 4.0)
    if adaptive and not fixed_lr:
        opt = RAABBVI(base_opt, **RAABBVI_kwargs)
    elif adaptive and fixed_lr:
        opt = FASO(base_opt, **FASO_kwargs)
    elif not adaptive and fixed_lr:
        opt = base_opt
    else:
        raise ValueError("a decaying learning rate needs the adaptive "
                         "optimizer: set adaptive=True or fixed_lr=True")
    opt_results = opt.optimize(n_iters, objective, init_var_param,
                               generator=generator,
                               progress_callback=progress_callback)
    opt_results["objective"] = objective
    return opt_results
