"""High-level entry points ``bbvi`` and ``vi_diagnostics`` (counterpart of
``viabel_tpu/convenience.py``).

Same wiring as the JAX package: default MFGaussian family, ExclusiveKL
objective, RMSProp base optimizer, RAABBVI unless ``fixed_lr``, with
``mc_escalation=4.0`` armed on the adaptive paths; ``vi_diagnostics``
runs PSIS, then the error bounds or, past the k-hat gate, the calibrated
KSD test. A ``torch.Generator`` replaces the PRNG key. The multistart,
standardize and Pathfinder routes are not ported yet (ROADMAP.md).
"""

import math

import torch

from .diagnostics import all_diagnostics, ksd_test
from .faso import FASO, RAABBVI
from .families import MFGaussian
from .models import Model
from .objectives import ExclusiveKL
from .optimizers import RMSProp, default_generator
from .psis import psislw
from .utils import not_ported

__all__ = ["bbvi", "vi_diagnostics", "psis_correction", "samples_and_log_weights"]


def bbvi(dimension, *, n_iters=10000, num_mc_samples=10, log_density=None,
         approx=None, objective=None, fit=None, adaptive=True, fixed_lr=False,
         init_var_param=None, learning_rate=0.01, generator=None,
         progress_callback=None, num_restarts=None, standardize=False,
         init_method=None, RMS_kwargs=None, FASO_kwargs=None,
         RAABBVI_kwargs=None, device="cuda", dtype=None):
    """Fit a model using black-box variational inference
    (reference convenience.py:14-94).

    ``log_density`` is a callable (or :class:`~viabel_torch.models.Model`)
    mapping ``(n, dimension)`` tensors to ``(n,)`` log densities; a
    prebuilt ``objective`` carries its own model and family instead.
    ``device``/``dtype`` place the default MFGaussian family (the default
    ``"cuda"`` raises where no card is present; pass ``device="cpu"`` to
    run on the CPU); a given ``approx`` or ``objective`` carries its own
    device. ``generator`` (default: seed 0 on the family's device) drives
    all sampling.
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


def vi_diagnostics(var_param, *, objective=None, model=None, approx=None,
                   n_samples=100000, generator=None, ksd_samples=4096,
                   ksd_null=19, ksd_pairs=None):
    """Check VI diagnostics: Pareto k-hat, 2-divergence and error bounds.

    When the k-hat gate trips (khat > 0.7, or a non-finite khat) the
    weight-based bounds are skipped and a calibrated kernelized Stein
    discrepancy test (:func:`viabel_torch.diagnostics.ksd_test`) runs on
    the first ``ksd_samples`` draws instead: ``ksd_null`` replicates under
    q's own score give an exact Monte Carlo p-value against q = p (19 give
    a 5% test). ``ksd_pairs=m`` switches both sides to the subsampled-pairs
    estimator; ``ksd_samples=0`` turns the test off. ``generator``
    (default: seed 0 on the family's device) drives every draw, the KSD
    test's included.
    """
    if objective is None:
        if model is None or approx is None:
            raise ValueError("supply an objective, or a model together with an approx")
    elif model is not None or approx is not None:
        raise ValueError("an objective already carries its model and "
                         "family; drop the model/approx arguments")
    else:
        model = objective.model
        approx = objective.approx
    if n_samples <= 0:
        raise ValueError("n_samples must be a positive integer")
    if generator is None:
        generator = default_generator(approx.device)
    return _vi_diagnostics(var_param, model, approx, n_samples, generator,
                           ksd_samples, ksd_null, ksd_pairs)


def _vi_diagnostics(var_param, model, approx, n_samples, generator,
                    ksd_samples=0, ksd_null=19, ksd_pairs=None):
    var_param = var_param.detach()  # nothing here differentiates the parameters
    samples, smoothed_log_weights, khat = psis_correction(
        var_param, model, approx, n_samples, generator)
    results = dict(samples=samples, smoothed_log_weights=smoothed_log_weights,
                   khat=khat)
    print("estimated Pareto shape: khat = {:.2f}".format(float(khat)))
    if not math.isfinite(float(khat)) or float(khat) > 0.7:
        print("WARNING: khat > 0.7 — the importance weights are too heavy-tailed")
        print("WARNING: skipping the weight-based diagnostics")
        n_ksd = min(int(ksd_samples), samples.shape[1])
        if n_ksd > 1:
            if n_ksd > 512:
                # a multiple of the row block, so that large sample counts
                # always take the blocked path (no (n, n) Gram matrix)
                n_ksd -= n_ksd % 512
                block = 512
            else:
                block = None
            # samples come back transposed (d, n) from psis_correction
            x = samples.T[:n_ksd]

            def null_score_fn(xx):
                with torch.enable_grad():
                    xx = xx.detach().requires_grad_(True)
                    return torch.autograd.grad(
                        torch.sum(approx.log_density(var_param, xx)), xx)[0]

            test = ksd_test(
                x, model=model,
                null_sampler=lambda g: approx.sample(var_param, n_ksd, g),
                null_score_fn=null_score_fn, generator=generator,
                n_null=ksd_null, block_size=block, subsample_pairs=ksd_pairs)
            results["ksd"] = test["ksd"]
            results["ksd_p_value"] = test["p_value"]
            results["ksd_reject"] = test["reject"]
            results["ksd_valid"] = test["valid"]
            print("kernelized Stein discrepancy (IMQ, n = {}): ksd = {:.3g}, "
                  "p = {:.3g} against the q = p null ({} replicates)"
                  .format(n_ksd, float(test["ksd"]), test["p_value"], ksd_null))
            if not test["valid"]:
                print("WARNING: the KSD statistic is non-finite (degenerate "
                      "draws or score overflow) — the test is invalid, not "
                      "a rejection")
            elif test["reject"]:
                print("WARNING: the KSD test rejects q = p at the {:.0%} "
                      "level — the approximation is detectably off even "
                      "before importance weighting".format(1.0 / (ksd_null + 1)))
            else:
                print("the KSD test cannot distinguish the approximation "
                      "from the target at this sample size (p > {:.2f})"
                      .format(1.0 / (ksd_null + 1)))
        return results
    print()
    if approx.supports_pth_moment(2) and approx.supports_pth_moment(4):
        def moment_bound_fn(p):
            return approx.pth_moment(var_param, p)
    else:
        moment_bound_fn = None
    _, q_var = approx.mean_and_cov(var_param)
    results.update(all_diagnostics(smoothed_log_weights, samples=samples.T,
                                   moment_bound_fn=moment_bound_fn, q_var=q_var))
    print("estimated 2-divergence: d2 = {:.2g}".format(float(results["d2"])))
    if float(results["d2"]) > 4.6:
        print("WARNING: d2 > 4.6 — the approximation is unusable as-is")
    elif float(results["d2"]) > 0.1:
        print("WARNING: 0.1 < d2 < 4.6 — moderately inaccurate; apply the "
              "PSIS-corrected weights to reduce the error.")
    else:
        print("\nall diagnostics pass")
    return results


def psis_correction(var_param, model, approx, n_samples, generator):
    """Pareto-smooth the importance weights. Returns ``(samples.T,
    smoothed_log_weights, khat)``, the samples transposed ``(dim, n)`` as
    the reference returns them."""
    samples, log_weights = samples_and_log_weights(var_param, model, approx,
                                                   n_samples, generator)
    smoothed_log_weights, khat = psislw(log_weights)
    return samples.T, smoothed_log_weights, khat


def samples_and_log_weights(var_param, model, approx, n_samples, generator):
    """Draw q samples and compute ``log p - log q``."""
    samples = approx.sample(var_param, int(n_samples), generator)
    log_weights = model(samples) - approx.log_density(var_param, samples)
    return samples, log_weights
