"""High-level entry points ``bbvi`` and ``vi_diagnostics`` (counterpart of
``viabel_tpu/convenience.py``).

Same wiring as the JAX package: default MFGaussian family, ExclusiveKL
objective, RMSProp base optimizer, RAABBVI unless ``fixed_lr``, with
``mc_escalation=4.0`` armed on the adaptive paths; ``vi_diagnostics``
runs PSIS, then the error bounds or, past the k-hat gate, the calibrated
KSD test. A ``torch.Generator`` replaces the PRNG key. ``bbvi`` also
takes the two data-driven front routes, ``standardize=True`` (a
mean-field pilot, :func:`pilot_standardize`) and
``init_method="pathfinder"``; the multistart route is not ported yet
(ROADMAP.md).
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

__all__ = ["bbvi", "vi_diagnostics", "psis_correction", "samples_and_log_weights",
           "pilot_standardize"]


def pilot_standardize(dimension, log_density, *, n_iters=8000,
                      num_mc_samples=40, learning_rate=0.02, generator=None,
                      name="x", RMS_kwargs=None, device="cuda", dtype=None):
    """Mean-field pilot standardization for scale-heterogeneous targets.

    Fits a fixed-budget mean-field Gaussian (plain RMSProp, no convergence
    detection) and wraps ``log_density`` in a
    :class:`~viabel_torch.transforms.TransformedModel` with an
    ``Affine(mu_pilot, sigma_pilot)`` bijector, so that a later BBVI run
    optimizes in O(1)-scaled coordinates. On targets with strongly
    heterogeneous scales, the large-scale rows of a full-rank factor have
    ELBO curvature ~1/sd^2 and mix slowly under a normalized optimizer;
    the log-sigma parameterization is self-standardizing, so a cheap pilot
    recovers the marginal scales. (A Pathfinder sketch does not replace
    it: its rank-2J plus diagonal covariance leaves scales at 0.2-2x.)

    Returns ``(std_model, spec, pilot_results)``: optimize against
    ``std_model``, then map draws or optima back to the original space
    with ``spec.constrain(...)[name]``. The pilot family lives on
    ``device`` in ``dtype``; ``generator`` (default: seed 0 there) drives
    its draws.

    Departure from the JAX package, which folds whatever the pilot
    returns: a pilot whose location or scale is non-finite, or whose scale
    is not positive, raises ``ValueError`` here before anything is built
    on it.
    """
    from .transforms import ParamSpec, TransformedModel, affine

    model = log_density if isinstance(log_density, Model) else Model(log_density)
    RMS_kwargs = dict(RMS_kwargs or {})
    RMS_kwargs.setdefault("diagnostics", False)
    approx = MFGaussian(int(dimension), device=device, dtype=dtype)
    if generator is None:
        generator = default_generator(approx.device)
    objective = ExclusiveKL(approx, model, int(num_mc_samples))
    res = RMSProp(learning_rate, **RMS_kwargs).optimize(
        int(n_iters), objective, approx.init_param(), generator=generator)
    mu, log_sigma = approx.unpack(res["opt_param"])
    scale = torch.exp(log_sigma)
    if not bool(torch.all(torch.isfinite(mu) & torch.isfinite(scale) & (scale > 0))):
        raise ValueError(
            "the standardization pilot diverged: its location or scale is "
            "non-finite or its scale is not positive; lower the pilot's "
            "learning_rate or raise its num_mc_samples through pilot_kwargs")
    spec = ParamSpec([(name, int(dimension), affine(mu, scale))])
    std_model = TransformedModel(lambda p: model(p[name]), spec)
    return std_model, spec, res


def bbvi(dimension, *, n_iters=10000, num_mc_samples=10, log_density=None,
         approx=None, objective=None, fit=None, adaptive=True, fixed_lr=False,
         init_var_param=None, learning_rate=0.01, generator=None,
         progress_callback=None, num_restarts=None, init_var_params=None,
         standardize=False, pilot_kwargs=None, init_method=None,
         pathfinder_kwargs=None, RMS_kwargs=None, FASO_kwargs=None,
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

    Data-driven initialization: ``init_method="pathfinder"`` runs
    :func:`viabel_torch.pathfinder.pathfinder_init` on the model and
    starts from the ELBO-best quasi-Newton Gaussian moment-matched onto
    the family (tune with ``pathfinder_kwargs``, e.g. ``dict(n_paths=4,
    max_iters=40)``).

    Standardization: ``standardize=True`` runs the :func:`pilot_standardize`
    mean-field pilot (tune with ``pilot_kwargs``), optimizes against the
    pilot-standardized target, and folds the affine back into the
    family's parameters in closed form (``fold_affine``), so the returned
    ``opt_param`` and the results' ``objective`` live in the user's
    coordinates. The family needs ``fold_affine`` (every location-scale
    family has it; NeuralNet and NVPFlow do not). An explicit
    ``init_var_param`` is read in the user's coordinates and unfolded for
    the run. ``results["standardization"]`` holds ``affine=(p_mu,
    p_scale)``, the ``spec`` and the ``pilot_results``. The per-step
    histories stay in pilot coordinates: fold a parameter row back with
    ``approx.fold_affine(row, *results["standardization"]["affine"])``.
    The loss history needs no fold: the standardized model carries the
    affine's log-Jacobian ``sum(log p_scale)`` in every log density, and
    the folded q's entropy is larger by the same ``sum(log p_scale)``, so
    each ``value_history`` entry is the user-space negative ELBO of the
    folded iterate at the same draws. Only the model term alone, ``E_q
    log p``, is offset by ``sum(log p_scale)`` between the two spaces.
    """
    if num_restarts is not None:
        raise not_ported("bbvi(num_restarts=...)", 13)
    if init_var_params is not None:
        raise not_ported("bbvi(init_var_params=...)", 13)
    RMS_kwargs = dict(RMS_kwargs or {})
    FASO_kwargs = dict(FASO_kwargs or {})
    RAABBVI_kwargs = dict(RAABBVI_kwargs or {})

    if objective is not None:
        if fit is not None or log_density is not None or approx is not None:
            raise ValueError(
                "an objective already carries its model and family; drop the fit/"
                "log_density/approx arguments")
        approx = objective.approx
        model = objective.model
    else:
        if log_density is None:
            if fit is None:
                raise ValueError(
                    "nothing to optimize: pass a log_density (or a prebuilt objective)")
            raise NotImplementedError(
                "PyStan fits are not supported in viabel_torch; provide a torch "
                "log_density (see viabel_torch.models.zoo)")
        elif fit is not None:
            raise ValueError("pass either log_density or fit, not both")
        model = log_density if isinstance(log_density, Model) else Model(log_density)
        if approx is None:
            approx = MFGaussian(dimension, device=device, dtype=dtype)
        objective = ExclusiveKL(approx, model, num_mc_samples)
    if generator is None:
        generator = default_generator(approx.device)
    standardization = orig_model = None
    if standardize:
        try:
            approx.fold_affine(approx.init_param(), 0.0, 1.0)
        except NotImplementedError as exc:
            raise ValueError(
                "standardize=True needs a family with a closed-form affine "
                f"pushforward; {type(approx).__name__} has none — run "
                "pilot_standardize yourself and map draws back through "
                "spec.constrain") from exc
        std_model, spec, pilot_results = pilot_standardize(
            approx.dim, model, generator=generator, device=approx.device,
            dtype=approx.dtype, **dict(pilot_kwargs or {}))
        p_mu, p_log_sigma = torch.split(pilot_results["opt_param"], approx.dim)
        p_scale = torch.exp(p_log_sigma)
        standardization = dict(affine=(p_mu, p_scale), spec=spec,
                               pilot_results=pilot_results)
        orig_model, model = model, std_model
        objective.model = std_model
        if init_var_param is not None:
            # an explicit init arrives in the user's coordinates; the
            # inverse affine is itself an affine
            init_var_param = approx.fold_affine(init_var_param, -p_mu / p_scale,
                                                1.0 / p_scale)
    elif pilot_kwargs is not None:
        raise ValueError("pilot_kwargs needs standardize=True")
    try:
        if init_method is not None:
            if init_method != "pathfinder":
                raise ValueError(f"unknown init_method {init_method!r}; the one "
                                 "built-in data-driven initializer is 'pathfinder'")
            if init_var_param is not None:
                raise ValueError("init_method='pathfinder' computes the init; "
                                 "drop init_var_param(s)")
            from .pathfinder import pathfinder_init
            init_var_param = pathfinder_init(approx, model, generator,
                                             **dict(pathfinder_kwargs or {}))
        elif pathfinder_kwargs is not None:
            raise ValueError("pathfinder_kwargs needs init_method='pathfinder'")
        opt_results = _bbvi_single(objective, approx, n_iters, init_var_param,
                                   learning_rate, generator, adaptive, fixed_lr,
                                   progress_callback, RMS_kwargs, FASO_kwargs,
                                   RAABBVI_kwargs)
    finally:
        if standardization is not None:
            # the results' objective diagnoses the user's target (a
            # prebuilt objective is restored on an error as well)
            objective.model = orig_model
    if standardization is not None:
        opt_results["opt_param"] = approx.fold_affine(opt_results["opt_param"],
                                                      p_mu, p_scale)
        opt_results["standardization"] = standardization
    return opt_results


def _bbvi_single(objective, approx, n_iters, init_var_param, learning_rate,
                 generator, adaptive, fixed_lr, progress_callback, RMS_kwargs,
                 FASO_kwargs, RAABBVI_kwargs):
    """The single-run leg of :func:`bbvi`."""
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
