"""High-level entry points ``bbvi`` and ``vi_diagnostics`` (counterpart of
``viabel_tpu/convenience.py``).

Same wiring as the JAX package: default MFGaussian family, ExclusiveKL
objective, RMSProp base optimizer, RAABBVI unless ``fixed_lr``, with
``mc_escalation=4.0`` armed on the adaptive paths; ``vi_diagnostics``
runs PSIS, then the error bounds or, past the k-hat gate, the calibrated
KSD test. A ``torch.Generator`` replaces the PRNG key. ``bbvi`` also
takes the two data-driven front routes, ``standardize=True`` (a
mean-field pilot, :func:`pilot_standardize`) and
``init_method="pathfinder"``, and the multistart route
(``num_restarts``, ``init_var_params``) through the engines of
:mod:`viabel_torch.parallel`, whose best restart
:func:`select_best_restart` picks by a common-random-numbers ELBO
estimate (:func:`elbo_estimates`).
"""

import math

import numpy as np
import torch

from .diagnostics import all_diagnostics, ksd_test
from .faso import FASO, RAABBVI
from .families import MFGaussian
from .models import Model
from .objectives import ExclusiveKL
from .optimizers import RMSProp, default_generator
from .psis import psislw
from .tracing import span

__all__ = ["bbvi", "vi_diagnostics", "elbo_estimates", "select_best_restart",
           "psis_correction", "samples_and_log_weights", "pilot_standardize"]


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
    # the lambda hides the model's own statement (GraphSafety) from the objective
    std_model.graph_safe = model.graph_refusal() is None
    return std_model, spec, res


def bbvi(dimension, *, n_iters=10000, num_mc_samples=10, log_density=None,
         approx=None, objective=None, fit=None, adaptive=True, fixed_lr=False,
         init_var_param=None, learning_rate=0.01, generator=None,
         progress_callback=None, num_restarts=None, init_var_params=None,
         init_jitter=0.0, init_method=None, pathfinder_kwargs=None,
         multistart_kwargs=None, standardize=False, pilot_kwargs=None,
         RMS_kwargs=None, FASO_kwargs=None, RAABBVI_kwargs=None, device="cuda",
         dtype=None):
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
    max_iters=40)``). With ``num_restarts=B`` it runs B paths and starts
    every restart from its own path's Gaussian.

    Multistart: ``num_restarts=B`` (or a 2-D ``init_var_params`` of shape
    ``(B, D)``) runs B restarts in lockstep on the same route matrix:
    ``parallel.multistart_raabbvi`` (adaptive), ``parallel.multistart_faso``
    (adaptive and ``fixed_lr``) or ``parallel.multistart_optimize`` (plain).
    ``learning_rate`` may be a shape-``(B,)`` array on the two adaptive
    routes. With ``num_restarts`` alone the restarts share one init and
    differ in their draws; ``init_jitter=sigma`` adds ``sigma * N(0, I)``
    to restarts 1..B-1 (restart 0 keeps the base init exactly). Engine
    keywords (``rho=``, ``round_callback=``, ...) go in
    ``multistart_kwargs``. ``opt_param`` is the best restart's optimum,
    picked by :func:`select_best_restart`, beside ``opt_params`` (B, D),
    ``best_restart``, ``restart_elbos``, ``init_var_params`` and the
    engine's per-restart results. ``generator`` draws the jitter, seeds
    one generator a restart (a single restart draws from it directly) and
    then draws the selection's common base draws.

    Standardization: ``standardize=True`` runs the :func:`pilot_standardize`
    mean-field pilot (tune with ``pilot_kwargs``), optimizes against the
    pilot-standardized target, and folds the affine back into the
    family's parameters in closed form (``fold_affine``), so the returned
    ``opt_param`` (and a multistart run's ``opt_params``) and the results'
    ``objective`` live in the user's coordinates. The family needs
    ``fold_affine`` (every location-scale family has it; NeuralNet and
    NVPFlow do not). An explicit ``init_var_param`` or ``init_var_params``
    is read in the user's coordinates and unfolded for the run; a
    multistart run's ``init_var_params`` and ``restart_elbos`` stay in
    pilot coordinates. ``results["standardization"]`` holds ``affine=(p_mu,
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
    with span("viabel.bbvi"):
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
            # explicit inits arrive in the user's coordinates; the inverse
            # affine is itself an affine
            inv = (-p_mu / p_scale, 1.0 / p_scale)
            if init_var_param is not None:
                init_var_param = approx.fold_affine(init_var_param, *inv)
            if init_var_params is not None:
                init_var_params = torch.stack([
                    approx.fold_affine(vp, *inv) for vp in torch.as_tensor(
                        init_var_params, dtype=approx.dtype, device=approx.device)])
        elif pilot_kwargs is not None:
            raise ValueError("pilot_kwargs needs standardize=True")
        try:
            if init_method is not None:
                if init_method != "pathfinder":
                    raise ValueError(f"unknown init_method {init_method!r}; the one "
                                     "built-in data-driven initializer is 'pathfinder'")
                if init_var_param is not None or init_var_params is not None:
                    raise ValueError("init_method='pathfinder' computes the init; "
                                     "drop init_var_param(s)")
                from .pathfinder import pathfinder_init
                pf_kwargs = dict(pathfinder_kwargs or {})
                if num_restarts is not None:
                    # one path a restart: distinct data-driven basins
                    pf_kwargs.setdefault("n_paths", int(num_restarts))
                    init_var_params = pathfinder_init(approx, model, generator,
                                                      per_path=True, **pf_kwargs)
                else:
                    init_var_param = pathfinder_init(approx, model, generator, **pf_kwargs)
            elif pathfinder_kwargs is not None:
                raise ValueError("pathfinder_kwargs needs init_method='pathfinder'")
            if num_restarts is not None or init_var_params is not None:
                opt_results = _bbvi_multistart(
                    objective, approx, n_iters, num_restarts, init_var_params,
                    init_var_param, init_jitter, learning_rate, generator, adaptive,
                    fixed_lr, progress_callback, multistart_kwargs, RMS_kwargs,
                    FASO_kwargs, RAABBVI_kwargs)
            else:
                opt_results = _bbvi_single(objective, approx, n_iters, init_var_param,
                                           init_jitter, learning_rate, generator, adaptive,
                                           fixed_lr, progress_callback, RMS_kwargs,
                                           FASO_kwargs, RAABBVI_kwargs)
        finally:
            if standardization is not None:
                # the results' objective diagnoses the user's target (a
                # prebuilt objective is restored on an error as well)
                objective.model = orig_model
        if standardization is not None:
            if "opt_params" in opt_results:
                opt_results["opt_params"] = torch.stack([
                    approx.fold_affine(vp, p_mu, p_scale) for vp in opt_results["opt_params"]])
                opt_results["opt_param"] = opt_results["opt_params"][opt_results["best_restart"]]
            else:
                opt_results["opt_param"] = approx.fold_affine(opt_results["opt_param"],
                                                              p_mu, p_scale)
            opt_results["standardization"] = standardization
        return opt_results


def _bbvi_single(objective, approx, n_iters, init_var_param, init_jitter,
                 learning_rate, generator, adaptive, fixed_lr, progress_callback,
                 RMS_kwargs, FASO_kwargs, RAABBVI_kwargs):
    """The single-run leg of :func:`bbvi`."""
    if init_jitter:
        raise ValueError("init_jitter only applies to a multistart run: "
                         "pass num_restarts")
    if np.ndim(learning_rate) != 0:
        raise ValueError("a per-restart learning_rate array needs a "
                         "multistart run: pass num_restarts")
    if init_var_param is None:
        init_var_param = approx.init_param()
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


def _bbvi_multistart(objective, approx, n_iters, num_restarts, init_var_params,
                     init_var_param, init_jitter, learning_rate, generator, adaptive,
                     fixed_lr, progress_callback, multistart_kwargs, RMS_kwargs,
                     FASO_kwargs, RAABBVI_kwargs):
    """The multistart leg of :func:`bbvi`."""
    # the engines report progress through their own hooks
    # (multistart_raabbvi's round_callback, through multistart_kwargs)
    if progress_callback is not None:
        raise ValueError(
            "progress_callback is not supported with num_restarts; for the "
            "adaptive path pass multistart_kwargs=dict(round_callback=...)")
    from .parallel import multistart_faso, multistart_optimize, multistart_raabbvi
    multistart_kwargs = dict(multistart_kwargs or {})

    if init_var_params is None:
        base = approx.init_param() if init_var_param is None else init_var_param
        if num_restarts is None or int(num_restarts) < 1:
            raise ValueError("num_restarts must be a positive integer")
        base = torch.as_tensor(base, dtype=approx.dtype, device=approx.device)
        init_var_params = base[None].repeat(int(num_restarts), 1)
        if init_jitter:
            noise = float(init_jitter) * torch.randn(
                init_var_params.shape, generator=generator, dtype=approx.dtype,
                device=approx.device)
            # restart 0 keeps the user's base init exactly
            noise[0] = 0.0
            init_var_params = init_var_params + noise
    elif init_jitter:
        raise ValueError("init_jitter only applies when restarts are tiled "
                         "from one base init; with explicit init_var_params "
                         "perturb them yourself")
    else:
        init_var_params = torch.as_tensor(init_var_params, dtype=approx.dtype,
                                          device=approx.device)
        if init_var_params.dim() != 2:
            raise ValueError("init_var_params must have shape (num_restarts, "
                             f"var_param_dim); got {tuple(init_var_params.shape)}")
        if num_restarts is not None and int(num_restarts) != init_var_params.shape[0]:
            raise ValueError(
                f"num_restarts={num_restarts} disagrees with "
                f"init_var_params.shape[0]={init_var_params.shape[0]}")
    B = init_var_params.shape[0]

    lr = np.asarray(learning_rate, dtype=float)
    if lr.ndim not in (0, 1) or (lr.ndim == 1 and lr.shape[0] != B):
        raise ValueError("learning_rate must be a scalar or a shape-"
                         f"({B},) per-restart array; got shape {lr.shape}")
    # the engines take the per-restart rates from the array; the rule still
    # needs one scalar rate (the array's stand-in)
    sgo = RMSProp(float(lr.mean()), **RMS_kwargs)
    lr_kwarg = lr if lr.ndim == 1 else None

    def _arm_default_escalation(kwargs):
        # the single-run routes' defaults-must-converge rationale
        if ("mc_escalation" not in kwargs
                and getattr(objective, "num_mc_samples", None) is not None):
            kwargs["mc_escalation"] = 4.0
        return kwargs

    if adaptive and not fixed_lr:
        kwargs = {**RAABBVI_kwargs, **multistart_kwargs}
        # a single-run kwarg for the coordinate-sharding knob; the
        # multistart engines do not take it
        kwargs.pop("shard_axis", None)
        results = multistart_raabbvi(sgo, n_iters, objective, init_var_params, generator,
                                     learning_rate=lr_kwarg,
                                     **_arm_default_escalation(kwargs))
    elif adaptive and fixed_lr:
        kwargs = {**FASO_kwargs, **multistart_kwargs}
        kwargs.pop("shard_axis", None)
        results = multistart_faso(sgo, n_iters, objective, init_var_params, generator,
                                  learning_rate=lr_kwarg,
                                  **_arm_default_escalation(kwargs))
    elif not adaptive and fixed_lr:
        if lr_kwarg is not None:
            raise ValueError("a per-restart learning_rate grid needs the "
                             "adaptive paths (convergence detection); the "
                             "plain multistart uses one shared rate")
        results = multistart_optimize(sgo, n_iters, objective, init_var_params,
                                      generator, **multistart_kwargs)
    else:
        raise ValueError("a decaying learning rate needs the adaptive "
                         "optimizer: set adaptive=True or fixed_lr=True")

    opt_params = results["opt_param"]
    best, scores = select_best_restart(opt_params, objective=objective,
                                       generator=generator)
    results["init_var_params"] = init_var_params
    results["opt_params"] = opt_params
    results["opt_param"] = opt_params[best]
    results["best_restart"] = best
    results["restart_elbos"] = scores
    results["objective"] = objective
    return results


class _CommonDraws:
    """A family's base sampler that draws one block (through ``inner``)
    and hands that same block to every later call."""

    def __init__(self, inner):
        self.inner, self.block = inner, None

    def normal(self, generator, n_samples, width, dtype, device):
        if self.block is None:
            self.block = self.inner.normal(generator, n_samples, width, dtype, device)
        return self.block


def elbo_estimates(var_params, *, objective=None, model=None, approx=None,
                   num_mc_samples=1000, generator=None):
    """A fresh Monte Carlo ELBO estimate for each row of ``var_params``
    ``(B, D)``.

    Every restart is scored on the same base draws (common random
    numbers), so the comparison is paired: each row starts from the same
    state of ``generator`` (default: seed 0 on the family's device), and a
    family's injected ``base_sampler`` is asked once, its block reused for
    every row; afterwards ``generator`` continues from where one row's
    draws left it. Uses the closed-form entropy when the family has one
    (``E_q[log p] + H(q)``), else the sampled ``E_q[log p - log q]``.
    """
    if objective is not None:
        if model is not None or approx is not None:
            raise ValueError("an objective already carries its model and "
                             "family; drop the model/approx arguments")
        model = objective.model
        approx = objective.approx
    elif model is None or approx is None:
        raise ValueError("supply an objective, or a model together with an approx")
    var_params = torch.as_tensor(var_params)
    if var_params.dim() != 2:
        raise ValueError("var_params must have shape (n_restarts, "
                         f"var_param_dim); got {tuple(var_params.shape)}")
    if var_params.shape[0] == 0:
        # no restart to score: nothing is drawn
        return var_params.new_zeros((0,))
    if generator is None:
        generator = default_generator(approx.device)
    n = int(num_mc_samples)
    fused = getattr(approx, "sample_and_log_density", None)

    def one(vp, g):
        if approx.supports_entropy:
            return torch.mean(model(approx.sample(vp, n, g))) + approx.entropy(vp)
        if fused is not None:
            # e.g. square NeuralNet pushforwards: an exact density only
            # jointly with the sample
            samples, log_q = fused(vp, n, g)
        else:
            samples = approx.sample(vp, n, g)
            log_q = approx.log_density(vp, samples)
        return torch.mean(model(samples) - log_q)

    if not approx.supports_entropy:
        # probe density support on a known-good parameter with a throwaway
        # generator, so that a capability gap is diagnosed as such while
        # errors from the user's var_params propagate raw below
        try:
            probe = torch.Generator(approx.device).manual_seed(0)
            if fused is not None:
                fused(approx.init_param(), 2, probe)
            else:
                approx.log_density(approx.init_param(),
                                   approx.sample(approx.init_param(), 2, probe))
        except (NotImplementedError, ValueError) as exc:
            raise ValueError(
                f"{type(approx).__name__} supports neither closed-form "
                "entropy nor a sample log density, so restarts cannot be "
                "ELBO-scored; select a restart yourself (e.g. by a fresh "
                "objective loss)") from exc
    inner = approx.base_sampler
    if inner is not None:
        approx._base_sampler = _CommonDraws(inner)
    start, after, scores = generator.get_state(), None, []
    try:
        for vp in var_params.detach():
            generator.set_state(start)
            scores.append(one(vp, generator).detach())
            if after is None:
                after = generator.get_state()
    finally:
        if inner is not None:
            approx._base_sampler = inner
    generator.set_state(after)
    return torch.stack(scores)


def select_best_restart(var_params, *, objective=None, model=None, approx=None,
                        num_mc_samples=1000, generator=None):
    """The highest-ELBO row of ``var_params`` ``(B, D)``.

    Returns ``(best_index, elbo_scores)``; non-finite scores (a diverged
    restart) lose to any finite one. See :func:`elbo_estimates` for the
    scoring rule.
    """
    scores = elbo_estimates(var_params, objective=objective, model=model,
                            approx=approx, num_mc_samples=num_mc_samples,
                            generator=generator)
    finite = torch.isfinite(scores)
    if not bool(torch.any(finite)):
        raise ValueError("every restart's ELBO estimate is non-finite; "
                         "nothing to select")
    return int(torch.argmax(torch.where(finite, scores, -torch.inf))), scores


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
    with span("viabel.vi_diagnostics"):
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

                with span("viabel.diag.ksd"):
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
        with span("viabel.diag.moments"):
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
    with span("viabel.diag.psis"):
        smoothed_log_weights, khat = psislw(log_weights)
    return samples.T, smoothed_log_weights, khat


def samples_and_log_weights(var_param, model, approx, n_samples, generator):
    """Draw q samples and compute ``log p - log q``."""
    with span("viabel.diag.log_weights"):
        samples = approx.sample(var_param, int(n_samples), generator)
        log_weights = model(samples) - approx.log_density(var_param, samples)
    return samples, log_weights
