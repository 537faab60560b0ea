"""Posterior-error diagnostics: divergence, Wasserstein and moment bounds,
and the kernelized Stein discrepancy (counterpart of
``viabel_tpu/diagnostics.py``; Huggins et al., AISTATS 2020).

Formulas are the JAX package's. Where it draws with a PRNG key, the port
takes a ``torch.Generator``; its ``lax.map`` over row blocks is a Python
loop over blocks, and a model's score is ``torch.autograd.grad`` of the
summed log density.
"""

from warnings import warn

import torch

__all__ = ["all_diagnostics", "error_bounds", "wasserstein_bounds",
           "divergence_bound", "ksd", "ksd_test"]

_INF = float("inf")


def _tensor(x):
    """A tensor as it is; a Python number or array as float64."""
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)


def _centered(samples):
    samples = _tensor(samples)
    if samples.dim() == 1:
        samples = samples[:, None]
    return samples - torch.mean(samples, dim=0, keepdim=True)


def all_diagnostics(log_weights, *, samples=None, moment_bound_fn=None,
                    q_var=None, p_var=None, log_norm_bound=None):
    """All VI diagnostics from ``log_weights = log p(x_i) - log q(x_i)``,
    ``x_i ~ q`` (``p`` may be unnormalized). Returns a dict with
    ``mean_error``, ``std_error``, ``cov_error``, ``W1``, ``W2``, ``d2``,
    ``log_norm_bound``."""
    d2, log_norm_bound = divergence_bound(
        log_weights, log_norm_bound=log_norm_bound, return_log_norm_bound=True)
    results = wasserstein_bounds(d2, samples=samples, moment_bound_fn=moment_bound_fn)
    if q_var is None and samples is not None:
        centered = _centered(samples)
        q_var = centered.T @ centered / (centered.shape[0] - 1)
    results.update(error_bounds(q_var=q_var, p_var=p_var, **results))
    results["d2"] = d2
    results["log_norm_bound"] = log_norm_bound
    return results


def _compute_norm_if_needed(var):
    if var is None:
        return _tensor(_INF)
    var = _tensor(var)
    if var.dim() == 2:
        # spectral norm for matrix (co)variances
        return torch.linalg.matrix_norm(var, ord=2)
    return var


def error_bounds(*, W1=_INF, W2=_INF, q_var=_INF, p_var=_INF):
    """Mean, standard-deviation and covariance error bounds from
    Wasserstein bounds."""
    W1, W2 = _tensor(W1), _tensor(W2)
    return {"mean_error": mean_bound(torch.minimum(W1, W2)),
            "std_error": std_bound(W2),
            "cov_error": var_bound(W2, _compute_norm_if_needed(q_var),
                                   _compute_norm_if_needed(p_var))}


def wasserstein_bounds(d2, *, samples=None, moment_bound_fn=None):
    """1- and 2-Wasserstein bounds from a 2-divergence bound:
    ``W_p <= 2 C_p^{1/2p} expm1(d2)^{1/2p}``."""
    if moment_bound_fn is None:
        if samples is None:
            raise ValueError("wasserstein_bounds needs the centered moments: "
                             "pass a moment_bound_fn, or samples to estimate "
                             "them from")
        centered = _centered(samples)

        def moment_bound_fn(p):
            return torch.mean(torch.sum(centered**p, dim=1))

    d2 = _tensor(d2)
    return {f"W{p}": 2.0 * moment_bound_fn(2 * p) ** (0.5 / p)
            * torch.expm1(d2) ** (0.5 / p) for p in (1, 2)}


def divergence_bound(log_weights, *, alpha=2.0, log_norm_bound=None,
                     return_log_norm_bound=False):
    """Bound on the alpha-divergence: ``alpha/(alpha-1) * (CUBO - ELBO)``."""
    if alpha <= 1:
        raise ValueError("the alpha-divergence bound needs alpha > 1 "
                         f"(got {alpha})")
    log_weights = _tensor(log_weights)
    log_rescale = torch.max(log_weights)
    rescaled = torch.exp(log_weights - log_rescale) ** alpha
    mean_rescaled = mean_and_check_mc_error(rescaled, quantity_name="CUBO")
    cubo = torch.log(mean_rescaled) / alpha + log_rescale
    if log_norm_bound is None:
        log_norm_bound = mean_and_check_mc_error(log_weights, quantity_name="ELBO")
    dalpha = alpha / (alpha - 1.0) * (cubo - log_norm_bound)
    if return_log_norm_bound:
        return dalpha, log_norm_bound
    return dalpha


def mean_and_check_mc_error(a, atol=0.01, rtol=0.0, quantity_name=None):
    """Mean, with a warning when its Monte Carlo standard error is large."""
    a = _tensor(a)
    m = torch.mean(a)
    s = torch.std(a, correction=0) / a.numel() ** 0.5
    if float(s) > rtol * abs(float(m)) + atol:
        what = quantity_name if quantity_name is not None else "a mean"
        warn(f"the Monte Carlo error of {what} is large (estimate {float(m)}, "
             f"MC standard error {float(s)}); draw more samples")
    return m


def mean_bound(Wp):
    return Wp


def std_bound(W2):
    return W2


def var_bound(W2, var1, var2=None):
    min_var = var1 if var2 is None else torch.minimum(var1, var2)
    return 2.0 * (torch.sqrt(min_var) * W2 + W2**2)


def _ksd_core(x, s, *, c, beta, use_u_statistic, block_size):
    """Signed squared KSD statistic (U or V) from samples and scores."""
    n, d = x.shape
    sq_norm = torch.sum(x * x, dim=-1)
    xs_dot = torch.sum(x * s, dim=-1)

    def row_block(xb, sb, sqb, xsb):
        # pairwise pieces for these rows against all columns, from Gram
        # products (no (n, n, d) intermediate)
        r2 = torch.clamp(sqb[:, None] + sq_norm[None, :] - 2.0 * (xb @ x.T), min=0.0)
        base = c * c + r2
        pow1 = base ** (beta - 1.0)
        pow2 = base ** (beta - 2.0)
        # trace(grad_x grad_y k) = -2 beta [d pow1 + 2 (beta - 1) pow2 r2]
        trace_term = -2.0 * beta * (d * pow1 + 2.0 * (beta - 1.0) * pow2 * r2)
        ss = (sb @ s.T) * base**beta
        sx_dot_diff = xsb[:, None] - sb @ x.T    # s(x) . (x - y)
        sy_dot_diff = xb @ s.T - xs_dot[None, :]  # s(y) . (x - y)
        cross = 2.0 * beta * pow1 * (sy_dot_diff - sx_dot_diff)
        return torch.sum(trace_term + ss + cross, dim=-1)

    if block_size is None:
        row_sums = row_block(x, s, sq_norm, xs_dot)
    else:
        if n % block_size:
            raise ValueError("block_size must divide the sample count")
        b = int(block_size)
        row_sums = torch.cat([row_block(x[i:i + b], s[i:i + b], sq_norm[i:i + b],
                                        xs_dot[i:i + b]) for i in range(0, n, b)])
    total = torch.sum(row_sums)
    if use_u_statistic:
        # drop the diagonal u_p(x_i, x_i), the r2 = 0 terms
        diag = (-2.0 * beta * d * c ** (2.0 * (beta - 1.0))
                + c ** (2.0 * beta) * torch.sum(s * s, dim=-1))
        return (total - torch.sum(diag)) / (float(n) * float(n - 1))
    return total / (float(n) * float(n))


def _draw_pairs(generator, n, m, device):
    """``m`` uniform ordered pairs ``i != j`` of ``range(n)``: ``j = i +
    offset mod n`` with ``offset`` in ``[1, n)``."""
    i = torch.randint(0, n, (m,), generator=generator, device=device)
    off = torch.randint(1, n, (m,), generator=generator, device=device)
    return i, (i + off) % n


def _ksd_pairs_core(x, s, i, j, *, c, beta, chunk=None):
    """Incomplete U-statistic: the Stein-kernel mean over the ordered pairs
    ``(i, j)``, gathered ``chunk`` pairs at a time in bounded memory."""
    d = x.shape[1]
    m = i.shape[0]
    if chunk is None:
        chunk = min(m, max(256, (1 << 22) // max(d, 1)))
    total = 0.0
    for start in range(0, m, chunk):
        ii, jj = i[start:start + chunk], j[start:start + chunk]
        si, sj = s[ii], s[jj]
        diff = x[ii] - x[jj]
        r2 = torch.sum(diff * diff, dim=-1)
        base = c * c + r2
        pow1 = base ** (beta - 1.0)
        pow2 = base ** (beta - 2.0)
        trace = -2.0 * beta * (d * pow1 + 2.0 * (beta - 1.0) * pow2 * r2)
        ss = torch.sum(si * sj, dim=-1) * base**beta
        cross = 2.0 * beta * pow1 * (torch.sum(sj * diff, dim=-1)
                                     - torch.sum(si * diff, dim=-1))
        total = total + torch.sum(trace + ss + cross)
    return total / float(m)


def _batched_score(score_fn, model):
    if (score_fn is None) == (model is None):
        raise ValueError("pass exactly one of score_fn / model")
    if score_fn is not None:
        return score_fn

    def score(x):
        # sum-then-grad gives every per-sample score in one backward pass
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            return torch.autograd.grad(torch.sum(model(xx)), xx)[0]

    return score


def ksd(samples, *, score_fn=None, model=None, c=1.0, beta=-0.5,
        use_u_statistic=True, block_size=None, squared=False,
        subsample_pairs=None, generator=None):
    """Kernelized Stein discrepancy between ``samples`` ``(n, d)`` and a
    target, with the inverse multiquadric kernel ``k(x, y) = (c^2 + ||x -
    y||^2)^beta`` (Gorham & Mackey, ICML 2017).

    Exactly one of ``score_fn`` (batched score ``(n, d) -> (n, d)``) or
    ``model`` (batched log density; its score is taken by autograd) names
    the target. ``block_size`` (dividing ``n``) bounds the pairwise work
    to ``block_size x n`` at a time. ``squared`` returns the signed squared
    statistic :func:`ksd_test` calibrates. ``subsample_pairs=m`` takes the
    incomplete U-statistic over ``m`` pairs drawn from ``generator``.
    Returns ``sqrt(max(KSD^2, 0))`` or the signed square.
    """
    x = torch.atleast_2d(_tensor(samples))
    n = x.shape[0]
    if use_u_statistic and n < 2:
        raise ValueError("the U-statistic KSD needs n >= 2 samples "
                         f"(got {n}); use use_u_statistic=False")
    s = _batched_score(score_fn, model)(x)
    if subsample_pairs is not None:
        if not use_u_statistic:
            raise ValueError("subsample_pairs is an incomplete U-statistic; "
                             "it has no V-statistic form")
        if generator is None:
            raise ValueError("subsample_pairs needs a generator")
        i, j = _draw_pairs(generator, n, int(subsample_pairs), x.device)
        stat = _ksd_pairs_core(x, s, i, j, c=c, beta=beta)
    else:
        stat = _ksd_core(x, s, c=c, beta=beta, use_u_statistic=use_u_statistic,
                         block_size=block_size)
    if squared:
        return stat
    return torch.sqrt(torch.clamp(stat, min=0.0))


def ksd_test(samples, *, score_fn=None, model=None, null_sampler,
             null_score_fn, generator, n_null=19, c=1.0, beta=-0.5,
             block_size=None, subsample_pairs=None):
    """Calibrated KSD goodness-of-fit test: is ``samples ~ target``?

    Under q = p the observed statistic (q-draws scored by the target) and
    ``n_null`` replicates (fresh q-draws from ``null_sampler(generator)``
    scored by ``null_score_fn``, q's own score) are exchangeable, so
    ``p_value = (1 + #{null >= observed}) / (n_null + 1)`` is exact.
    Returns ``ksd``, ``ksd_squared``, ``null_squared`` ``(n_null,)``,
    ``p_value``, ``reject`` and ``valid`` (False when a statistic is not
    finite: then the test is invalid, not a rejection).
    """
    x = torch.atleast_2d(_tensor(samples))
    common = dict(c=c, beta=beta, squared=True, block_size=block_size,
                  subsample_pairs=subsample_pairs, generator=generator)
    obs = ksd(x, score_fn=score_fn, model=model, **common)
    nulls = torch.stack([ksd(null_sampler(generator), score_fn=null_score_fn,
                             **common) for _ in range(int(n_null))])
    finite = bool(torch.isfinite(obs)) and bool(torch.all(torch.isfinite(nulls)))
    if finite:
        n_ge = int(torch.sum(nulls >= obs))
        p_value = (1.0 + n_ge) / (int(n_null) + 1.0)
        reject = n_ge == 0
    else:
        p_value = float("nan")
        reject = False
    return {"ksd": torch.sqrt(torch.clamp(obs, min=0.0)), "ksd_squared": obs,
            "null_squared": nulls, "p_value": p_value, "reject": reject,
            "valid": finite}
