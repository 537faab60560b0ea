"""Pathfinder: parallel quasi-Newton variational inference (counterpart of
``viabel_tpu/pathfinder.py``).

Zhang, Carpenter, Gelman, Vehtari (JMLR 2022): run L-BFGS on the log
density and, at every iterate of the path, build the local Gaussian of the
quadratic model, whose mean is the Newton-adjusted ``x_l + S_l g_l`` and
whose covariance ``S_l`` is the L-BFGS inverse-Hessian estimate in compact
diagonal-plus-low-rank form (Byrd, Nocedal, Schnabel 1994). Each candidate
is scored by a small Monte Carlo ELBO and the best one supplies the
draws. Multi-path Pathfinder runs M paths and pools their draws by
Pareto-smoothed importance resampling.

Every routine here runs M paths at once over a leading path axis, on the
device, with no host read inside the L-BFGS loop. The Armijo line search
evaluates all of its trial steps ``t0 * 2^-n``, ``n = 0..20``, in one
batched model call of ``(M * 21, d)`` rows an iteration and takes the
first that passes, or the last, as the JAX package's bounded loop of up to
20 halvings does; the accept mask, the improvement and validity masks and
the pair ring stay on the device.

Deviations from the paper, kept from the JAX package: the line search is
Armijo backtracking rather than Wolfe, and an invalid pair (curvature
``s^T y <= 0`` or a failed step) occupies a masked slot of the J-pair
window instead of being dropped.

Randomness comes through hooks, so that a test can inject the JAX
package's draws: ``base_sampler.normal(generator, n, width, dtype,
device)`` for the standard normals (the families' protocol) and
``resampler.choice(generator, p, n)`` for the resampling indices (DIS's).
"""

import math

import torch

from .objectives import _MultinomialResampler
from .psis import psislw

__all__ = ["pathfinder", "multipath_pathfinder", "pathfinder_init"]

_LOG_2PI = math.log(2.0 * math.pi)
#: the line search's halvings, as in the JAX package
_MAX_HALVINGS = 20


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _update_alpha(alpha, s, y, sy):
    """Per-coordinate diagonal inverse-Hessian update (the paper's eq. 25;
    Gilbert-Lemarechal scaling). Coordinates whose update would be
    nonpositive keep their old value. Batched over leading axes; ``sy`` has
    one axis fewer than the vectors."""
    a = _dot(y, alpha * y)[..., None]
    c = _dot(s, s / alpha)[..., None]
    sy = sy[..., None]
    denom = a / (sy * alpha) + y * y / sy - (a * s * s) / (sy * c * alpha * alpha)
    new = 1.0 / denom
    ok = torch.isfinite(new) & (new > 0.0)
    return torch.where(ok, new, alpha)


def _middle_matrix(alpha, S_w, Y_w, mask):
    """The 2J x 2J middle matrix W of the compact inverse-BFGS form ``H =
    diag(alpha) + [S, alpha*Y] W [S, alpha*Y]^T`` (Byrd, Nocedal, Schnabel
    1994, thm 2.2: R = triu(S^T Y), D its diagonal), with masked (zeroed)
    pair columns made inert: their R and D diagonal entries are 1, so R
    stays invertible while the zero columns of ``[S, alpha*Y]`` remove
    every masked contribution. ``S_w``, ``Y_w``: ``(..., d, J)``."""
    J = S_w.shape[-1]
    pad = 1.0 - mask.to(S_w.dtype)
    STY = S_w.mT @ Y_w
    R = torch.triu(STY) + torch.diag_embed(pad)
    eye = torch.eye(J, dtype=S_w.dtype, device=S_w.device).expand_as(R)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    D = torch.diag_embed(torch.diagonal(STY, dim1=-2, dim2=-1) + pad)
    YAY = Y_w.mT @ (alpha[..., :, None] * Y_w)
    M11 = Rinv.mT @ (D + YAY) @ Rinv
    top = torch.cat([M11, -Rinv.mT], dim=-1)
    bottom = torch.cat([-Rinv, torch.zeros_like(Rinv)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _hess_mul(alpha, S_w, Y_w, mask, v):
    """Compact-form inverse-Hessian product ``H v`` (O(d J)), batched."""
    W = _middle_matrix(alpha, S_w, Y_w, mask)
    B = torch.cat([S_w, alpha[..., :, None] * Y_w], dim=-1)  # (..., d, 2J)
    return alpha * v + (B @ (W @ (B.mT @ v[..., None])))[..., 0]


def _per_path(model, x):
    """``model`` at ``x (M, ..., d)``, one call a path: a path's numbers
    then do not depend on which other paths share its batch (a batched
    model product rounds by the batch's shape), so a path split over
    ranks (``multipath_pathfinder(mesh=...)``) computes what it computes
    in the whole batch."""
    return torch.stack([model(xm.reshape(-1, xm.shape[-1])).reshape(xm.shape[:-1])
                        for xm in x])


def _value_and_grad(model, x):
    """``model`` and its gradient at the rows of ``x`` (one a path)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        logp = _per_path(model, x[:, None, :])[:, 0]
        (g,) = torch.autograd.grad(torch.sum(logp), x)
    return logp.detach(), g


def _lbfgs_path(model, x0, max_iters, history, init_step, max_halvings=_MAX_HALVINGS,
                armijo_c1=1e-4):
    """L-BFGS ascent on ``model`` from the rows of ``x0`` (M paths, ``(M,
    d)``), with a fixed iteration count.

    Returns the trajectories: ``xs (M, L+1, d)``, ``gs (M, L+1, d)``,
    ``logps (M, L+1)``, ``alphas (M, L+1, d)`` (entry l is the diagonal
    estimate available at iterate l, after absorbing pair l-1) and the pair
    validity ``valid (M, L)``."""
    M, d = x0.shape
    J = history
    dtype, device = x0.dtype, x0.device
    halvings = torch.arange(max_halvings + 1, device=device)
    shrink = torch.pow(torch.tensor(0.5, dtype=dtype, device=device), halvings)
    logp, g = _value_and_grad(model, x0)
    x = x0.detach()
    alpha = torch.ones((M, d), dtype=dtype, device=device)
    S_ring = torch.zeros((M, J, d), dtype=dtype, device=device)
    Y_ring = torch.zeros((M, J, d), dtype=dtype, device=device)
    m_ring = torch.zeros((M, J), dtype=torch.bool, device=device)
    xs, gs, logps, alphas, valids = [x], [g], [logp], [alpha], []
    for k in range(max_iters):
        direction = _hess_mul(alpha, S_ring.mT, Y_ring.mT, m_ring, g)
        slope = _dot(direction, g)
        bad = (slope <= 0.0) | ~torch.all(torch.isfinite(direction), dim=-1)
        direction = torch.where(bad[:, None], alpha * g, direction)
        slope = torch.where(bad, _dot(alpha * g, g), slope)
        if k == 0:
            # the first iterate scales the raw-gradient step to init_step
            t0 = init_step / torch.clamp(torch.linalg.vector_norm(direction, dim=-1),
                                         min=1e-12)
        else:
            t0 = torch.ones((M,), dtype=dtype, device=device)
        # every trial step of the backtracking in one model call; the
        # sequential search stops at the first accepted halving, or after
        # max_halvings with the last
        ts = t0[:, None] * shrink                                # (M, 21)
        trials = x[:, None, :] + ts[..., None] * direction[:, None, :]
        with torch.no_grad():
            vals = _per_path(model, trials)
        accept = vals >= logp[:, None] + armijo_c1 * ts * slope[:, None]
        first = torch.argmax(accept.to(torch.int8), dim=-1)
        n = torch.where(torch.any(accept, dim=-1), first, max_halvings)
        rows = torch.arange(M, device=device)
        t = ts[rows, n]
        logp_try = vals[rows, n]
        x_try = x + t[:, None] * direction
        # keep the step only if it improved (a failed backtrack stays put;
        # its pair is zero and masked invalid)
        improved = (logp_try > logp) & torch.all(torch.isfinite(x_try), dim=-1)
        x_new = torch.where(improved[:, None], x_try, x)
        logp_new = torch.where(improved, logp_try, logp)
        _, g_at_new = _value_and_grad(model, x_new)
        g_new = torch.where(improved[:, None], g_at_new, g)
        s = x_new - x
        y = -(g_new - g)  # the gradient difference of f = -log p
        sy = _dot(s, y)
        valid = improved & (sy > 1e-11 * torch.linalg.vector_norm(s, dim=-1)
                            * torch.linalg.vector_norm(y, dim=-1))
        alpha = torch.where(valid[:, None],
                            _update_alpha(alpha, s, y, torch.where(valid, sy, 1.0)),
                            alpha)
        slot = k % J
        S_ring[:, slot] = torch.where(valid[:, None], s, 0.0)
        Y_ring[:, slot] = torch.where(valid[:, None], y, 0.0)
        m_ring[:, slot] = valid
        x, g, logp = x_new, g_new, logp_new
        xs.append(x)
        gs.append(g)
        logps.append(logp)
        alphas.append(alpha)
        valids.append(valid)
    return (torch.stack(xs, dim=1), torch.stack(gs, dim=1), torch.stack(logps, dim=1),
            torch.stack(alphas, dim=1), torch.stack(valids, dim=1))


def _pair_windows(xs, gs, valid, history):
    """Sliding J-pair windows over the trajectories ``(M, L+1, d)``.

    Pair i is ``(x_{i+1} - x_i, -(g_{i+1} - g_i))`` for i in [0, L). Point
    l's window is pairs ``l-J .. l-1``, masked to existing valid pairs.
    Returns ``S_w (M, L+1, d, J)``, ``Y_w (M, L+1, d, J)`` and ``mask (M,
    L+1, J)`` (point 0 has an empty window)."""
    M, L1, d = xs.shape
    J = history
    S_pairs = xs[:, 1:] - xs[:, :-1]
    Y_pairs = -(gs[:, 1:] - gs[:, :-1])
    # J zero rows in front, so that window index -J.. reads a zero row
    # even when L < J
    zpad = xs.new_zeros((M, J, d))
    S_pad = torch.cat([zpad, S_pairs], dim=1)
    Y_pad = torch.cat([zpad, Y_pairs], dim=1)
    v_pad = torch.cat([torch.zeros((M, J), dtype=torch.bool, device=xs.device), valid],
                      dim=1)
    idx = (torch.arange(L1, device=xs.device)[:, None] - J
           + torch.arange(J, device=xs.device)[None, :])          # (L+1, J)
    gather = idx + J
    mask = v_pad[:, gather] & (idx >= 0)
    # zero the masked columns, so the compact-form math sees inert slots
    S_w = S_pad[:, gather].mT * mask[:, :, None, :]
    Y_w = Y_pad[:, gather].mT * mask[:, :, None, :]
    return S_w, Y_w, mask


def _factored_gaussian(x_l, g_l, alpha, S_w, Y_w, mask):
    """The local Gaussian N(mu, Sigma) at path points (batched over leading
    axes), factored for O(d J) sampling and exact log densities:

    Sigma = A^{1/2} (I + Q E Q^T) A^{1/2} with A = diag(alpha), the thin QR
    ``A^{-1/2} [S, A Y] = Q R_q`` and the symmetric eigendecomposition ``E =
    R_q W R_q^T = P diag(lam) P^T``, so

    - log det Sigma = sum log alpha + sum log1p(lam)
    - Sigma^{1/2} z = A^{1/2} (z + Q P (sqrt(1+lam)-1) P^T Q^T z)
    - mu = x_l + Sigma g_l.

    Returns ``(mu, sqrt_a, Q, P, lam, half_logdet, ok)``; ``ok`` flags a
    positive-definite result. Q, R_q and P are defined up to signs (and,
    for a rank-deficient window, up to directions with ``lam = 0``); mu,
    lam, half_logdet, Sigma and Sigma^{1/2} z are not."""
    sqrt_a = torch.sqrt(alpha)
    V = torch.cat([S_w / sqrt_a[..., :, None], sqrt_a[..., :, None] * Y_w], dim=-1)
    Q, Rq = torch.linalg.qr(V)
    W = _middle_matrix(alpha, S_w, Y_w, mask)
    E = Rq @ W @ Rq.mT
    E = 0.5 * (E + E.mT)
    lam, P = torch.linalg.eigh(E)
    ok = torch.all(1.0 + lam > 1e-8, dim=-1) & torch.all(torch.isfinite(lam), dim=-1)
    lam = torch.clamp(lam, min=-1.0 + 1e-8)
    v1 = sqrt_a * g_l
    v2 = v1 + (Q @ (E @ (Q.mT @ v1[..., None])))[..., 0]
    mu = x_l + sqrt_a * v2
    half_logdet = 0.5 * (torch.sum(torch.log(alpha), dim=-1)
                         + torch.sum(torch.log1p(lam), dim=-1))
    return mu, sqrt_a, Q, P, lam, half_logdet, ok


def _sample_factored(q, z):
    """Draws from factored Gaussians at the base normals ``z (..., n, d)``;
    returns ``(samples, log_q)`` with exact densities at the draws."""
    mu, sqrt_a, Q, P, lam, half_logdet, _ = q
    d = mu.shape[-1]
    u = (z @ Q) @ P                                            # (..., n, 2J)
    corr = (u * (torch.sqrt(1.0 + lam) - 1.0)[..., None, :]) @ P.mT @ Q.mT
    samples = mu[..., None, :] + sqrt_a[..., None, :] * (z + corr)
    log_q = (-0.5 * torch.sum(z * z, dim=-1) - half_logdet[..., None]
             - 0.5 * d * _LOG_2PI)
    return samples, log_q


def _normal(base_sampler, generator, shape, dtype, device):
    """Standard normals of ``shape`` (leading axes flattened into one draw
    of ``prod(shape[:-1])`` rows), from the hook or the generator."""
    n = math.prod(shape[:-1])
    if base_sampler is None:
        z = torch.randn((n, shape[-1]), generator=generator, dtype=dtype, device=device)
    else:
        z = base_sampler.normal(generator, n, shape[-1], dtype, device)
    return z.reshape(shape)


def _check_model(model):
    if getattr(model, "needs_generator", False):
        raise ValueError("Pathfinder needs an exact log density; a model that "
                         "draws its own minibatch has none")


def _pathfinder_paths(model, x0, generator, *, max_iters, history, n_elbo_draws,
                      n_draws, init_step, base_sampler, rows=None):
    """M single-path Pathfinders from the rows of ``x0 (M, d)``: the L-BFGS
    paths, every point's factored Gaussian, the ELBO scoring in one model
    call, and ``n_draws`` draws from each path's best Gaussian. The ELBO
    draws come first, ``(M, L+1, n_elbo_draws, d)`` in one block, then the
    final ``(M, n_draws, d)``.

    ``rows`` (a range of the M paths) runs those paths only; the draws of
    the whole batch are made and the rows' kept, so a path sees the
    numbers it sees in the whole batch."""
    _check_model(model)
    M_all, d = x0.shape
    keep = slice(None) if rows is None else slice(rows.start, rows.stop)
    x0 = x0[keep]
    M = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    xs, gs, logps, alphas, valid = _lbfgs_path(model, x0, max_iters, history, init_step)
    S_w, Y_w, mask = _pair_windows(xs, gs, valid, history)
    qs = _factored_gaussian(xs, gs, alphas, S_w, Y_w, mask)
    ok = qs[-1]
    L1 = xs.shape[1]
    z = _normal(base_sampler, generator, (M_all, L1, n_elbo_draws, d), dtype, device)[keep]
    draws, log_q = _sample_factored(qs, z)                    # (M, L1, K, d)
    with torch.no_grad():
        log_p = _per_path(model, draws)
    elbo = torch.mean(log_p - log_q, dim=-1)
    finite = torch.all(torch.isfinite(draws.reshape(M, L1, -1)), dim=-1) \
        & torch.isfinite(elbo)
    elbo = torch.where(ok & finite, elbo, -math.inf)
    best = torch.argmax(elbo, dim=-1)                          # (M,)
    rows = torch.arange(M, device=device)
    best_q = tuple(a[rows, best] for a in qs)
    z = _normal(base_sampler, generator, (M_all, n_draws, d), dtype, device)[keep]
    samples, log_q_best = _sample_factored(best_q, z)
    with torch.no_grad():
        log_p_best = _per_path(model, samples)
    return {
        "samples": samples,
        "log_q": log_q_best,
        "log_p": log_p_best,
        "best_l": best,
        "elbo": elbo,
        "path_logps": logps,
        "mu": best_q[0],
        "q_factor": best_q,
    }


def pathfinder(model, init_point, generator=None, *, max_iters=60, history=6,
               n_elbo_draws=25, n_draws=1000, init_step=1.0, base_sampler=None):
    """Single-path Pathfinder (Zhang et al. 2022, alg. 1).

    Parameters
    ----------
    model : callable
        Log density over ``(n, dim)`` batches (a
        :class:`~viabel_torch.models.Model` or any such callable).
    init_point : (d,) tensor
        The L-BFGS start; the run lives on its device and in its dtype.
    generator : torch.Generator, optional
        Drives the draws (default: seed 0 on the start's device).
    max_iters : int
        The fixed L-BFGS iteration count L (the path has L+1 points).
    history : int
        L-BFGS memory J (covariance rank <= 2J).
    n_elbo_draws : int
        Monte Carlo draws scoring each path point's Gaussian.
    n_draws : int
        Draws returned from the ELBO-best Gaussian.
    init_step : float
        Length of the first (scaled-gradient) trial step.
    base_sampler : optional
        The standard-normal hook, ``normal(generator, n, width, dtype,
        device)``.

    Returns a dict: ``samples (n_draws, d)``, exact ``log_q`` and ``log_p``
    at the draws, ``best_l``, the per-point ``elbo (L+1,)`` (-inf where the
    local covariance was not positive definite), ``path_logps``, the
    chosen Gaussian's ``mu`` and its factored form ``q_factor`` (see
    :func:`_factored_gaussian`).
    """
    x0 = torch.as_tensor(init_point)
    if x0.dim() != 1:
        raise ValueError("init_point must be a flat (d,) vector")
    if int(max_iters) < 1 or int(history) < 1:
        raise ValueError("max_iters and history must be >= 1")
    if generator is None:
        generator = torch.Generator(x0.device).manual_seed(0)
    res = _pathfinder_paths(model, x0[None, :], generator, max_iters=int(max_iters),
                            history=int(history), n_elbo_draws=int(n_elbo_draws),
                            n_draws=int(n_draws), init_step=float(init_step),
                            base_sampler=base_sampler)
    out = {k: v[0] for k, v in res.items() if k != "q_factor"}
    out["q_factor"] = tuple(a[0] for a in res["q_factor"])
    return out


def multipath_pathfinder(model, init_points, generator=None, *, max_iters=60,
                         history=6, n_elbo_draws=25, n_draws_per_path=200,
                         n_draws=1000, resample=True, mesh=None, shard_axis=None,
                         base_sampler=None, resampler=None):
    """Multi-path Pathfinder (Zhang et al. 2022, alg. 2): M single-path runs
    from ``init_points (M, d)``, batched over the path axis, and
    Pareto-smoothed importance resampling over the pooled draws, each
    weighted by its own path's density (``log p - log q_m``).

    ``resampler`` is the hook that draws the resampling indices,
    ``choice(generator, p, n)`` (default: ``torch.multinomial`` with
    replacement).

    ``mesh=`` splits the paths over its axis ``shard_axis`` (default: the
    mesh's first axis; M must be divisible by its size): each rank runs
    its M / P paths, drawing the whole batch's base normals and keeping
    its paths' rows, and the pooled draws, ``log_p``, ``log_q`` and the
    per-path results are all-gathered before the one PSIS smoothing.
    Every rank calls with the same arguments and generator state, so
    every rank resamples alike and returns the unsharded run's results.

    Returns a dict: resampled ``samples (n_draws, d)`` (only with
    ``resample``), the pooled draws' smoothed ``log_weights``, ``khat``,
    the per-path ``elbo (M,)`` and ``best_l (M,)``, and the pooled
    ``pool_samples``, ``pool_log_p`` and ``pool_log_q``.
    """
    inits = torch.as_tensor(init_points)
    if inits.dim() != 2:
        raise ValueError("init_points must be (n_paths, d)")
    M, d = inits.shape
    paths = rows = None
    if mesh is not None:
        from .parallel.mesh import MeshAxis
        axis = shard_axis if shard_axis is not None else mesh.mesh_dim_names[0]
        if axis not in mesh.mesh_dim_names:
            raise KeyError(axis)  # the JAX package's mesh.shape[axis]
        paths = MeshAxis(mesh, axis)
        if M % paths.n:
            raise ValueError(f"n_paths={M} must be divisible by the {axis!r} axis "
                             f"size {paths.n}")
        rows = paths.rows(M)
    if generator is None:
        generator = torch.Generator(inits.device).manual_seed(0)
    res = _pathfinder_paths(model, inits, generator, max_iters=int(max_iters),
                            history=int(history), n_elbo_draws=int(n_elbo_draws),
                            n_draws=int(n_draws_per_path), init_step=1.0,
                            base_sampler=base_sampler, rows=rows)
    if paths is not None:
        res = {name: paths.gather(res[name])
               for name in ("samples", "log_p", "log_q", "elbo", "best_l")}
    pool = res["samples"].reshape(M * int(n_draws_per_path), d)
    log_p = res["log_p"].reshape(-1)
    log_q = res["log_q"].reshape(-1)
    lw = log_p - log_q
    # a diverged path's non-finite weights are -inf before smoothing
    lw = torch.where(torch.isfinite(lw), lw, -math.inf)
    lw_smoothed, khat = psislw(lw)
    out = {
        "khat": khat,
        "elbo": torch.max(res["elbo"], dim=1).values,
        "best_l": res["best_l"],
        "pool_samples": pool,
        "pool_log_p": log_p,
        "pool_log_q": log_q,
        "log_weights": lw_smoothed,
    }
    if resample:
        resampler = resampler or _MultinomialResampler()
        idx = resampler.choice(generator, torch.softmax(lw_smoothed, dim=0),
                               int(n_draws))
        out["samples"] = pool[idx]
    return out


def _family_param_from_factor(family, q):
    """Map one factored Pathfinder Gaussian onto ``family``'s flat
    variational parameter, moment-matching as much of ``Sigma = diag(alpha)
    + U diag(lam) U^T`` (``U = sqrt(alpha) * Q P``) as the family holds:

    - mean-field location-scale: the exact marginal variances;
    - Cholesky full-rank: the exact dense covariance (one d x d Cholesky);
    - LRGaussian(k): the top-k positive-curvature directions as the
      low-rank block, the rest folded into the diagonal so that
      ``diag(Sigma)`` is kept (up to a positivity clamp).

    Student-t families match the covariance, so their scale is shrunk by
    ``(df - 2) / df``.
    """
    from .families import LRGaussian, _CholeskyFamily, _MeanFieldLocScale

    mu, sqrt_a, Q, P, lam, _, _ = q
    alpha = sqrt_a * sqrt_a
    U = sqrt_a[:, None] * (Q @ P)                               # (d, 2J)
    diag_sigma = alpha + (U * U) @ lam
    df = getattr(family, "df", None)
    cov_to_scale = (df - 2.0) / df if df is not None and math.isfinite(df) else 1.0

    if isinstance(family, _MeanFieldLocScale):
        var = torch.clamp(diag_sigma * cov_to_scale, min=1e-12)
        return torch.cat([mu, 0.5 * torch.log(var)])
    if isinstance(family, _CholeskyFamily):
        Sigma = (torch.diag(alpha) + U @ (lam[:, None] * U.mT)) * cov_to_scale
        return family.pack(mu, torch.linalg.cholesky(Sigma))
    if isinstance(family, LRGaussian):
        d, k, r = family.dim, family.k, lam.shape[0]
        # descending lam: the largest positive-curvature directions are the
        # only ones B B^T can hold
        take = min(k, r)
        idx = torch.argsort(-lam)[:take]
        lam_k = torch.clamp(lam[idx], min=0.0) * cov_to_scale
        B = U[:, idx] * torch.sqrt(lam_k)
        if take < k:  # pad the unused columns
            B = torch.cat([B, B.new_zeros((d, k - take))], dim=1)
        resid = diag_sigma * cov_to_scale - torch.sum(B * B, dim=1)
        log_sigma = 0.5 * torch.log(torch.clamp(resid, min=1e-12))
        return torch.cat([mu, log_sigma, B.reshape(-1)])
    raise ValueError(
        f"pathfinder_init cannot map a Gaussian onto "
        f"{type(family).__name__}; supply init_var_param yourself")


def pathfinder_init(family, model, generator=None, *, init_point=None, n_paths=1,
                    per_path=False, init_scale=2.0, max_iters=60, history=6,
                    n_elbo_draws=25, base_sampler=None):
    """Data-driven variational initialization from Pathfinder.

    Runs ``n_paths`` single-path Pathfinders (batched over the path axis)
    from ``init_scale * N(0, I)`` starts (or the rows of ``init_point``) on
    the family's device and in its dtype, and maps the ELBO-best local
    Gaussian onto ``family``'s flat parameter: a warm start for BBVI that
    skips the mean- and scale-finding phase of the optimization.

    With ``per_path=True`` returns each path's best Gaussian as an
    ``(n_paths, D)`` tensor (a path that diverged gets the family's
    default init); otherwise the overall best as a ``(D,)`` vector.
    """
    from .families import ApproximationFamily

    if not isinstance(family, ApproximationFamily):
        raise ValueError("family must be an ApproximationFamily")
    M = int(n_paths)
    if M < 1:
        raise ValueError("n_paths must be >= 1")
    dtype, device = family.dtype, family.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    if init_point is None:
        inits = float(init_scale) * torch.randn((M, family.dim), generator=generator,
                                                dtype=dtype, device=device)
    else:
        inits = torch.atleast_2d(torch.as_tensor(init_point, dtype=dtype, device=device))
        if inits.shape != (M, family.dim):
            raise ValueError(
                f"init_point must be (n_paths, dim) = ({M}, {family.dim}) "
                f"(or (dim,) when n_paths=1); got {tuple(inits.shape)}")
    res = _pathfinder_paths(model, inits, generator, max_iters=int(max_iters),
                            history=int(history), n_elbo_draws=int(n_elbo_draws),
                            n_draws=1, init_step=1.0, base_sampler=base_sampler)
    best_elbos = torch.max(res["elbo"], dim=1).values           # (M,)

    def param_for(m):
        return _family_param_from_factor(family, tuple(a[m] for a in res["q_factor"]))

    if per_path:
        rows = []
        for m in range(M):
            row = param_for(m)
            if not bool(torch.all(torch.isfinite(row))):
                # a diverged path must not seed a restart with NaNs
                row = family.init_param()
            rows.append(row)
        return torch.stack(rows)
    if not bool(torch.any(torch.isfinite(best_elbos))):
        raise ValueError("every Pathfinder path diverged (all ELBOs "
                         "non-finite); check the model or init_scale")
    return param_for(int(torch.argmax(best_elbos)))
