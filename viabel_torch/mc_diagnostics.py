"""Convergence statistics: ESS, MCSE and split-R-hat
(counterpart of ``viabel_tpu/mc_diagnostics.py``).

Two layers:

1. Windowed statistics over an ordered history buffer ``(R, D)`` whose
   trailing ``w`` rows form the analysis window
   (:func:`ess_and_mcse_windowed`, :func:`split_rhat_windowed`).
   PyTorch runs eagerly and ``w`` is a host integer, so the window is a
   slice where the JAX package masks a fixed shape.
2. Ring statistics over FASO's circular history ring, a plain ``(R, D)``
   tensor in which slot ``s % R`` holds step ``s``: one group-statistics
   pass (:func:`viabel_torch.ops.ring_group_stats`, a CUDA kernel on the
   GPU) and cumulative sums of its group rows give every candidate
   window's half-chain moments.

The ESS estimator is Geyer's initial-positive + initial-monotone sequence
on FFT autocovariances, in the vectorized cumulative form of the JAX
package (``_ess_chunk_vectorized``).
"""

import numpy as np
import torch

from .ops.ringstats import ring_group_stats

__all__ = ["autocov", "ess_and_mcse_windowed", "split_rhat_windowed",
           "ring_cum_stats", "split_rhat_ring_windows", "ring_window_mean",
           "ess", "MCSE", "compute_R_hat", "rank_normalized_R_hat",
           "R_hat_convergence_check"]


def _fft_len(n):
    """FFT length >= 2n (a power of two)."""
    return int(2 ** np.ceil(np.log2(max(2 * n, 2))))


def autocov(samples, axis=-1):
    """FFT-based autocovariance for every lag."""
    n = samples.shape[axis]
    m = _fft_len(n)
    centered = samples - samples.mean(dim=axis, keepdim=True)
    f = torch.fft.rfft(centered, n=m, dim=axis)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=axis)
    return acov.narrow(axis, 0, n) / n


def _ess_chunk(x):
    """Geyer ESS for a chunk of coordinates at once.

    ``x``: ``(C, n)`` rows as coordinates, all ``n`` columns in the
    window. The initial-positive sequence is the prefix of pairs with
    positive sums, the initial-monotone adjustment a running minimum of
    pair sums, and tau needs only the cumulative-min pair sums plus one
    boundary element.
    """
    C, n = x.shape
    xc = x - x.mean(dim=1, keepdim=True)
    m = _fft_len(n)
    f = torch.fft.rfft(xc, n=m, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=1)[:, :n] / n

    mean_var = acov[:, :1] * n / (n - 1.0)
    var_plus = acov[:, :1]
    rho = 1.0 - (mean_var - acov) / var_plus
    rho[:, 0] = 1.0

    K = n // 2
    P = rho[:, 0:2 * K:2] + rho[:, 1:2 * K:2]           # pair sums (C, K)
    kidx = torch.arange(K, device=x.device)
    B = (n - 2) // 2                                     # last computable pair
    # first pair k >= 1 whose sum fails strict positivity
    fail = (kidx[None, :] >= 1) & ~(P > 0.0)
    first_fail = torch.where(fail, kidx[None, :], K + 1).min(dim=1).values
    k_last = torch.clamp(first_fail, max=B)              # (C,)

    M = torch.cummin(P, dim=1).values                    # monotone pair sums
    sum_pairs = torch.where(kidx[None, :] < k_last[:, None], M, 0.0).sum(dim=1)
    rho_even_last = rho.gather(1, (2 * k_last)[:, None])[:, 0]
    P_last = P.gather(1, torch.clamp(k_last, max=K - 1)[:, None])[:, 0]
    extra = torch.where((rho_even_last > 0.0) | (P_last >= 0.0),
                        rho_even_last, 0.0)
    tau = -1.0 + 2.0 * sum_pairs + extra
    tau = torch.clamp(tau, min=1.0 / np.log10(n))
    eff = n / tau
    return torch.where(torch.isnan(rho).any(dim=1), torch.nan, eff)


def ess_and_mcse_windowed(history, w, chunk_size=8192):
    """Per-coordinate ESS and MCSE over the trailing ``w`` rows of
    ``history`` (``(R, D)``, oldest row first). Returns ``(ess, mcse)``,
    each ``(D,)``; coordinates are processed ``chunk_size`` at a time
    (the FFT scratch at full width is O(D * fft_len))."""
    w = int(w)
    window = history[history.shape[0] - w:]
    xt = window.T
    eff = torch.cat([_ess_chunk(xt[i:i + chunk_size])
                     for i in range(0, xt.shape[0], chunk_size)])
    mean = window.sum(dim=0) / w
    var = ((window - mean) ** 2).sum(dim=0) / (w - 1.0)
    return eff, torch.sqrt(var) / torch.sqrt(eff)


def ess(samples):
    """ESS of a single chain given as ``(1, n)`` (or ``(n,)``), the
    reference's signature."""
    samples = torch.atleast_2d(torch.as_tensor(samples))
    return _ess_chunk(samples[:1])[0]


def MCSE(samples):
    """Per-coordinate ``(ESS, MCSE)`` of ``(n_iters, D)`` samples."""
    samples = torch.as_tensor(samples)
    return ess_and_mcse_windowed(samples, samples.shape[0])


def split_rhat_windowed(history, w, jitter=1e-8):
    """Split-R-hat per coordinate over the trailing ``w`` rows of
    ``history``: two half-chains of ``h = w // 2`` rows (the most recent
    iterate is dropped when ``w`` is odd)."""
    w = int(w)
    h = w // 2
    start = history.shape[0] - w

    def half_stats(x):
        mean = x.sum(dim=0) / h
        return mean, ((x - mean) ** 2).sum(dim=0) / (h - 1.0)

    mean1, var1 = half_stats(history[start:start + h])
    mean2, var2 = half_stats(history[start + h:start + 2 * h])
    grand = (mean1 + mean2) / 2.0
    B = h * ((mean1 - grand) ** 2 + (mean2 - grand) ** 2)
    W = (var1 + var2) / 2.0 + jitter
    return torch.sqrt((h - 1.0) / h + B / (h * W))


def ring_cum_stats(ring, t, group):
    """Cumulative group statistics of the ring, centered at the newest
    iterate (an uncentered one-pass sum of squares would cancel
    catastrophically in float32 near stationarity).

    ``ring``: ``(R, D)`` circular buffer (slot ``s % R`` holds step ``s``)
    with ``R % group == 0``; ``t``: total steps taken. Returns a dict:
    ``cumS``/``cumQ`` ``(R // group + 1, D)`` exclusive cumulative group
    sums, ``P1eS``/``P1eQ`` the sums over slots ``< t % R``, ``center``.
    """
    R = ring.shape[0]
    t = int(t)
    center = ring[(t - 1) % R]
    GS, GQ = ring_group_stats(ring, center, group)
    zero = torch.zeros_like(GS[:1])
    cumS = torch.cat([zero, torch.cumsum(GS, dim=0)])
    cumQ = torch.cat([zero, torch.cumsum(GQ, dim=0)])
    s1e = t % R
    ge = s1e // group
    xb = ring[ge * group:s1e] - center
    return {"cumS": cumS, "cumQ": cumQ,
            "P1eS": cumS[ge] + xb.sum(dim=0),
            "P1eQ": cumQ[ge] + (xb * xb).sum(dim=0),
            "center": center, "t": t, "R": R}


def _arcs(stats, bounds, group):
    """Sums of centered values/squares over steps ``[b, t)`` for each
    group-aligned boundary ``b`` in ``bounds`` (``t - b <= R``)."""
    R, t = stats["R"], stats["t"]
    s0 = bounds % R
    device = stats["cumS"].device
    g0 = torch.as_tensor(s0 // group, device=device)
    P0S, P0Q = stats["cumS"][g0], stats["cumQ"][g0]
    wrapped = torch.as_tensor((s0 >= t % R) & (bounds < t), device=device)[:, None]
    aS = torch.where(wrapped, stats["cumS"][-1] - P0S + stats["P1eS"],
                     stats["P1eS"] - P0S)
    aQ = torch.where(wrapped, stats["cumQ"][-1] - P0Q + stats["P1eQ"],
                     stats["P1eQ"] - P0Q)
    return aS, aQ


def split_rhat_ring_windows(ring, t, windows, group, jitter=1e-8, top_k=1,
                            exceed_threshold=None):
    """Max split-R-hat for several windows, directly on the ring.

    ``windows``: ``(K,)`` candidate window sizes, each an even multiple of
    ``2 * group`` with ``t - w`` a multiple of ``group`` and
    ``w <= min(t, R)``. Returns ``(K,)`` max-over-coordinates split-R-hat
    values. ``top_k``: the ``top_k``-th largest per-coordinate R-hat
    instead of the max. ``exceed_threshold``: the per-window COUNT of
    coordinates above the threshold (a sort-free quantile gate); it takes
    precedence over ``top_k``.
    """
    windows = np.asarray(windows, dtype=np.int64)
    t = int(t)
    stats = ring_cum_stats(ring, t, group)
    dtype, device = stats["cumS"].dtype, stats["cumS"].device
    h = windows // 2
    s1, q1 = _arcs(stats, t - windows, group)   # steps [t-w, t)
    s2, q2 = _arcs(stats, t - h, group)         # steps [t-h, t)
    sum1, sq1 = s1 - s2, q1 - q2                # first half-chain
    h_f = torch.as_tensor(h, dtype=dtype, device=device)[:, None]
    m1, m2 = sum1 / h_f, s2 / h_f
    v1 = (sq1 - h_f * m1**2) / (h_f - 1.0)
    v2 = (q2 - h_f * m2**2) / (h_f - 1.0)
    grand = (m1 + m2) / 2.0
    B = h_f * ((m1 - grand) ** 2 + (m2 - grand) ** 2)
    W = (v1 + v2) / 2.0 + jitter
    rhat = torch.sqrt((h_f - 1.0) / h_f + B / (h_f * W))
    if exceed_threshold is not None:
        return (rhat > exceed_threshold).sum(dim=1).to(dtype)
    if top_k == 1:
        return rhat.max(dim=1).values
    return torch.topk(rhat, int(top_k), dim=1).values[:, -1]


def ring_window_mean(ring, t, w, group):
    """Mean of the last ``w`` iterates of the ring, exact for any
    ``(t, w)``: one boundary partial-group sum handles misalignment."""
    R = ring.shape[0]
    t, w = int(t), int(w)
    stats = ring_cum_stats(ring, t, group)
    b = t - w
    s0 = b % R
    g0 = s0 // group
    part0 = (ring[g0 * group:s0] - stats["center"]).sum(dim=0)
    P0 = stats["cumS"][g0] + part0
    if s0 >= t % R and b < t:  # the arc wraps
        arc = stats["cumS"][-1] - P0 + stats["P1eS"]
    else:
        arc = stats["P1eS"] - P0
    return arc / w + stats["center"]


def compute_R_hat(chains, warmup=0, jitter=1e-8):
    """Split-R-hat per coordinate of a single chain ``(n_iters, D)``, the
    reference's signature."""
    chains = torch.as_tensor(chains)[warmup:, :]
    return split_rhat_windowed(chains, chains.shape[0], jitter)


def _rank_normal_scores(x):
    """Per-coordinate normal scores of the ranks of ``(n, D)`` draws:
    ``z = Phi^{-1}((rank + 1 - 3/8) / (n + 1/4))`` (Blom's offset)."""
    n = x.shape[0]
    ranks = torch.argsort(torch.argsort(x, dim=0, stable=True), dim=0, stable=True)
    return torch.special.ndtri((ranks.to(x.dtype) + (1.0 - 0.375)) / (n + 0.25))


def rank_normalized_R_hat(chains, warmup=0, jitter=1e-8):
    """Rank-normalized and folded split-R-hat per coordinate (Vehtari,
    Gelman, Simpson, Carpenter & Burkner 2021): the larger of split-R-hat
    on the rank-normalized draws (bulk) and on the rank-normalized
    ``|x - median|`` (tails). ``chains``: ``(n_iters, D)`` single chain.
    Offline use: it sorts every coordinate."""
    x = torch.as_tensor(chains)[warmup:, :]
    n = x.shape[0]
    bulk = split_rhat_windowed(_rank_normal_scores(x), n, jitter)
    xs = torch.sort(x, dim=0).values
    median = 0.5 * (xs[(n - 1) // 2] + xs[n // 2])
    tail = split_rhat_windowed(_rank_normal_scores(torch.abs(x - median)), n, jitter)
    return torch.maximum(bulk, tail)


def R_hat_convergence_check(samples, windows, Rhat_threshold=1.1,
                            rank_normalized=False):
    """Pick the trailing window with the smallest max split-R-hat.

    ``samples``: ``(n, D)``, most recent last; ``windows``: iterable of
    ints. ``rank_normalized`` scores each window with
    :func:`rank_normalized_R_hat` (ranks recomputed within the window).
    Returns ``(success, best_window)``.
    """
    samples = torch.as_tensor(samples)
    windows = [int(w) for w in windows]
    n = samples.shape[0]
    if rank_normalized:
        r_hats = [torch.max(rank_normalized_R_hat(samples[n - w:])) for w in windows]
    else:
        r_hats = [torch.max(split_rhat_windowed(samples, w)) for w in windows]
    r_hats = torch.stack(r_hats)
    best = int(torch.argmin(r_hats))
    return bool(r_hats[best] <= Rhat_threshold), windows[best]
