"""The first steps of ExclusiveKL + RMSProp, and FASO's split-R-hat verdict.

The negative ELBO at S draws ``x = draws(vp, z)``: with the closed-form
entropy ``-(mean log p(x) + H(q))``; "sticking the landing" (Roeder et
al. 2017) ``-mean(log p(x) - log q_stop(x))``, the family's density at
parameters held fixed so that the gradient enters through the draws
alone. RMSProp as the configuration states it: ``nu_1 = g_1^2``, then
``nu_k = beta nu_{k-1} + (1 - beta) g_k^2``, and ``vp -= lr g /
sqrt(jitter + nu)``.
"""

import numpy as np
import torch


def loss(family, log_p, vp, z, stl):
    x = family.draws(vp, z)
    if stl:
        return -torch.mean(log_p(x) - family.log_q(vp.detach(), x))
    return -(torch.mean(log_p(x)) + family.entropy(vp))


def first_steps(family, log_p, draws, *, stl, lr, beta=0.9, jitter=1e-8,
                dtype=torch.float64, device="cpu"):
    """Follow ``len(draws)`` steps from the family's start; each entry of
    ``draws`` is one step's ``(S, d)`` base normals. Returns each step's
    loss, the first gradient and the start and end parameters."""
    vp = family.init(dtype, device)
    start = vp.clone()
    losses, first_grad, nu = [], None, None
    for z in draws:
        v = vp.detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss(family, log_p, v, z.to(dtype), stl)
            (g,) = torch.autograd.grad(value, v)
        losses.append(float(value.detach()))
        if first_grad is None:
            first_grad, nu = g, g * g
        else:
            nu = beta * nu + (1.0 - beta) * g * g
        vp = vp.detach() - lr * g / torch.sqrt(jitter + nu)
    return {"losses": losses, "first_grad": first_grad, "start": start, "end": vp}


def detection_group(W_min, k_check):
    """FASO's R-hat group: the largest divisor of ``k_check`` no larger
    than ``min(64, W_min // 4)``."""
    cap = max(1, min(64, W_min // 4))
    return max(g for g in range(1, min(cap, k_check) + 1) if k_check % g == 0)


def candidate_windows(W_min, W_upper, group):
    """FASO's candidate windows: ``linspace(W_min, W_upper, 5)`` rounded
    up to even multiples of ``2 * group`` and capped at ``W_upper``."""
    cand = np.linspace(W_min, W_upper, num=5)
    half = np.ceil(cand / (2 * group)).astype(int) * group
    half = np.clip(half, group, (W_upper // (2 * group)) * group)
    return np.unique(2 * half)


def chronological(ring, t, w, c0, c1):
    """Columns ``[c0, c1)`` of the last ``w`` of ``t`` iterates that a
    ``(R, D)`` ring holds (slot ``s % R`` holds step ``s``), oldest first."""
    R = ring.shape[0]
    idx = torch.arange(t - w, t, device=ring.device) % R
    return ring[idx, c0:c1]


def split_rhat_max(ring, t, w, *, dtype=torch.float64, jitter=1e-8, block=16384):
    """The largest per-coordinate split-R-hat of the ring's last ``w``
    iterates, computed in ``dtype`` ``block`` columns at a time."""
    h = w // 2
    best = -np.inf
    for c in range(0, ring.shape[1], block):
        x = chronological(ring, t, w, c, c + block).to(dtype)
        a, b = x[w - 2 * h:w - h], x[w - h:]
        m1, m2 = a.mean(dim=0), b.mean(dim=0)
        v1 = ((a - m1) ** 2).sum(dim=0) / (h - 1.0)
        v2 = ((b - m2) ** 2).sum(dim=0) / (h - 1.0)
        grand = (m1 + m2) / 2.0
        B = h * ((m1 - grand) ** 2 + (m2 - grand) ** 2)
        W = (v1 + v2) / 2.0 + jitter
        best = max(best, float(torch.sqrt((h - 1.0) / h + B / (h * W)).max()))
    return best


def steps_from(family, log_p, starts, draws, *, stl, lr, beta=0.9, jitter=1e-8, nu=None,
               dtype=torch.float64, store=None):
    """Recompute optimizer steps from the program's own iterates: step
    ``i`` starts from ``starts[i]`` and draws ``draws[i]``; ``nu`` is
    RMSProp's state before the first of them (None: the first step of
    RMSProp, ``nu = g^2``). Yields, per step, its loss, the change it makes
    (stored in ``store``'s precision, as the program keeps its iterates,
    where ``store`` is given), its gradient and RMSProp's new state."""
    for v0, z in zip(starts, draws):
        v = v0.to(dtype).detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss(family, log_p, v, z.to(dtype), stl)
            (g,) = torch.autograd.grad(value, v)
        nu = g * g if nu is None else beta * nu + (1.0 - beta) * g * g
        change = -lr * g / torch.sqrt(jitter + nu)
        if store is not None:
            change = (v0.to(store) + change.to(store)).to(torch.float64) - v0.to(torch.float64)
        yield float(value.detach()), change, g, nu
