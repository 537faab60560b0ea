"""A compact Hamiltonian Monte Carlo sampler (counterpart of
``viabel_tpu/hmc.py``).

Fixed-trajectory HMC with dual-averaging step-size adaptation (Hoffman &
Gelman 2014, §3.2) and two-phase warmup with diagonal mass-matrix
estimation: Welford statistics over the first warmup half set the metric
for the second, whose dual averaging restarts. Chains are a batch
dimension. Every random number of a run is drawn before its first
iteration (:func:`draw_randomness`) from a ``torch.Generator`` on the
device the positions live on, so a run is a function of the generator's
state alone, and RAABBVI's kernel (``viabel_torch.ops.wlr_hmc``, the whole
run in one launch on a card) takes the same numbers as this sampler from
one state. This function runs the iterations eagerly, as the kernel's
plain version and for any other target. RAABBVI only consumes posterior means, which
any correct sampler of the same posterior reproduces, so the draws are
compared with the JAX sampler statistically.
"""

import torch

__all__ = ["hmc_sample", "draw_randomness"]


def draw_randomness(generator, n_iters, n_chains, d, dtype, device):
    """Every random number of an HMC run, in one fixed order: the standard
    normals of the momenta, ``(n_iters, n_chains, d)``, then the uniforms
    of the accept tests, ``(n_iters, n_chains)``."""
    normals = torch.randn((n_iters, n_chains, d), generator=generator, dtype=dtype,
                          device=device)
    uniforms = torch.rand((n_iters, n_chains), generator=generator, dtype=dtype,
                          device=device)
    return normals, uniforms


def _da_init(step_size):
    return {"log_eps": torch.log(step_size), "log_eps_bar": torch.log(step_size),
            "h_bar": torch.zeros_like(step_size), "mu": torch.log(10.0 * step_size),
            "i": 0.0}


def _da_update(state, accept_prob, target_accept, gamma=0.05, t0=10.0,
               kappa=0.75):
    t = state["i"] + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state["h_bar"] + eta_h * (target_accept - accept_prob)
    log_eps = state["mu"] - t ** 0.5 / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state["log_eps_bar"]
    return {"log_eps": log_eps, "log_eps_bar": log_eps_bar, "h_bar": h_bar,
            "mu": state["mu"], "i": t}


@torch.no_grad()
def hmc_sample(value_and_grad, init_positions, generator, data=None,
               num_warmup=500, num_samples=500, num_leapfrog=24,
               target_accept=0.85, init_step_size=0.1):
    """Run multi-chain HMC.

    Parameters
    ----------
    value_and_grad : callable
        ``(n_chains, d) -> ((n_chains,), (n_chains, d))``: the unnormalized
        log density and its gradient, or ``((n_chains, d), data) -> ...``
        when ``data`` is given. The sampler takes the gradient from the
        caller because a run makes 25,000 sequential calls on a tiny
        posterior, where an autograd pass costs far more than the
        arithmetic.
    init_positions : tensor, shape (n_chains, d)
    generator : torch.Generator on the positions' device; the run draws
        its ``num_warmup + num_samples`` iterations' numbers from it first
        (:func:`draw_randomness`)

    Returns samples of shape ``(n_chains, num_samples, d)``.
    """
    lp_fn = (value_and_grad if data is None
             else (lambda q: value_and_grad(q, data)))
    q = init_positions.detach().clone()
    C, d = q.shape
    dtype, device = q.dtype, q.device
    phase_switch = num_warmup // 2
    da = _da_init(torch.full((C,), init_step_size, dtype=dtype, device=device))
    inv_mass = torch.ones((C, d), dtype=dtype, device=device)
    wf_mean = torch.zeros((C, d), dtype=dtype, device=device)
    wf_m2 = torch.zeros((C, d), dtype=dtype, device=device)
    wf_n = 0.0
    normals, uniforms = draw_randomness(generator, num_warmup + num_samples, C, d,
                                        dtype, device)
    lp, grad = lp_fn(q)
    draws = []
    for i in range(num_warmup + num_samples):
        warming = i < num_warmup
        eps = torch.exp(da["log_eps"] if warming else da["log_eps_bar"])[:, None]
        # momenta ~ N(0, M) with M = diag(1 / inv_mass)
        p = normals[i] / torch.sqrt(inv_mass)
        h0 = lp - 0.5 * torch.sum(inv_mass * p**2, dim=1)
        q_new, g_new = q, grad
        half_eps, eps_inv_mass = 0.5 * eps, eps * inv_mass
        for _ in range(num_leapfrog):
            p = torch.addcmul(p, half_eps, g_new)
            q_new = torch.addcmul(q_new, eps_inv_mass, p)
            lp_new, g_new = lp_fn(q_new)
            p = torch.addcmul(p, half_eps, g_new)
        h1 = lp_new - 0.5 * torch.sum(inv_mass * p**2, dim=1)
        log_accept = torch.clamp(h1 - h0, max=0.0)
        log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
        accept = torch.log(uniforms[i]) < log_accept
        q = torch.where(accept[:, None], q_new, q)
        lp = torch.where(accept, lp_new, lp)
        grad = torch.where(accept[:, None], g_new, grad)
        if warming:
            da = _da_update(da, torch.exp(log_accept), target_accept)
        if i < phase_switch:  # Welford accumulation over the first warmup half
            wf_n += 1.0
            delta = q - wf_mean
            wf_mean = wf_mean + delta / wf_n
            wf_m2 = wf_m2 + delta * (q - wf_mean)
        if i == phase_switch:
            # install the estimated metric, restart dual averaging from the
            # current averaged step size
            if wf_n > 10.0:
                inv_mass = torch.clamp(wf_m2 / max(wf_n - 1.0, 1.0), 1e-6, 1e6)
            da = _da_init(torch.exp(da["log_eps_bar"]))
        if not warming:
            draws.append(q)
    return torch.stack(draws, dim=1)
