"""RAABBVI's round regression sampled by HMC (CUDA kernel + plain version).

Each RAABBVI round ends in a Bayesian weighted regression of ``log SKL``
on ``log lr`` (the reference's ``weighted_lin_regression.stan`` and its
kappa = 1 ``_sgd`` variant), sampled by :func:`viabel_torch.hmc.hmc_sample`
at 4 chains x 1,000 iterations x 24 leapfrog steps. The JAX package runs
that sampler as one XLA program (``viabel_tpu/hmc.py``: ``lax.scan``
over iterations, ``vmap`` over chains); eagerly it is 25,000 dependent
rounds of a few dozen tiny operations. The CUDA kernel
(``csrc/wlr_hmc.cu``) runs the whole multi-chain run in one launch, one
warp a chain. The plain version is ``hmc_sample`` on the targets below,
with their hand-written gradients. Both take every random number from the
caller's generator up front, in one order (:func:`viabel_torch.hmc.
draw_randomness`), so from one generator state the kernel and the plain
version take the same numbers. Their sums are reassociated, and at 24
leapfrog steps the sampler amplifies a last-bit difference past 1e-9
within tens of iterations: the two agree draw for draw over short runs,
and in distribution over RAABBVI's 1,000 iterations.
"""

import math

import torch

from ..hmc import draw_randomness, hmc_sample
from . import _build

__all__ = ["wlr_hmc", "wlr_hmc_plain", "wlr_general", "wlr_averaged",
           "KERNEL_MAX_ROWS"]

#: the most observations (rounds) the kernel takes: 32 register chunks of
#: one warp's 32 lanes
KERNEL_MAX_ROWS = 1024


def wlr_general(theta, data):
    """Posterior of the reference's weighted_lin_regression.stan (kappa
    free) and its gradient, batched over chains: ``y ~ N(log_c + 2
    log(rho^{-kappa} - 1) + 2 kappa x, sigma)`` with per-observation
    weights; kappa ~ U(0,1) (logit transform), log_c ~ Cauchy(0,10),
    sigma ~ HalfCauchy(0,10). ``theta``: ``(C, 3)`` rows ``(logit kappa,
    log_c, log_sigma)``. Returns ``((C,), (C, 3))``."""
    y, x, w, rho = data
    kappa_logit, log_c, log_sigma = theta.unbind(1)
    kappa = torch.sigmoid(kappa_logit)
    inv_sigma = torch.exp(-log_sigma)
    r_m1 = torch.expm1(-math.log(rho) * kappa)           # rho^-kappa - 1
    mu = torch.addcmul((log_c + 2.0 * torch.log(r_m1))[:, None],
                       2.0 * kappa[:, None], x)
    e = (y - mu) * inv_sigma[:, None]
    we = w * e
    wee = torch.sum(we * e, dim=1)
    wsum = torch.sum(w)
    c2 = (0.1 * log_c) ** 2
    s2 = (0.1 / inv_sigma) ** 2
    lp = (-0.5 * wee - wsum * log_sigma
          + torch.log(kappa) + torch.log1p(-kappa)        # U(0,1) + jacobian
          - torch.log1p(c2)                               # Cauchy(0,10)
          - torch.log1p(s2) + log_sigma)                  # HalfCauchy + jac.
    g_mu = we * inv_sigma[:, None]                        # d loglik / d mu
    sum_g = torch.sum(g_mu, dim=1)
    # d mu / d kappa = -2 log(rho) rho^-kappa / (rho^-kappa - 1) + 2 x
    dlik_dkappa = (sum_g * (-2.0 * math.log(rho)) * (r_m1 + 1.0) / r_m1
                   + 2.0 * (g_mu @ x))
    grad = torch.stack([
        dlik_dkappa * kappa * (1.0 - kappa) + 1.0 - 2.0 * kappa,
        sum_g - 0.02 * log_c / (1.0 + c2),
        wee - wsum - 2.0 * s2 / (1.0 + s2) + 1.0], dim=1)
    return lp, grad


def wlr_averaged(theta, data):
    """kappa == 1 variant (weighted_lin_regression_sgd.stan) and its
    gradient; ``theta``: ``(C, 2)`` rows ``(log_c, log_sigma)``."""
    y, x, w, rho = data
    log_c, log_sigma = theta.unbind(1)
    inv_sigma = torch.exp(-log_sigma)
    mu = (log_c + 2.0 * math.log(1.0 / rho - 1.0))[:, None] + 2.0 * x
    e = (y - mu) * inv_sigma[:, None]
    we = w * e
    wee = torch.sum(we * e, dim=1)
    wsum = torch.sum(w)
    c2 = (0.1 * log_c) ** 2
    s2 = (0.1 / inv_sigma) ** 2
    lp = (-0.5 * wee - wsum * log_sigma - torch.log1p(c2)
          - torch.log1p(s2) + log_sigma)
    grad = torch.stack([
        torch.sum(we * inv_sigma[:, None], dim=1) - 0.02 * log_c / (1.0 + c2),
        wee - wsum - 2.0 * s2 / (1.0 + s2) + 1.0], dim=1)
    return lp, grad


#: the target by the width of a position: 3 general, 2 averaged
TARGETS = {3: wlr_general, 2: wlr_averaged}


def wlr_hmc_plain(init, generator, data, num_warmup=500, num_samples=500,
                  num_leapfrog=24, target_accept=0.85, init_step_size=0.1):
    """Plain PyTorch version: :func:`hmc_sample` on the target of
    ``init``'s width."""
    return hmc_sample(TARGETS[init.shape[1]], init, generator, data=data,
                      num_warmup=num_warmup, num_samples=num_samples,
                      num_leapfrog=num_leapfrog, target_accept=target_accept,
                      init_step_size=init_step_size)


def _check(init, data, num_warmup, num_samples, num_leapfrog):
    if init.dim() != 2 or init.shape[1] not in TARGETS or init.shape[0] < 1:
        raise ValueError("init must be (n_chains, d) with d = 3 (general target) "
                         f"or d = 2 (averaged target), got {tuple(init.shape)}")
    y, x, w, _rho = data
    N = y.shape[0] if y.dim() == 1 else -1
    if N < 1 or x.shape != (N,) or w.shape != (N,):
        raise ValueError("y, x and w must be vectors of one length N >= 1, got "
                         f"{tuple(y.shape)}, {tuple(x.shape)}, {tuple(w.shape)}")
    if num_warmup < 0 or num_samples < 1 or num_leapfrog < 1:
        raise ValueError("need num_warmup >= 0, num_samples >= 1, num_leapfrog >= 1")
    return N


def wlr_hmc(init, generator, data, num_warmup=500, num_samples=500,
            num_leapfrog=24, target_accept=0.85, init_step_size=0.1):
    """Multi-chain HMC on the weighted-regression posterior: what
    ``hmc_sample(wlr_general | wlr_averaged, init, generator, data=data)``
    returns, ``(n_chains, num_samples, d)``.

    ``init``: ``(C, d)``, d = 3 for the general target, 2 for the
    averaged one; ``data``: ``(y, x, w, rho)`` with y, x, w ``(N,)``;
    ``generator`` on ``init``'s device. Every random number is drawn
    first, (T, C, d) momentum normals then (T, C) uniforms with T =
    num_warmup + num_samples. CPU tensors take the plain version; CUDA
    tensors (float64, contiguous, N <= 1024) launch the kernel once.
    """
    num_warmup, num_samples, num_leapfrog = (int(num_warmup), int(num_samples),
                                             int(num_leapfrog))
    N = _check(init, data, num_warmup, num_samples, num_leapfrog)
    if init.device.type == "cpu":
        return wlr_hmc_plain(init, generator, data, num_warmup, num_samples,
                             num_leapfrog, target_accept, init_step_size)
    y, x, w, rho = data
    tensors = (init, y, x, w)
    if not init.is_cuda or any(t.device != init.device for t in tensors):
        raise ValueError("init, y, x and w must lie on one CUDA device")
    if any(t.dtype != torch.float64 for t in tensors):
        raise TypeError("wlr_hmc takes float64 init, y, x and w")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("init, y, x and w must be contiguous")
    if N > KERNEL_MAX_ROWS:
        raise ValueError(f"wlr_hmc's kernel takes at most {KERNEL_MAX_ROWS} "
                         f"observations, got {N}")
    lib = _build.load_library()
    C, d = init.shape
    normals, uniforms = draw_randomness(generator, num_warmup + num_samples, C, d,
                                        init.dtype, init.device)
    draws = torch.empty((C, num_samples, d), dtype=init.dtype, device=init.device)
    rho = float(rho)
    shift = 2.0 * math.log(1.0 / rho - 1.0) if d == 2 else 0.0
    stream = torch.cuda.current_stream(init.device).cuda_stream
    _build.check(lib.viabel_wlr_hmc_f64(
        init.data_ptr(), normals.data_ptr(), uniforms.data_ptr(), y.data_ptr(),
        x.data_ptr(), w.data_ptr(), draws.data_ptr(), C, d, N, num_warmup,
        num_samples, num_leapfrog, math.log(rho), shift, float(target_accept),
        float(init_step_size), stream), "wlr_hmc")
    _build.count_launch("wlr_hmc")
    return draws
