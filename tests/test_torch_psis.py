"""viabel_torch.psis against the JAX package, in float64 on the CPU.

The port keeps the tail at its true length (the reference's dynamic
boolean indexing) where the JAX package masks a fixed top-T block; what is
held is the result, khat and the smoothed log weights, at rtol 1e-8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from viabel_tpu import psis as pj  # noqa: E402
from viabel_torch import psis as pt  # noqa: E402

RTOL = 1e-8  # same float64 formulas; sums and the GPD grid in another order


def _gaussian_log_weights(n, var_p, var_q, seed):
    """log N(x; 0, var_p) - log N(x; 0, var_q) at x ~ N(0, var_q)."""
    x = np.random.RandomState(seed).randn(n) * np.sqrt(var_q)
    return (-0.5 * x**2 / var_p - 0.5 * np.log(var_p)
            + 0.5 * x**2 / var_q + 0.5 * np.log(var_q))


@pytest.mark.parametrize("n,var_p,var_q", [
    (5000, 1.0, 4.0),    # bounded weights: khat < 0, no smoothing
    (5000, 4.0, 1.0),    # heavy tail: khat > 0.7, tail smoothed
    (20000, 2.0, 1.2),   # moderate: khat in (1/3, 0.7)
    (2000, 1.5, 1.5),    # q = p: constant weights
])
def test_psislw_matches_jax(n, var_p, var_q):
    lw = _gaussian_log_weights(n, var_p, var_q, seed=n)
    slw_j, k_j = pj.psislw(jnp.asarray(lw))
    slw_t, k_t = pt.psislw(torch.as_tensor(lw))
    np.testing.assert_allclose(float(k_t), float(k_j), rtol=RTOL)
    np.testing.assert_allclose(slw_t.numpy(), np.asarray(slw_j), rtol=RTOL, atol=1e-12)


def test_psislw_khat_is_inf_with_fewer_than_five_tail_draws():
    """n = 20 gives a tail of ceil(min(4, 3 sqrt(20))) = 4 draws: no fit,
    khat = inf and the weights only renormalized, on both sides."""
    lw = np.random.RandomState(1).randn(20)
    slw_j, k_j = pj.psislw(jnp.asarray(lw))
    slw_t, k_t = pt.psislw(torch.as_tensor(lw))
    assert np.isinf(float(k_j)) and np.isinf(float(k_t))
    np.testing.assert_allclose(slw_t.numpy(), np.asarray(slw_j), rtol=RTOL)


def test_psislw_2d_matches_jax():
    lw = np.column_stack([_gaussian_log_weights(3000, 1.0, 2.0, seed=2),
                          _gaussian_log_weights(3000, 2.0, 1.5, seed=3),
                          _gaussian_log_weights(3000, 3.0, 1.0, seed=4)])
    slw_j, k_j = pj.psislw(jnp.asarray(lw))
    slw_t, k_t = pt.psislw(torch.as_tensor(lw))
    assert k_t.shape == (3,)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=RTOL)
    np.testing.assert_allclose(slw_t.numpy(), np.asarray(slw_j), rtol=RTOL, atol=1e-12)
    with pytest.raises(ValueError):
        pt.psislw(torch.zeros(2, 2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        pt.psislw(torch.zeros(1, dtype=torch.float64))


@pytest.mark.parametrize("n", [100, 1000, 4096])
def test_gpdfitnew_matches_jax(n):
    x = np.random.RandomState(7 + n).exponential(scale=2.0, size=n)
    k_j, s_j = pj.gpdfitnew(jnp.asarray(x))
    k_t, s_t = pt.gpdfitnew(torch.as_tensor(x))
    np.testing.assert_allclose(float(k_t), float(k_j), rtol=RTOL)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=RTOL)


def test_psisloo_matches_jax():
    rng = np.random.RandomState(21)
    log_lik = -0.5 * (rng.randn(4000, 12) + rng.randn(1, 12)) ** 2
    loo_j, loos_j, ks_j = pj.psisloo(jnp.asarray(log_lik))
    loo_t, loos_t, ks_t = pt.psisloo(torch.as_tensor(log_lik))
    np.testing.assert_allclose(float(loo_t), float(loo_j), rtol=RTOL)
    np.testing.assert_allclose(loos_t.numpy(), np.asarray(loos_j), rtol=RTOL)
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), rtol=RTOL)


def test_gpinv_and_sumlogs_match_jax():
    p = np.array([0.0, 0.1, 0.25, 0.5, 0.75, 0.99, 1.0])
    for k, sigma in [(0.5, 1.0), (-0.5, 1.0), (0.0, 2.0), (0.3, -1.0)]:
        want = pj.gpinv(jnp.asarray(p), jnp.asarray(k), sigma)
        np.testing.assert_allclose(pt.gpinv(torch.as_tensor(p), k, sigma).numpy(),
                                   np.asarray(want), rtol=1e-12)
    x = np.random.RandomState(0).randn(100, 3) * 50
    np.testing.assert_allclose(float(pt.sumlogs(torch.as_tensor(x))),
                               float(pj.sumlogs(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(pt.sumlogs(torch.as_tensor(x), axis=0).numpy(),
                               np.asarray(pj.sumlogs(jnp.asarray(x), axis=0)), rtol=1e-12)
