"""viabel_torch convergence statistics against the JAX package.

Rings and histories are made with numpy from a seed; the JAX side gets
them packed ``(R, 8, C)`` as its FASO stores them, the port gets the
plain ``(R, D)`` ring through :func:`viabel_torch.convert.ring_from_jax`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import viabel_tpu.faso as jfaso  # noqa: E402
import viabel_tpu.mc_diagnostics as jmc  # noqa: E402
import viabel_torch.detection as tdetection  # noqa: E402
import viabel_torch.mc_diagnostics as tmc  # noqa: E402
from viabel_torch.convert import ring_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill_ring(R, d, t, rng, drift=0.0):
    """A ring holding steps [max(0, t - R), t) of a random walk-ish chain:
    slot s % R holds step s (the cases of tests/test_ops.py:98-130)."""
    from viabel_tpu.utils import pack_rows
    ring = np.zeros((R, d))
    full = rng.randn(t, d) + 5.0 + drift * np.arange(t)[:, None] / max(t, 1)
    for s in range(t):
        ring[s % R] = full[s]
    packed = np.array(pack_rows(jnp.asarray(ring)))
    return packed, ring_from_jax(packed, d, device="cpu"), full


RING_CASES = [(96, 0.0), (200, 0.0), (256, 1.0), (331, 2.0)]  # unwrapped,
# wrapped, t % R == 0, odd t (aligned down to the group grid)


@pytest.mark.parametrize("t,drift", RING_CASES)
@pytest.mark.parametrize("mode", ["max", "top_k", "exceed"])
def test_split_rhat_ring_windows_matches_jax(t, drift, mode):
    """rtol 1e-10: the same float64 moments from group sums in another
    order; counts must be equal."""
    rng = np.random.RandomState(t)
    R, d, G = 128, 7, 8
    t_al = (t // G) * G
    packed, ring, _ = _fill_ring(R, d, t_al, rng, drift)
    windows = np.asarray([32, 64, 96, 128])
    windows = windows[windows <= min(t_al, R)]
    kw = {"max": {}, "top_k": {"top_k": 3},
          "exceed": {"exceed_threshold": 1.02}}[mode]
    want = np.asarray(jmc.split_rhat_ring_windows(
        jnp.asarray(packed), jnp.asarray(t_al), jnp.asarray(windows), group=G, **kw))
    got = tmc.split_rhat_ring_windows(ring, t_al, windows, G, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("t,w", [(50, 20), (200, 64), (333, 41), (128, 64)])
def test_ring_window_mean_matches_jax(t, w):
    from viabel_tpu.utils import unpack_rows
    rng = np.random.RandomState(7 + t)
    R, d, G = 64, 5, 8
    packed, ring, full = _fill_ring(R, d, t, rng)
    want = np.asarray(unpack_rows(jmc.ring_window_mean(
        jnp.asarray(packed), jnp.asarray(t), jnp.asarray(w), group=G), d))
    got = tmc.ring_window_mean(ring, t, w, G).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(got, full[t - w:t].mean(axis=0), rtol=1e-9)


@pytest.mark.parametrize("w", [40, 57, 120])
def test_windowed_ess_mcse_and_rhat_match_jax(w):
    """rtol 1e-8 (FFT lengths differ: the JAX statistic masks a fixed
    buffer, the port slices the window)."""
    rng = np.random.RandomState(w)
    R, D = 120, 9
    # AR(1) chains with per-coordinate autocorrelation, plus one constant
    phi = np.linspace(-0.3, 0.9, D)
    x = np.zeros((R, D))
    for i in range(1, R):
        x[i] = phi * x[i - 1] + rng.randn(D)
    x[:, 3] = 1.5
    eff_j, mcse_j = jmc.ess_and_mcse_windowed(jnp.asarray(x), jnp.asarray(w))
    eff_t, mcse_t = tmc.ess_and_mcse_windowed(torch.as_tensor(x), w)
    np.testing.assert_allclose(eff_t.numpy(), np.asarray(eff_j), rtol=1e-8)
    np.testing.assert_allclose(mcse_t.numpy(), np.asarray(mcse_j), rtol=1e-8)
    rhat_j = jmc.split_rhat_windowed(jnp.asarray(x), jnp.asarray(w))
    rhat_t = tmc.split_rhat_windowed(torch.as_tensor(x), w)
    np.testing.assert_allclose(rhat_t.numpy(), np.asarray(rhat_j), rtol=1e-8)
    np.testing.assert_allclose(tmc.autocov(torch.as_tensor(x), axis=0).numpy(),
                               np.asarray(jmc.autocov(jnp.asarray(x), axis=0)),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mf", [False, True])
@pytest.mark.parametrize("t,w", [(150, 90), (300, 128)])
def test_mcse_check_matches_jax(mf, t, w):
    """FASO's streamed MCSE check, including the MFGaussian rescaling and
    the constant-coordinate rule; the port streams 3-column chunks here so
    the chunk boundaries are exercised. rtol 1e-8."""
    rng = np.random.RandomState(t + w)
    R, d = 128, 8
    packed, ring, _ = _fill_ring(R, d, t, rng)
    packed[:, 0, 2] = 0.25  # a constant coordinate
    ring[:, 2] = 0.25
    mf_dim = d // 2 if mf else None
    eff_j, mcse_j = jfaso._mcse_check(jnp.asarray(packed), jnp.asarray(t),
                                      jnp.asarray(w), mf_dim)
    eff_t, mcse_t = tdetection._mcse_check(ring, t, w, mf_dim, chunk=3)
    np.testing.assert_allclose(eff_t.numpy(), np.asarray(eff_j)[:d], rtol=1e-8)
    np.testing.assert_allclose(mcse_t.numpy(), np.asarray(mcse_j)[:d], rtol=1e-8)
    assert torch.isinf(eff_t[2]) and mcse_t[2] == 0.0


@pytest.mark.parametrize("phi", [0.0, 0.9])
def test_reference_api_ess_mcse_and_rhat_match_jax(phi):
    """ess, MCSE and compute_R_hat (the reference's signatures) on an iid
    and an AR(1) chain, rtol 1e-8: the port's ESS is the vectorized form
    where JAX's ess runs its while-loop form."""
    rng = np.random.RandomState(31)
    n, D = 500, 4
    x = np.zeros((n, D))
    eps = rng.randn(n, D)
    for i in range(1, n):
        x[i] = phi * x[i - 1] + eps[i]
    np.testing.assert_allclose(float(tmc.ess(torch.as_tensor(x[:, 0][None]))),
                               float(jmc.ess(jnp.asarray(x[:, 0][None]))), rtol=1e-8)
    for got, want in zip(tmc.MCSE(torch.as_tensor(x)), jmc.MCSE(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)
    for warmup in (0, 101):
        np.testing.assert_allclose(
            tmc.compute_R_hat(torch.as_tensor(x), warmup=warmup).numpy(),
            np.asarray(jmc.compute_R_hat(jnp.asarray(x), warmup=warmup)), rtol=1e-8)


@pytest.mark.parametrize("n", [400, 401])
def test_rank_normalized_R_hat_matches_jax(n):
    """Bulk and folded-tail statistics on heavy-tailed draws with a trend,
    even and odd n (the median's two cases), rtol 1e-8."""
    rng = np.random.RandomState(n)
    x = rng.standard_t(2.0, size=(n, 3)) + np.linspace(0, 1, n)[:, None] * [0, 1, 3]
    for warmup in (0, 50):
        np.testing.assert_allclose(
            tmc.rank_normalized_R_hat(torch.as_tensor(x), warmup=warmup).numpy(),
            np.asarray(jmc.rank_normalized_R_hat(jnp.asarray(x), warmup=warmup)),
            rtol=1e-8)


@pytest.mark.parametrize("rank_normalized", [False, True])
@pytest.mark.parametrize("trend", [0.0, 4.0])
def test_R_hat_convergence_check_matches_jax(rank_normalized, trend):
    rng = np.random.RandomState(5)
    x = rng.randn(600, 5) + trend * np.exp(-np.arange(600) / 100.0)[:, None]
    windows = [100, 200, 400, 600]
    got = tmc.R_hat_convergence_check(torch.as_tensor(x), windows,
                                      rank_normalized=rank_normalized)
    want = jmc.R_hat_convergence_check(jnp.asarray(x), windows,
                                       rank_normalized=rank_normalized)
    assert got == want
