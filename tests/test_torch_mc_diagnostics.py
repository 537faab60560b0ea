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
import viabel_torch.faso as tfaso  # noqa: E402
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
    return packed, ring_from_jax(packed, d), full


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
    eff_t, mcse_t = tfaso._mcse_check(ring, t, w, mf_dim, chunk=3)
    np.testing.assert_allclose(eff_t.numpy(), np.asarray(eff_j)[:d], rtol=1e-8)
    np.testing.assert_allclose(mcse_t.numpy(), np.asarray(mcse_j)[:d], rtol=1e-8)
    assert torch.isinf(eff_t[2]) and mcse_t[2] == 0.0
