"""viabel_torch's Pathfinder against the JAX package, in float64 on the CPU.

The L-BFGS paths are deterministic and compared directly. The JAX package
draws its ELBO and final normals from split keys and its resampling
indices with ``jax.random.categorical``; those draws are recomputed from
the keys and injected through ``base_sampler`` and ``resampler``. QR and
``eigh`` may return Q, R_q and P with other signs (and, for a masked
window, other null directions) than LAPACK did under JAX, so the factored
Gaussians are compared by mu, the eigenvalues, the half log-determinant,
Sigma and ``Sigma^{1/2} z``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402

jpf = importlib.import_module("viabel_tpu.pathfinder")
tpf = importlib.import_module("viabel_torch.pathfinder")

CPU = dict(device="cpu", dtype=torch.float64)
D = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(kind):
    if kind == "logistic":
        return (vj.zoo.logistic_regression(dim=D, n_data=40)[0],
                vt.zoo.logistic_regression(dim=D, n_data=40, **CPU)[0])
    return (vj.zoo.correlated_gaussian(dim=D, rho=0.7)[0],
            vt.zoo.correlated_gaussian(dim=D, rho=0.7, **CPU)[0])


def _jax_path(model_j, x0, max_iters, history, init_step):
    def logp(x):
        return model_j(x[None])[0]

    run = jax.jit(lambda x: jpf._lbfgs_path(logp, jax.grad(logp), x, max_iters, history,
                                            init_step))
    return [np.asarray(a) for a in run(jnp.asarray(x0))]


# iterations before the path reaches round-off, where an improvement test
# at 1e-16 may go either way in the two packages
@pytest.mark.parametrize("kind,max_iters", [("logistic", 10), ("correlated", 20)])
def test_lbfgs_path_matches_jax(kind, max_iters):
    """xs, gs and logps at 1e-10 (relative to each array's largest entry),
    the diagonal estimates at 1e-8 (their update divides by s^T y, which
    shrinks along the path), the pair validity exactly, from two starts
    run as one batch of paths."""
    model_j, model_t = _models(kind)
    x0 = 3.0 * np.random.RandomState(3).randn(2, D)
    got = tpf._lbfgs_path(model_t, torch.as_tensor(x0), max_iters, 3, 1.0)
    for m in range(2):
        want = _jax_path(model_j, x0[m], max_iters, 3, 1.0)
        for name, g, w, tol in zip(("xs", "gs", "logps", "alphas"), got[:4], want[:4],
                                   (1e-10, 1e-10, 1e-10, 1e-8)):
            np.testing.assert_allclose(g[m].numpy(), w, rtol=0,
                                       atol=tol * np.abs(w).max(), err_msg=name)
        np.testing.assert_array_equal(got[4][m].numpy(), want[4])


def test_batched_line_search_picks_jax_step():
    """A first step of length 40 overshoots the logistic regression's mode:
    the sequential search halves it several times. The batched search
    (all 21 trial points in one model call) lands on the same point as
    JAX's loop, and its step is a power-of-two fraction of the first."""
    model_j, model_t = _models("logistic")
    x0 = np.random.RandomState(4).randn(D)
    want = _jax_path(model_j, x0, 6, 3, 40.0)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return model_t(x)

    xs, gs, logps, _, _ = tpf._lbfgs_path(counted, torch.as_tensor(x0)[None], 6, 3, 40.0)
    np.testing.assert_allclose(xs[0].numpy(), want[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(logps[0].numpy(), want[2], rtol=1e-12)
    step = float(torch.linalg.vector_norm(xs[0, 1] - xs[0, 0]))
    halvings = np.log2(40.0 / step)
    assert halvings >= 2 and abs(halvings - round(halvings)) < 1e-9
    assert calls.count(21) == 6  # one batched line search an iteration


def _valid_pairs(d, J, seed=0, masked=()):
    """(alpha, S_w, Y_w, mask) from an SPD quadratic, with some slots masked
    and zeroed as the pair windows leave them."""
    rng = np.random.RandomState(seed)
    A = rng.randn(d, d)
    S = rng.randn(d, J)
    Y = (A @ A.T + d * np.eye(d)) @ S
    mask = np.ones(J, bool)
    mask[list(masked)] = False
    S, Y = S * mask, Y * mask
    return np.exp(0.3 * rng.randn(d)), S, Y, mask


def _dense_sigma(q, lib):
    mu, sqrt_a, Q, P, lam, half_logdet, ok = q
    U = sqrt_a[:, None] * (Q @ P)
    return mu, lam, half_logdet, ok, lib.diag(sqrt_a**2) + U @ (lam[:, None] * U.T)


@pytest.mark.parametrize("masked", [(), (1,)])
def test_factored_gaussian_sign_invariants_match_jax(masked):
    """mu, the sorted eigenvalues, the half log-determinant, Sigma and
    Sigma^{1/2} z for one z match JAX at 1e-10, with a full and a
    part-masked window; Q and P themselves are not compared."""
    d, J = 7, 3
    alpha, S, Y, mask = _valid_pairs(d, J, masked=masked)
    rng = np.random.RandomState(1)
    x, g, z = rng.randn(d), rng.randn(d), rng.randn(16, d)
    qj = jpf._factored_gaussian(*(jnp.asarray(a) for a in (x, g, alpha, S, Y, mask)))
    qt = tpf._factored_gaussian(*(torch.as_tensor(a) for a in (x, g, alpha, S, Y, mask)))
    mu_j, lam_j, hl_j, ok_j, sig_j = _dense_sigma([np.asarray(a) for a in qj], np)
    mu_t, lam_t, hl_t, ok_t, sig_t = _dense_sigma(qt, torch)
    assert bool(ok_t) == bool(ok_j) is True
    np.testing.assert_allclose(mu_t.numpy(), mu_j, rtol=1e-10)
    np.testing.assert_allclose(np.sort(lam_t.numpy()), np.sort(lam_j), rtol=1e-10,
                               atol=1e-10 * np.abs(lam_j).max())
    np.testing.assert_allclose(float(hl_t), float(hl_j), rtol=1e-10)
    np.testing.assert_allclose(sig_t.numpy(), sig_j, rtol=1e-10, atol=1e-12)
    W = np.asarray(jpf._middle_matrix(*(jnp.asarray(a) for a in (alpha, S, Y, mask))))
    B = np.concatenate([S, alpha[:, None] * Y], axis=1)
    np.testing.assert_allclose(sig_t.numpy(), np.diag(alpha) + B @ W @ B.T, rtol=1e-10,
                               atol=1e-12)
    samples_t, log_q_t = tpf._sample_factored(qt, torch.as_tensor(z))
    samples_j, log_q_j = jpf._sample_factored(qj, jax.random.PRNGKey(0), 16)
    z_j = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, d)))
    samples_t2, log_q_t2 = tpf._sample_factored(qt, torch.tensor(z_j))
    np.testing.assert_allclose(samples_t2.numpy(), np.asarray(samples_j), rtol=1e-10)
    np.testing.assert_allclose(log_q_t2.numpy(), np.asarray(log_q_j), rtol=1e-10)
    # Sigma^{1/2} is the symmetric root: its square is Sigma
    root = (samples_t - mu_t).T @ torch.linalg.pinv(torch.as_tensor(z).T)
    np.testing.assert_allclose((root @ root.T).numpy(), sig_j, rtol=1e-8, atol=1e-10)


class DrawTable:
    """Hands out consecutive rows of one table of normals."""

    def __init__(self, table):
        self.table, self.pos = table, 0

    def normal(self, generator, n_samples, width, dtype, device):
        rows = self.table[self.pos:self.pos + n_samples, :width]
        assert rows.shape[0] == n_samples
        self.pos += n_samples
        return torch.as_tensor(rows, dtype=dtype, device=device)


def _jax_path_draws(key, L1, K, n, d):
    """JAX's ELBO draws for the L+1 points, then its final draws (one split
    key each, pathfinder.py:298-311)."""
    keys = jax.random.split(key, L1 + 1)
    elbo = [np.asarray(jax.random.normal(keys[l], (K, d))) for l in range(L1)]
    return np.concatenate(elbo), np.asarray(jax.random.normal(keys[L1], (n, d)))


def test_pathfinder_matches_jax_with_injected_draws():
    """Single-path pathfinder: the per-point ELBOs (each from JAX's draws),
    the chosen point, its draws, log q, log p and the path's log
    densities at 1e-10."""
    model_j, model_t = _models("logistic")
    x0 = 2.0 * np.random.RandomState(5).randn(D)
    kw = dict(max_iters=8, history=3, n_elbo_draws=12, n_draws=20)
    key = jax.random.PRNGKey(11)
    res_j = vj.pathfinder(model_j, jnp.asarray(x0), key, **kw)
    elbo_z, final_z = _jax_path_draws(key, 9, 12, 20, D)
    sampler = DrawTable(np.concatenate([elbo_z, final_z]))
    res_t = vt.pathfinder(model_t, torch.as_tensor(x0), base_sampler=sampler, **kw)
    assert sampler.pos == sampler.table.shape[0]
    assert int(res_t["best_l"]) == int(res_j["best_l"])
    for name in ("elbo", "path_logps", "mu", "samples", "log_q", "log_p"):
        np.testing.assert_allclose(res_t[name].numpy(), np.asarray(res_j[name]), rtol=1e-10,
                                   err_msg=name)


def test_multipath_pathfinder_matches_jax_with_injected_resampling():
    """Three paths in one batch: per-path ELBOs and best points, the pooled
    draws and their smoothed weights, khat, and the resampled draws with
    JAX's categorical indices injected."""
    model_j, model_t = _models("correlated")
    inits = 2.0 * np.random.RandomState(6).randn(3, D)
    kw = dict(max_iters=8, history=3, n_elbo_draws=10, n_draws_per_path=30, n_draws=40)
    key = jax.random.PRNGKey(12)
    res_j = vj.multipath_pathfinder(model_j, jnp.asarray(inits), key, **kw)
    key_paths, key_resample = jax.random.split(key)
    draws = [_jax_path_draws(k, 9, 10, 30, D) for k in jax.random.split(key_paths, 3)]
    table = np.concatenate([np.concatenate([e for e, _ in draws]),
                            np.concatenate([f for _, f in draws])])
    idx = np.asarray(jax.random.categorical(key_resample, res_j["log_weights"], shape=(40,)))

    class Fixed:
        def choice(self, generator, p, n):
            assert n == 40 and torch.isclose(p.sum(), torch.tensor(1.0, dtype=p.dtype))
            return torch.tensor(idx)

    res_t = vt.multipath_pathfinder(model_t, torch.as_tensor(inits),
                                    base_sampler=DrawTable(table), resampler=Fixed(), **kw)
    np.testing.assert_array_equal(res_t["best_l"].numpy(), np.asarray(res_j["best_l"]))
    for name in ("elbo", "pool_samples", "pool_log_p", "pool_log_q", "log_weights",
                 "samples"):
        np.testing.assert_allclose(res_t[name].numpy(), np.asarray(res_j[name]), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(float(res_t["khat"]), float(res_j["khat"]), rtol=1e-9)


@pytest.mark.parametrize("kind", ["mf", "full", "lr", "mvt"])
def test_family_param_from_factor_matches_jax(kind):
    """The moment match onto MFGaussian (exact marginals), FullRankGaussian
    (the dense Cholesky), LRGaussian(k=2) (the top-2 directions plus the
    diagonal, compared as B B^T and log sigma since B's column signs follow
    P's) and MultivariateT(df=7), whose covariance match shrinks the scale
    by (df - 2)/df."""
    d, J = 6, 2
    alpha, S, Y, mask = _valid_pairs(d, J, seed=2)
    rng = np.random.RandomState(3)
    x, g = rng.randn(d), rng.randn(d)
    qj = jpf._factored_gaussian(*(jnp.asarray(a) for a in (x, g, alpha, S, Y, mask)))
    qt = tpf._factored_gaussian(*(torch.as_tensor(a) for a in (x, g, alpha, S, Y, mask)))
    fam = {"mf": lambda pkg, **kw: pkg.MFGaussian(d, **kw),
           "full": lambda pkg, **kw: pkg.FullRankGaussian(d, **kw),
           "lr": lambda pkg, **kw: pkg.LRGaussian(d, 2, **kw),
           "mvt": lambda pkg, **kw: pkg.MultivariateT(d, 7, **kw)}[kind]
    fj, ft = fam(vj), fam(vt, **CPU)
    pj = np.asarray(jpf._family_param_from_factor(fj, qj))
    pt = tpf._family_param_from_factor(ft, qt)
    if kind == "lr":
        mu_t, ls_t, B_t = ft.unpack(pt)
        mu_j, ls_j, B_j = fj.unpack(jnp.asarray(pj))
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-10)
        np.testing.assert_allclose(ls_t.numpy(), np.asarray(ls_j), rtol=1e-10)
        np.testing.assert_allclose((B_t @ B_t.T).numpy(), np.asarray(B_j @ B_j.T),
                                   rtol=1e-10, atol=1e-12)
    else:
        np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-10, atol=1e-12)
    if kind == "mvt":
        _, cov = ft.mean_and_cov(pt)
        _, _, _, _, sigma = _dense_sigma(qt, torch)
        torch.testing.assert_close(cov, sigma, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="cannot map"):
        tpf._family_param_from_factor(vt.NeuralNet([(d, d)], **CPU), qt)


def test_pathfinder_init_and_bbvi_route():
    """pathfinder_init on a displaced-mode Gaussian lands on its moments;
    per_path gives one row a path; bbvi(init_method="pathfinder") starts
    there; the route's and the functions' errors match JAX's."""
    mean, sd = 30.0 * np.random.RandomState(0).randn(D), np.exp(
        0.3 * np.random.RandomState(1).randn(D))
    model = vt.zoo.diagonal_gaussian(mean, sd, **CPU)[0]
    approx = vt.MFGaussian(D, **CPU)
    gen = torch.Generator().manual_seed(0)
    init = vt.pathfinder_init(approx, model, gen, max_iters=30, history=D)
    mu, log_sigma = approx.unpack(init)
    # the path ends at the mode, where mu = x_l exactly; the scales are the
    # L-BFGS estimate's, picked by a 25-draw ELBO
    np.testing.assert_allclose(mu.numpy(), mean, atol=1e-6)
    np.testing.assert_allclose(torch.exp(log_sigma).numpy(), sd, rtol=0.3)
    rows = vt.pathfinder_init(approx, model, gen, n_paths=3, per_path=True, max_iters=30)
    assert rows.shape == (3, 2 * D) and torch.isfinite(rows).all()
    res = vt.bbvi(D, log_density=model, init_method="pathfinder", adaptive=False,
                  fixed_lr=True, n_iters=200, learning_rate=0.01,
                  pathfinder_kwargs=dict(max_iters=30), device="cpu",
                  dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(res["opt_param"][:D].numpy(), mean, atol=0.5)
    model_j = vj.zoo.diagonal_gaussian(mean, sd)[0]
    for kw in (dict(init_method="lbfgs"),
               dict(init_method="pathfinder", init_var_param=approx.init_param()),
               dict(pathfinder_kwargs=dict(max_iters=3))):
        kw_j = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
                for k, v in kw.items()}
        with pytest.raises(ValueError) as exc_j:
            vj.bbvi(D, log_density=model_j, **kw_j)
        with pytest.raises(ValueError) as exc_t:
            vt.bbvi(D, log_density=model, device="cpu", dtype=torch.float64, **kw)
        assert str(exc_t.value) == str(exc_j.value)
    with pytest.raises(ValueError, match="flat"):
        vt.pathfinder(model, torch.zeros(2, D, dtype=torch.float64))
    with pytest.raises(ValueError, match=">= 1"):
        vt.pathfinder(model, torch.zeros(D, dtype=torch.float64), max_iters=0)
    with pytest.raises(ValueError, match="n_paths"):
        vt.multipath_pathfinder(model, torch.zeros(D, dtype=torch.float64))
    with pytest.raises(KeyError, match="mc"):
        # the path axis over a mesh without it: the JAX package's KeyError
        vt.multipath_pathfinder(model, torch.zeros(2, D, dtype=torch.float64),
                                mesh=type("XMesh", (), {"mesh_dim_names": ("x",)})(),
                                shard_axis="mc")
    with pytest.raises(ValueError, match=r"init_point must be \(n_paths, dim\)"):
        vt.pathfinder_init(approx, model, init_point=torch.zeros(2, D), n_paths=3)
