"""viabel_torch.diagnostics and the vi_diagnostics front door against the
JAX package, in float64 on the CPU.

Both packages see the same draws: samples come through the families'
table-normal base sampler, the KSD test's null draws are JAX's own draws
handed to the port's null sampler in the order JAX makes them, and the
subsampled pairs are JAX's index draws handed to the port's pair hook.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_tpu import diagnostics as dj  # noqa: E402
from viabel_torch import diagnostics as dt  # noqa: E402
from viabel_torch.convert import params_from_jax  # noqa: E402

RTOL = 1e-8  # same float64 formulas; sums in another order

pytestmark = pytest.mark.filterwarnings("ignore:the Monte Carlo error")


class TableNormal:
    """Base sampler handing out a fixed numpy table of standard normals."""

    def __init__(self, table):
        self.table = table

    def normal(self, key, n_samples, width, dtype):  # the JAX hook
        return jnp.asarray(self.table[:n_samples, :width], dtype=dtype)


class TorchTableNormal(TableNormal):
    def normal(self, generator, n_samples, width, dtype, device):
        return torch.as_tensor(self.table[:n_samples, :width], dtype=dtype,
                               device=device)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def _log_weights(n, var_p, var_q, seed):
    x = np.random.RandomState(seed).randn(n) * np.sqrt(var_q)
    lw = (-0.5 * x**2 / var_p - 0.5 * np.log(var_p)
          + 0.5 * x**2 / var_q + 0.5 * np.log(var_q))
    return x, lw


@pytest.mark.parametrize("log_norm_bound", [None, 0.0])
def test_all_diagnostics_and_bounds_match_jax(log_norm_bound):
    x, lw = _log_weights(20000, 2.5, 9.3, seed=1639)
    res_j = dj.all_diagnostics(jnp.asarray(lw), samples=jnp.asarray(x), q_var=9.3,
                               log_norm_bound=log_norm_bound)
    res_t = dt.all_diagnostics(torch.as_tensor(lw), samples=torch.as_tensor(x),
                               q_var=9.3, log_norm_bound=log_norm_bound)
    assert set(res_t) == set(res_j)
    for name in res_j:
        _close(res_t[name], res_j[name])
    # sample covariance and moments from 2-D samples, a p_var and its norm
    xs = np.random.RandomState(2).randn(3000, 3) * [1.0, 2.0, 0.5]
    _, lw2 = _log_weights(3000, 1.0, 1.3, seed=3)
    p_var = np.diag([1.0, 3.0, 0.2])
    res_j = dj.all_diagnostics(jnp.asarray(lw2), samples=jnp.asarray(xs),
                               p_var=jnp.asarray(p_var))
    res_t = dt.all_diagnostics(torch.as_tensor(lw2), samples=torch.as_tensor(xs),
                               p_var=torch.as_tensor(p_var))
    for name in res_j:
        _close(res_t[name], res_j[name])


def test_divergence_wasserstein_and_error_bounds_match_jax():
    x, lw = _log_weights(20000, 4.0, 16.0, seed=846)
    for alpha in (1.5, 2.0, 3.0):
        for elbo in (None, 0.0):
            _close(dt.divergence_bound(torch.as_tensor(lw), alpha=alpha,
                                       log_norm_bound=elbo),
                   dj.divergence_bound(jnp.asarray(lw), alpha=alpha,
                                       log_norm_bound=elbo))
    with pytest.raises(ValueError):
        dt.divergence_bound(torch.as_tensor(lw), alpha=1.0)
    w_j = dj.wasserstein_bounds(0.3, samples=jnp.asarray(x))
    w_t = dt.wasserstein_bounds(0.3, samples=torch.as_tensor(x))
    for name in ("W1", "W2"):
        _close(w_t[name], w_j[name])
    with pytest.raises(ValueError):
        dt.wasserstein_bounds(0.3)
    q_var = np.array([[2.0, 0.3], [0.3, 1.0]])
    for kwargs in (dict(W1=0.2, W2=0.5, q_var=q_var), dict(W2=0.5, q_var=2.0, p_var=1.5),
                   dict(W1=0.2)):
        e_j = dj.error_bounds(**{k: jnp.asarray(v) for k, v in kwargs.items()})
        e_t = dt.error_bounds(**{k: torch.as_tensor(np.asarray(v, dtype=float))
                                 for k, v in kwargs.items()})
        for name in e_j:
            _close(e_t[name], e_j[name])


def _aniso():
    sd = np.array([1.0, 2.0, 0.5])

    def logp_j(x):
        return -0.5 * jnp.sum((x / sd) ** 2, axis=-1)

    def logp_t(x):
        return -0.5 * torch.sum((x / torch.as_tensor(sd)) ** 2, dim=-1)

    return logp_j, logp_t, sd


@pytest.mark.parametrize("use_u_statistic", [True, False])
@pytest.mark.parametrize("block_size", [None, 16])
def test_ksd_matches_jax(use_u_statistic, block_size):
    """V and U statistics, blocked and unblocked, model (autograd score)
    and score_fn paths, squared and not: rtol 1e-9."""
    logp_j, logp_t, sd = _aniso()
    x = np.random.RandomState(0).randn(64, 3) * sd + 0.4
    kw = dict(c=1.3, beta=-0.5, use_u_statistic=use_u_statistic,
              block_size=block_size)
    for squared in (False, True):
        want = dj.ksd(jnp.asarray(x), model=logp_j, squared=squared, **kw)
        _close(dt.ksd(torch.as_tensor(x), model=logp_t, squared=squared, **kw), want,
               rtol=1e-9)
        _close(dt.ksd(torch.as_tensor(x), score_fn=lambda z: -z / torch.as_tensor(sd**2),
                      squared=squared, **kw), want, rtol=1e-9)


def test_ksd_arg_validation():
    _, logp_t, _ = _aniso()
    x = torch.zeros(8, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="exactly one"):
        dt.ksd(x)
    with pytest.raises(ValueError, match="block_size"):
        dt.ksd(x, model=logp_t, block_size=3)
    with pytest.raises(ValueError, match="n >= 2"):
        dt.ksd(x[:1], model=logp_t)
    with pytest.raises(ValueError, match="no V-statistic"):
        dt.ksd(x, model=logp_t, subsample_pairs=8, generator=torch.Generator(),
               use_u_statistic=False)
    with pytest.raises(ValueError, match="generator"):
        dt.ksd(x, model=logp_t, subsample_pairs=8)


def _jax_pairs(key, n, m):
    """The pairs viabel_tpu.diagnostics._ksd_pairs_core draws from ``key``."""
    key_i, key_off = jax.random.split(jnp.asarray(key))
    i = jax.random.randint(key_i, (m,), 0, n)
    off = jax.random.randint(key_off, (m,), 1, n)
    return torch.tensor(np.asarray(i)), torch.tensor(np.asarray((i + off) % n))


@pytest.mark.parametrize("chunk", [None, 64, 250])
def test_ksd_subsampled_pairs_match_jax(chunk):
    """The incomplete U-statistic over JAX's pairs, whole and chunked
    (a ragged last chunk included): rtol 1e-9."""
    x = np.random.RandomState(4).randn(64, 5)
    key = jax.random.PRNGKey(1)
    want = dj._ksd_pairs_core(jnp.asarray(x), -jnp.asarray(x), key, 1000, c=1.0,
                              beta=-0.5, chunk=chunk)
    i, j = _jax_pairs(key, 64, 1000)
    xt = torch.as_tensor(x)
    _close(dt._ksd_pairs_core(xt, -xt, i, j, c=1.0, beta=-0.5, chunk=chunk), want,
           rtol=1e-9)
    # the port's own pair draws: i != j, both in range
    i, j = dt._draw_pairs(torch.Generator().manual_seed(0), 64, 5000, "cpu")
    assert bool(torch.all(i != j)) and int(i.min()) >= 0 and int(j.max()) < 64


@pytest.mark.parametrize("subsample_pairs", [None, 2048])
@pytest.mark.parametrize("shift", [0.0, 1.5])
def test_ksd_test_matches_jax_on_the_same_draws(monkeypatch, subsample_pairs, shift):
    """Statistic, null replicates, p-value and verdict, on JAX's null draws
    and pairs in JAX's order."""
    logp_j, logp_t, sd = _aniso()
    n, d, n_null = 256, 3, 19
    key = jax.random.PRNGKey(11)

    def sample_j(k):
        return jax.random.normal(k, (n, d)) * sd + shift

    obs = np.array(sample_j(jax.random.PRNGKey(99)))
    res_j = dj.ksd_test(jnp.asarray(obs), model=logp_j, null_sampler=sample_j,
                        null_score_fn=jax.grad(lambda x: jnp.sum(logp_j(x - shift))),
                        key=key, n_null=n_null, subsample_pairs=subsample_pairs)

    key_obs, key_null = jax.random.split(key)
    null_keys = [jax.random.split(k) for k in jax.random.split(key_null, n_null)]
    draws = iter([torch.tensor(np.asarray(sample_j(kd))) for kd, _ in null_keys])
    if subsample_pairs is not None:
        pairs = iter([_jax_pairs(k, n, subsample_pairs)
                      for k in [key_obs] + [kp for _, kp in null_keys]])
        monkeypatch.setattr(dt, "_draw_pairs", lambda *args: next(pairs))
    res_t = dt.ksd_test(torch.as_tensor(obs), model=logp_t,
                        null_sampler=lambda g: next(draws),
                        null_score_fn=lambda x: -(x - shift) / torch.as_tensor(sd**2),
                        generator=torch.Generator(), n_null=n_null,
                        subsample_pairs=subsample_pairs)
    for name in ("ksd", "ksd_squared", "null_squared"):
        _close(res_t[name], res_j[name], rtol=1e-9)
    for name in ("p_value", "reject", "valid"):
        assert res_t[name] == res_j[name], name
    assert res_t["null_squared"].shape == (n_null,)


def test_ksd_test_invalid_on_nonfinite_statistic():
    _, logp_t, sd = _aniso()
    draws = torch.randn(64, 3, generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64) * torch.as_tensor(sd)
    draws[0, 0] = float("nan")
    res = dt.ksd_test(draws, model=logp_t, null_sampler=lambda g: draws.nan_to_num(),
                      null_score_fn=lambda x: -x / torch.as_tensor(sd**2),
                      generator=torch.Generator(), n_null=5)
    assert not res["valid"] and np.isnan(res["p_value"]) and not res["reject"]


def _mf_param(rng, d):
    """A mean-field fit of N(0, I): mu near 0, log_sigma near 0."""
    return np.concatenate([0.05 * rng.randn(d), 0.02 * rng.randn(d)])


def _full_param(rng, d, cov, scale):
    L = scale * np.linalg.cholesky(cov)
    theta = np.tril(L, -1) + np.diag(np.log(np.diag(L)))
    theta += np.triu(rng.randn(d, d), 1)  # never read
    return np.concatenate([0.05 * rng.randn(d), theta.reshape(-1)])


def _run_both(capsys, approx_j, approx_t, vp, model_j, model_t, **kwargs):
    res_j = vj.vi_diagnostics(jnp.asarray(vp), model=model_j, approx=approx_j,
                              key=jax.random.PRNGKey(0), **kwargs)
    out_j = capsys.readouterr().out
    res_t = vt.vi_diagnostics(params_from_jax(vp, approx_t), model=model_t,
                              approx=approx_t, generator=torch.Generator(), **kwargs)
    out_t = capsys.readouterr().out
    assert out_t == out_j  # the same gates print the same lines
    assert set(res_t) == set(res_j)
    for name, value in res_j.items():
        if name in ("ksd_p_value", "ksd_reject", "ksd_valid"):
            assert res_t[name] == value, name
        else:
            _close(res_t[name], value, atol=1e-12)
    return res_t


@pytest.mark.parametrize("case,stdev", [("narrow", 1.0), ("wide", 3.0),
                                        ("wider_q", 0.5)])
def test_vi_diagnostics_mf_matches_jax(capsys, case, stdev):
    """tests/test_convenience.py's three cases on one mean-field fit of
    N(0, I): the target itself (bounds), a 3x wider target (khat > 0.7, the
    KSD test) and a 2x narrower one (negative khat, large d2)."""
    d, n = 2, 4000
    rng = np.random.RandomState(153)
    table = rng.randn(n, d)
    vp = _mf_param(rng, d)
    model_j, _ = vj.zoo.diagonal_gaussian(np.zeros(d), stdev * np.ones(d))
    model_t, _ = vt.zoo.diagonal_gaussian(np.zeros(d), stdev * np.ones(d),
                                          device="cpu", dtype=torch.float64)
    res = _run_both(capsys, vj.MFGaussian(d, base_sampler=TableNormal(table)),
                    vt.MFGaussian(d, base_sampler=TorchTableNormal(table),
                                  device="cpu", dtype=torch.float64),
                    vp, model_j, model_t, n_samples=n)
    khat = float(res["khat"])
    if case == "narrow":
        assert khat < 0.7 and float(res["d2"]) < 0.1
    elif case == "wide":
        assert khat > 0.7 and "d2" not in res and res["ksd_reject"]
    else:
        assert khat < 0 and float(res["d2"]) > 2


@pytest.mark.parametrize("target", ["correlated", "wide"])
def test_vi_diagnostics_full_rank_matches_jax(capsys, target):
    """FullRankGaussian (d=6): q = 1.05 chol(cov) against the correlated
    target (bounds through pth_moment and the spectral norm of q_var), and
    against a 3x wider diagonal target (the KSD test, whose null scores
    run the solve's adjoint); the KSD test's 512-row blocks included."""
    d, n = 6, 3000
    rng = np.random.RandomState(8)
    table = rng.randn(n, d)
    cov = 0.8 ** np.abs(np.arange(d)[:, None] - np.arange(d)[None, :])
    vp = _full_param(rng, d, cov, 1.05)
    if target == "correlated":
        model_j, _, _ = vj.zoo.correlated_gaussian(d, 0.8)
        model_t, _, _ = vt.zoo.correlated_gaussian(d, 0.8, device="cpu",
                                                   dtype=torch.float64)
    else:
        model_j, _ = vj.zoo.diagonal_gaussian(np.zeros(d), 3.0 * np.ones(d))
        model_t, _ = vt.zoo.diagonal_gaussian(np.zeros(d), 3.0 * np.ones(d),
                                              device="cpu", dtype=torch.float64)
    res = _run_both(capsys, vj.FullRankGaussian(d, base_sampler=TableNormal(table)),
                    vt.FullRankGaussian(d, base_sampler=TorchTableNormal(table),
                                        device="cpu", dtype=torch.float64),
                    vp, model_j, model_t, n_samples=n, ksd_null=5)
    assert ("d2" in res) == (target == "correlated")


def test_vi_diagnostics_objective_and_ksd_off():
    """An objective carries model and family; ksd_samples=0 turns the
    KSD test off; the generator defaults to seed 0 on the family's device."""
    d = 2
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(d), 3.0 * np.ones(d), device="cpu",
                                        dtype=torch.float64)
    approx = vt.MFGaussian(d, device="cpu", dtype=torch.float64)
    obj = vt.ExclusiveKL(approx, model, 10)
    vp = torch.zeros(2 * d, dtype=torch.float64)
    res = vt.vi_diagnostics(vp, objective=obj, n_samples=20000, ksd_samples=0)
    assert float(res["khat"]) > 0.7 and "ksd" not in res
    again = vt.vi_diagnostics(vp, objective=obj, n_samples=20000, ksd_samples=0)
    assert torch.equal(res["samples"], again["samples"])


def test_vi_diagnostics_arg_validation():
    with pytest.raises(ValueError):
        vt.vi_diagnostics(torch.zeros(4))
    with pytest.raises(ValueError):
        vt.vi_diagnostics(torch.zeros(4), objective=object(), model=object())
    approx = vt.MFGaussian(2, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError):
        vt.vi_diagnostics(torch.zeros(4), model=lambda x: x[:, 0], approx=approx,
                          n_samples=0)
