"""viabel_torch's Student-t and low-rank families, its density helpers and
its generator-driven samplers against the JAX package, in float64 on the
CPU.

Deterministic methods take the same numpy-made parameters on both sides;
draws go in through the families' ``base_sampler`` hook where the JAX
family has one. ``MFStudentT`` and the pseudo-random ``MultivariateT``
path draw from ``jax.random.t``/``chisquare`` on the JAX side, which no
hook reaches, so the port's samplers are held to their moments instead.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_tpu.distributions import multivariate_t_logpdf as jax_t_logpdf  # noqa: E402
from viabel_torch.convert import params_from_jax  # noqa: E402
from viabel_torch.utils import chisquare, standard_gamma  # noqa: E402
from test_torch_families import TableNormal, TorchTableNormal  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10  # the same float64 formulas; only summation order differs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DF = 9.0
K = 3


def families(kind, d, table=None):
    """The same family on both sides; ``table`` feeds the base sampler
    where the family has one."""
    smp_j = TableNormal(table) if table is not None else None
    smp_t = TorchTableNormal(table) if table is not None else None
    if kind == "mft":
        return vj.MFStudentT(d, DF), vt.MFStudentT(d, DF, **CPU)
    if kind == "mvt":
        return (vj.MultivariateT(d, DF, base_sampler=smp_j),
                vt.MultivariateT(d, DF, base_sampler=smp_t, **CPU))
    return (vj.LRGaussian(d, K, base_sampler=smp_j),
            vt.LRGaussian(d, K, base_sampler=smp_t, **CPU))


def params(fj, rng, scale=0.3):
    return np.asarray(fj.init_param()) + scale * rng.randn(fj.var_param_dim)


def close(a, b, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(a.detach()) if torch.is_tensor(a) else a,
                               np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["mft", "mvt", "lr"])
@pytest.mark.parametrize("d", [5, 130])
def test_family_methods_match_jax(kind, d):
    """unpack, entropy, log density (batch and one point), mean and
    covariance, the 2nd and 4th moments, and where the family has them
    the injected samples, the fused sample-and-entropy, ``mean_and_stdevs``
    and the closed-form KL; rtol 1e-10."""
    rng = np.random.RandomState(d)
    table = rng.randn(64, d + int(DF) + K)
    fj, ft = families(kind, d, None if kind == "mft" else table)
    vp0, vp1 = params(fj, rng), params(fj, rng)
    tp0, tp1 = params_from_jax(vp0, ft), params_from_jax(vp1, ft)
    for a, b in zip(fj.unpack(jnp.asarray(vp0)), ft.unpack(tp0)):
        close(b, a)
    if kind != "lr":  # LRGaussian's init draws B (see the departure test)
        close(ft.init_param(), fj.init_param(), rtol=0, atol=0)
    close(ft.entropy(tp0), fj.entropy(jnp.asarray(vp0)))
    x = vp1[:d] + rng.randn(11, d)
    close(ft.log_density(tp0, torch.as_tensor(x)), fj.log_density(jnp.asarray(vp0), x))
    close(ft.log_density(tp0, torch.as_tensor(x[0])),
          fj.log_density(jnp.asarray(vp0), x[0]))
    for a, b in zip(fj.mean_and_cov(jnp.asarray(vp0)), ft.mean_and_cov(tp0)):
        close(b, a)
    for p in (2, 4):
        close(ft.pth_moment(tp0, p), fj.pth_moment(jnp.asarray(vp0), p))
    if kind == "mft":
        for a, b in zip(fj.mean_and_stdevs(jnp.asarray(vp0)), ft.mean_and_stdevs(tp0)):
            close(b, a)
        return
    key = None  # the table ignores the key
    close(ft.sample(tp0, 10, None), fj.sample(jnp.asarray(vp0), 10, key))
    s_j, h_j = fj.sample_and_entropy(jnp.asarray(vp0), 10, key)
    s_t, h_t = ft.sample_and_entropy(tp0, 10, None)
    close(s_t, s_j)
    close(h_t, h_j)
    if kind == "lr":
        close(ft.kl(tp0, tp1), fj.kl(jnp.asarray(vp0), jnp.asarray(vp1)))
        close(ft.kl(tp0, tp0), 0.0, atol=1e-10)


@pytest.mark.parametrize("kind", ["mvt", "lr"])
@pytest.mark.parametrize("d", [5, 130])
def test_stl_log_density_value_and_gradient_match_jax(kind, d):
    """The fused STL hook: its value, and the gradient through the samples
    only (MultivariateT's scaled score through the STL solve, LRGaussian's
    Woodbury solve); rtol 1e-10."""
    rng = np.random.RandomState(200 + d)
    table = rng.randn(16, d + int(DF) + K)
    fj, ft = families(kind, d, table)
    vp = params(fj, rng, scale=0.1)
    w = rng.randn(16)

    def f_j(p):
        samples, log_q = fj.sample_and_stl_log_density(p, 7, None)
        return jnp.sum(w[:7] * log_q) + 0.1 * jnp.sum(samples**2)

    val_j, grad_j = jax.value_and_grad(f_j)(jnp.asarray(vp))
    tp = params_from_jax(vp, ft).requires_grad_(True)
    samples, log_q = ft.sample_and_stl_log_density(tp, 7, None)
    val_t = torch.sum(torch.as_tensor(w[:7]) * log_q) + 0.1 * torch.sum(samples**2)
    (grad_t,) = torch.autograd.grad(val_t, tp)
    close(val_t, val_j)
    close(grad_t, grad_j, atol=1e-12)
    # the hook's value is the log density at the samples
    close(log_q, ft.log_density(tp.detach(), samples.detach()))


def _scale_matrix(rng, d, rank=None):
    A = rng.randn(d, rank or d)
    return A @ A.T / d + (0.0 if rank else 0.5 * np.eye(d))


@pytest.mark.parametrize("df", [4.5, math.inf])
@pytest.mark.parametrize("allow_singular", [False, True])
@pytest.mark.parametrize("d", [5, 130])
def test_multivariate_t_logpdf_matches_jax(d, allow_singular, df):
    """Finite and infinite df, Cholesky and eigendecomposition routes, a
    batch and a single point; rtol 1e-10 (the eigh route 1e-9: two
    LAPACK eigendecompositions agree to round-off scaled by the spread)."""
    rng = np.random.RandomState(d + 7)
    m = rng.randn(d)
    S = _scale_matrix(rng, d)
    x = m + rng.randn(6, d)
    rtol = 1e-9 if allow_singular else RTOL
    want = jax_t_logpdf(jnp.asarray(x), jnp.asarray(m), jnp.asarray(S), df=df,
                        allow_singular=allow_singular)
    got = vt.multivariate_t_logpdf(torch.as_tensor(x), torch.as_tensor(m),
                                   torch.as_tensor(S), df=df,
                                   allow_singular=allow_singular)
    close(got, want, rtol=rtol)
    one = vt.multivariate_t_logpdf(torch.as_tensor(x[0]), torch.as_tensor(m),
                                   torch.as_tensor(S), df=df,
                                   allow_singular=allow_singular)
    assert one.shape == (1,)
    close(one, np.asarray(want)[:1], rtol=rtol)


def test_multivariate_t_logpdf_rank_deficient_scale_matches_jax():
    """A rank-2 scale matrix in 5 dimensions needs ``allow_singular``: the
    pseudo-inverse and pseudo-determinant agree with the JAX package's,
    rtol 1e-9."""
    rng = np.random.RandomState(3)
    d = 5
    S = _scale_matrix(rng, d, rank=2)
    m = rng.randn(d)
    x = m + rng.randn(4, d)
    want = jax_t_logpdf(jnp.asarray(x), jnp.asarray(m), jnp.asarray(S), df=6.0,
                        allow_singular=True)
    got = vt.multivariate_t_logpdf(torch.as_tensor(x), torch.as_tensor(m),
                                   torch.as_tensor(S), df=6.0, allow_singular=True)
    close(got, want, rtol=1e-9)


def test_multivariate_normal_logpdf_matches_jax():
    rng = np.random.RandomState(11)
    d = 7
    m, S = rng.randn(d), _scale_matrix(rng, d)
    x = m + rng.randn(5, d)
    close(vt.multivariate_normal_logpdf(torch.as_tensor(x), torch.as_tensor(m),
                                        torch.as_tensor(S)),
          vj.distributions.multivariate_normal_logpdf(jnp.asarray(x), jnp.asarray(m),
                                                      jnp.asarray(S)))


def _mean_within(x, want, n_se=5.0):
    """``x``'s column means within ``n_se`` standard errors of ``want``."""
    x = np.asarray(x)
    se = x.std(axis=0, ddof=1) / np.sqrt(x.shape[0])
    assert np.all(np.abs(x.mean(axis=0) - want) < n_se * se), (x.mean(axis=0), want, se)


N_DRAWS = 40000


@pytest.mark.parametrize("df", [9.0, 12.5])
def test_mfstudentt_sample_moments(df):
    """Integer and fractional df: each coordinate's mean is mu and its
    variance sigma^2 df/(df - 2), within 5 standard errors at 40,000
    draws (the second moment's error from the draws' own squares)."""
    d = 3
    ft = vt.MFStudentT(d, df, **CPU)
    mu, sigma = np.array([0.5, -1.0, 2.0]), np.array([1.0, 0.3, 2.5])
    vp = torch.as_tensor(np.concatenate([mu, np.log(sigma)]))
    x = ft.sample(vp, N_DRAWS, torch.Generator().manual_seed(0)).numpy()
    _mean_within(x, mu)
    _mean_within((x - mu) ** 2, sigma**2 * df / (df - 2.0))


def test_multivariatet_pseudo_random_sample_moments():
    """Without a base sampler: mean mu and covariance df/(df - 2) L L^T,
    each entry of the second moment within 5 standard errors at 40,000
    draws."""
    d, df = 3, 11.0
    ft = vt.MultivariateT(d, df, **CPU)
    rng = np.random.RandomState(5)
    mu = rng.randn(d)
    theta = np.tril(0.3 * rng.randn(d, d), -1) + np.diag([0.1, -0.2, 0.3])
    vp = torch.as_tensor(np.concatenate([mu, theta.reshape(-1)]))
    x = ft.sample(vp, N_DRAWS, torch.Generator().manual_seed(1)).numpy()
    _mean_within(x, mu)
    dev = x - mu
    outer = (dev[:, :, None] * dev[:, None, :]).reshape(N_DRAWS, -1)
    _mean_within(outer, ft.mean_and_cov(vp)[1].numpy().reshape(-1))


@pytest.mark.parametrize("shape_param", [0.4, 2.75])
def test_standard_gamma_moments(shape_param):
    """The Marsaglia-Tsang sampler, both branches (shape below 1 is
    boosted): mean and variance equal the shape, within 5 standard errors
    at 40,000 draws; every draw positive and finite."""
    g = standard_gamma(torch.Generator().manual_seed(2), shape_param, (N_DRAWS,),
                       torch.float64, "cpu").numpy()
    assert np.all(np.isfinite(g)) and np.all(g > 0)
    _mean_within(g[:, None], shape_param)
    _mean_within(((g - shape_param) ** 2)[:, None], shape_param)


@pytest.mark.parametrize("df", [3.0, 7.5])
def test_chisquare_moments(df):
    """Integer df (a sum of squared normals) and fractional df (2 Gamma(df
    / 2)): mean df and variance 2 df within 5 standard errors."""
    c = chisquare(torch.Generator().manual_seed(3), df, (N_DRAWS,), torch.float64,
                  "cpu").numpy()
    _mean_within(c[:, None], df)
    _mean_within(((c - df) ** 2)[:, None], 2.0 * df)


def test_samplers_use_only_the_callers_generator():
    """No draw touches torch's global stream, and one seed gives one
    stream of draws."""
    torch.manual_seed(123)
    before = torch.random.get_rng_state()
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        vp_mf = vt.MFStudentT(4, 7.5, **CPU).init_param()
        mvt = vt.MultivariateT(4, 7.5, **CPU)
        lr = vt.LRGaussian(4, 2, **CPU)
        draws.append(torch.cat([
            vt.MFStudentT(4, 7.5, **CPU).sample(vp_mf, 5, gen).reshape(-1),
            mvt.sample(mvt.init_param(), 5, gen).reshape(-1),
            lr.sample(lr.init_param(), 5, gen).reshape(-1),
            standard_gamma(gen, 0.7, (50,), torch.float64, "cpu")]))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(draws[0], draws[1])


def test_lrgaussian_init_is_a_seeded_torch_draw():
    """Departure from the JAX package: B ~ N(0, 1) from a torch generator
    seeded with 1 (JAX's PRNGKey(1) stream cannot be reproduced), so the
    two packages start from different B; mu = 0 and log_sigma = 1 agree."""
    d, k = 6, 2
    ft, fj = vt.LRGaussian(d, k, **CPU), vj.LRGaussian(d, k)
    got, want = ft.init_param(), np.asarray(fj.init_param())
    B = torch.randn(d * k, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    assert torch.equal(got[2 * d:], B)
    np.testing.assert_array_equal(got[:2 * d].numpy(), want[:2 * d])
    assert not np.allclose(got[2 * d:].numpy(), want[2 * d:])
    assert torch.equal(ft.init_param(torch.Generator().manual_seed(4))[2 * d:],
                       torch.randn(d * k, generator=torch.Generator().manual_seed(4),
                                   dtype=torch.float64))


def test_constructors_check_as_jax_does():
    for cls in (vt.MFStudentT, vt.MultivariateT):
        with pytest.raises(ValueError, match="df must be greater than 2"):
            cls(3, 2.0, **CPU)
    with pytest.raises(ValueError, match="integer df"):
        vt.MultivariateT(3, 4.5, base_sampler=TorchTableNormal(np.zeros((1, 8))), **CPU)
    with pytest.raises(TypeError):
        vt.LRGaussian(3, **CPU)  # k is required
    ft = vt.MFStudentT(3, 3.5, **CPU)
    assert ft.supports_pth_moment(2) and not ft.supports_pth_moment(4)
    with pytest.raises(ValueError):
        ft.pth_moment(ft.init_param(), 4)
    assert not ft.supports_kl and not vt.MultivariateT(3, 5.0, **CPU).supports_kl
    assert vt.LRGaussian(3, 1, **CPU).supports_kl
