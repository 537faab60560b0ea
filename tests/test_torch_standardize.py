"""viabel_torch's affine fold (``fold_affine``, ``pack``), the mean-field
pilot (``pilot_standardize``) and ``bbvi(standardize=True)`` against the
JAX package, in float64 on the CPU.

The pilot's family is built inside ``pilot_standardize``; both packages'
``MFGaussian`` are wrapped there so that the pilot draws its base normals
from one numpy table.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_tpu.convenience as jconv  # noqa: E402
import viabel_torch.convenience as tconv  # noqa: E402
from test_torch_families import TableNormal, TorchTableNormal  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
D = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAMILIES = {
    "mf_gaussian": lambda pkg, **kw: pkg.MFGaussian(D, **kw),
    "mf_student_t": lambda pkg, **kw: pkg.MFStudentT(D, 20, **kw),
    "full_rank": lambda pkg, **kw: pkg.FullRankGaussian(D, **kw),
    "multivariate_t": lambda pkg, **kw: pkg.MultivariateT(D, 30, **kw),
    "lr_gaussian": lambda pkg, **kw: pkg.LRGaussian(D, 2, **kw),
}


def _fold_case(name, seed=7):
    rng = np.random.RandomState(seed)
    fj, ft = FAMILIES[name](vj), FAMILIES[name](vt, **CPU)
    vp = np.asarray(fj.init_param()) + 0.3 * rng.randn(fj.var_param_dim)
    # order-of-magnitude heteroscedastic scales: the standardize use case
    return fj, ft, vp, rng.randn(D), np.exp(1.5 * rng.randn(D))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_fold_affine_matches_jax(name):
    """fold_affine on every location-scale family, with vector and scalar
    (loc, scale), equals JAX's flat vector at rtol 1e-12 (the Cholesky
    families' unused strict upper triangle included), and is the exact
    pushforward: the same base draws give ``loc + scale * x``."""
    fj, ft, vp, loc, scale = _fold_case(name)
    vpt = torch.as_tensor(vp)
    for lo, sc in ((torch.as_tensor(loc), torch.as_tensor(scale)), (0.7, 2.5)):
        want = np.asarray(fj.fold_affine(jnp.asarray(vp), np.asarray(lo), np.asarray(sc)))
        got = ft.fold_affine(vpt, lo, sc)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    if name not in ("mf_student_t", "multivariate_t"):  # their draws mix in chi2
        table = np.random.RandomState(1).randn(32, 2 * D)
        ft = FAMILIES[name](vt, base_sampler=TorchTableNormal(table), **CPU)
        folded = ft.fold_affine(vpt, torch.as_tensor(loc), torch.as_tensor(scale))
        x, y = ft.sample(vpt, 32, None), ft.sample(folded, 32, None)
        torch.testing.assert_close(y, torch.as_tensor(loc) + torch.as_tensor(scale) * x,
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_fold_unfold_round_trip(name):
    """The inverse affine ``(-loc/scale, 1/scale)`` restores the whole flat
    vector; the moments transform as the affine says."""
    _, ft, vp, loc, scale = _fold_case(name, seed=8)
    vpt, loc, scale = torch.as_tensor(vp), torch.as_tensor(loc), torch.as_tensor(scale)
    folded = ft.fold_affine(vpt, loc, scale)
    torch.testing.assert_close(ft.fold_affine(folded, -loc / scale, 1.0 / scale), vpt,
                               rtol=1e-9, atol=1e-9)
    if name == "mf_student_t":
        return  # its mean_and_cov is the closed form too, but checked above
    m, c = ft.mean_and_cov(vpt)
    m2, c2 = ft.mean_and_cov(folded)
    torch.testing.assert_close(m2, loc + scale * m, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(c2, scale[:, None] * c * scale[None, :], rtol=1e-10,
                               atol=1e-12)


def test_pack_matches_jax():
    """``_CholeskyFamily.pack(mu, L)`` inverts ``unpack`` and equals JAX's."""
    rng = np.random.RandomState(3)
    L = np.tril(rng.randn(D, D), -1) + np.diag(np.exp(rng.randn(D)))
    mu = rng.randn(D)
    for name in ("full_rank", "multivariate_t"):
        fj, ft = FAMILIES[name](vj), FAMILIES[name](vt, **CPU)
        got = ft.pack(torch.as_tensor(mu), torch.as_tensor(L))
        np.testing.assert_allclose(got.numpy(), np.asarray(fj.pack(jnp.asarray(mu),
                                                                   jnp.asarray(L))),
                                   rtol=1e-15)
        mu2, _, L2 = ft.unpack(got)
        torch.testing.assert_close(L2, torch.as_tensor(L), rtol=1e-14, atol=1e-15)
        torch.testing.assert_close(mu2, torch.as_tensor(mu), rtol=0, atol=0)


def test_neural_families_have_no_fold():
    """NeuralNet and NVPFlow inherit the base class's NotImplementedError,
    and bbvi(standardize=True) turns it into JAX's ValueError."""
    net = vt.NeuralNet([(2, 2)], last=lambda x: x, **CPU)
    flow = vt.NVPFlow([(2, 2)], [(2, 2)], torch.tensor([[1.0, 0.0]]),
                      vt.MFGaussian(2, **CPU), torch.zeros(4, dtype=torch.float64), 2)
    for family in (net, flow):
        with pytest.raises(NotImplementedError, match="affine pushforward"):
            family.fold_affine(family.init_param(), 0.0, 1.0)
    model = vt.Model(lambda x: -0.5 * torch.sum(x**2, -1))
    with pytest.raises(ValueError, match="closed-form affine"):
        vt.bbvi(2, log_density=model, approx=net, standardize=True)


def _hetero(d, seed=2):
    rng = np.random.RandomState(seed)
    return 5.0 * rng.randn(d), np.exp(rng.randn(d))  # scales span ~0.1-10x


@pytest.fixture
def injected_pilot(monkeypatch):
    """Both packages' pilot family draws from one table of normals."""
    table = np.random.RandomState(9).randn(64, D)
    monkeypatch.setattr(jconv, "MFGaussian",
                        functools.partial(vj.MFGaussian, base_sampler=TableNormal(table)))
    monkeypatch.setattr(tconv, "MFGaussian",
                        functools.partial(vt.MFGaussian, base_sampler=TorchTableNormal(table)))


def test_pilot_standardize_matches_jax(injected_pilot):
    """A 100-step pilot with injected draws: the pilot's opt_param, the
    spec's affine and the standardized model's log density equal JAX's at
    rtol 1e-10."""
    mean, sd = _hetero(D)
    model_j = vj.zoo.diagonal_gaussian(mean, sd)[0]
    model_t = vt.zoo.diagonal_gaussian(mean, sd, **CPU)[0]
    kw = dict(n_iters=100, num_mc_samples=8, learning_rate=0.05, name="theta")
    std_j, spec_j, res_j = jconv.pilot_standardize(D, model_j, key=jax.random.PRNGKey(0), **kw)
    std_t, spec_t, res_t = tconv.pilot_standardize(D, model_t, device="cpu",
                                                   dtype=torch.float64, **kw)
    np.testing.assert_allclose(res_t["opt_param"].numpy(), np.asarray(res_j["opt_param"]),
                               rtol=1e-10, atol=1e-12)
    z = np.random.RandomState(4).randn(6, D)
    np.testing.assert_allclose(spec_t.constrain(torch.as_tensor(z))["theta"].numpy(),
                               np.asarray(spec_j.constrain(jnp.asarray(z))["theta"]),
                               rtol=1e-10)
    np.testing.assert_allclose(std_t(torch.as_tensor(z)).numpy(),
                               np.asarray(std_j(jnp.asarray(z))), rtol=1e-10)
    assert std_t.spec is spec_t and spec_t.names == ["theta"]


def test_bbvi_standardize_recovers_user_space_moments():
    """bbvi(standardize=True) on a d = 6 heteroscedastic Gaussian (scales
    0.1-10x): the pilot recovers the scales, and the full-rank result,
    folded back, matches the target's mean and sd in the user's space;
    the returned objective holds the user's model."""
    d = 6
    mean, sd = _hetero(d)
    model = vt.zoo.diagonal_gaussian(mean, sd, **CPU)[0]
    res = vt.bbvi(d, log_density=model, approx=vt.FullRankGaussian(d, **CPU),
                  standardize=True, adaptive=False, fixed_lr=True, n_iters=2000,
                  num_mc_samples=20, learning_rate=0.02,
                  pilot_kwargs=dict(n_iters=3000, num_mc_samples=20),
                  RMS_kwargs=dict(diagnostics=False),
                  generator=torch.Generator().manual_seed(1))
    p_mu, p_scale = res["standardization"]["affine"]
    np.testing.assert_allclose(p_scale.numpy(), sd, rtol=0.1)
    assert res["objective"].model is model
    est_mean, est_cov = res["objective"].approx.mean_and_cov(res["opt_param"])
    est_sd = torch.sqrt(torch.diagonal(est_cov)).numpy()
    assert np.max(np.abs(est_mean.numpy() - mean) / sd) < 0.1
    assert np.max(np.abs(est_sd - sd) / sd) < 0.1
    assert set(res["standardization"]) == {"affine", "spec", "pilot_results"}


def test_pilot_validation_is_a_departure_from_jax():
    """Deliberate departure: the JAX package folds whatever its pilot
    returns (a known defect of the reference). The port raises ValueError,
    naming the pilot and pilot_kwargs, when the pilot's location or scale is
    non-finite or its scale is not positive: here a pilot at learning rate
    1e10 sends log sigma to about +-1e10."""
    mean, sd = _hetero(D)
    model = vt.zoo.diagonal_gaussian(mean, sd, **CPU)[0]
    bad = dict(n_iters=20, learning_rate=1e10)
    with pytest.raises(ValueError, match="pilot diverged.*pilot_kwargs"):
        vt.pilot_standardize(D, model, device="cpu", dtype=torch.float64, **bad)
    objective = vt.ExclusiveKL(vt.FullRankGaussian(D, **CPU), model, 10)
    with pytest.raises(ValueError, match="pilot diverged"):
        vt.bbvi(D, objective=objective, standardize=True, pilot_kwargs=bad)
    assert objective.model is model


def test_documented_elbo_offset(injected_pilot):
    """What the bbvi docstring states about value_history under
    standardize: the standardized model's log density exceeds the user's
    at the mapped point by exactly sum(log p_scale), and the folded q's
    entropy exceeds the standardized q's by the same, so the loss at a
    standardized parameter equals the user-space loss at its fold on the
    same draws. The JAX package's objects satisfy the same identities."""
    mean, sd = _hetero(D)
    model_t = vt.zoo.diagonal_gaussian(mean, sd, **CPU)[0]
    std_t, spec_t, res = tconv.pilot_standardize(D, model_t, n_iters=200, num_mc_samples=8,
                                                 device="cpu", dtype=torch.float64)
    p_mu, p_log_sigma = torch.split(res["opt_param"], D)
    p_scale = torch.exp(p_log_sigma)
    offset = float(torch.sum(torch.log(p_scale)))
    z = torch.as_tensor(np.random.RandomState(5).randn(7, D))
    torch.testing.assert_close(std_t(z) - model_t(p_mu + p_scale * z),
                               torch.full((7,), offset, dtype=torch.float64),
                               rtol=0, atol=1e-12)
    table = np.random.RandomState(6).randn(16, D)
    approx = vt.FullRankGaussian(D, base_sampler=TorchTableNormal(table), **CPU)
    vp_std = approx.init_param() + 0.1 * torch.as_tensor(
        np.random.RandomState(7).randn(approx.var_param_dim))
    vp_user = approx.fold_affine(vp_std, p_mu, p_scale)
    torch.testing.assert_close(approx.entropy(vp_user) - approx.entropy(vp_std),
                               torch.tensor(offset, dtype=torch.float64), rtol=0, atol=1e-12)
    loss_std = vt.ExclusiveKL(approx, std_t, 16).value_and_grad(vp_std, None)[0]
    loss_user = vt.ExclusiveKL(approx, model_t, 16).value_and_grad(vp_user, None)[0]
    np.testing.assert_allclose(float(loss_std), float(loss_user), rtol=1e-12)
    # the same identities in the JAX package
    model_j = vj.zoo.diagonal_gaussian(mean, sd)[0]
    std_j, _, res_j = jconv.pilot_standardize(D, model_j, n_iters=200, num_mc_samples=8,
                                              key=jax.random.PRNGKey(0))
    approx_j = vj.FullRankGaussian(D, base_sampler=TableNormal(table))
    jmu, jls = np.split(np.asarray(res_j["opt_param"]), 2)
    vpj = jnp.asarray(vp_std.numpy())
    loss_std_j = vj.ExclusiveKL(approx_j, std_j, 16).value_and_grad(
        vpj, jax.random.PRNGKey(1))[0]
    loss_user_j = vj.ExclusiveKL(approx_j, model_j, 16).value_and_grad(
        approx_j.fold_affine(vpj, jmu, np.exp(jls)), jax.random.PRNGKey(1))[0]
    np.testing.assert_allclose(float(loss_std_j), float(loss_user_j), rtol=1e-12)


def test_bbvi_restores_the_model_after_an_error():
    """A prebuilt objective gets its model back when the standardized run
    raises, as in the JAX package's ``finally``; the route's ValueErrors,
    and the multistart routes raising after the pilot."""
    mean, sd = _hetero(D)
    model = vt.zoo.diagonal_gaussian(mean, sd, **CPU)[0]
    objective = vt.ExclusiveKL(vt.MFGaussian(D, **CPU), model, 10)
    pilot = dict(n_iters=50)

    def boom(k, loss):
        raise RuntimeError("stop")

    with pytest.raises(RuntimeError, match="stop"):
        vt.bbvi(D, objective=objective, standardize=True, pilot_kwargs=pilot, n_iters=400,
                adaptive=False, fixed_lr=True, progress_callback=boom)
    assert objective.model is model
    with pytest.raises(ValueError, match="unknown init_method"):
        vt.bbvi(D, objective=objective, standardize=True, pilot_kwargs=pilot,
                init_method="lbfgs")
    assert objective.model is model
    with pytest.raises(ValueError, match="pilot_kwargs needs standardize=True"):
        vt.bbvi(D, objective=objective, pilot_kwargs=pilot)
    # the multistart routes: the pilot runs, the engine's leg raises, and
    # the model comes back
    for kw in (dict(num_restarts=2), dict(init_var_params=torch.zeros(2, 2 * D))):
        with pytest.raises(ValueError, match="progress_callback is not supported"):
            vt.bbvi(D, objective=objective, standardize=True, pilot_kwargs=pilot,
                    progress_callback=boom, **kw)
        assert objective.model is model
