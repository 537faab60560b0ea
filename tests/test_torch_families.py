"""viabel_torch models, families, objectives and step rules against the
JAX package, in float64 on the CPU.

Both packages get identical inputs: parameters and base normal draws are
made with numpy and injected (the draws through the families'
``base_sampler`` hook), because JAX's threefry stream and torch's stream
never match.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_torch.convert import (params_from_jax,  # noqa: E402
                                  rmsprop_state_from_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TableNormal:
    """Base sampler handing out a fixed numpy table of standard normals,
    sliced to ``(n_samples, width)``: works under ``jit`` on the JAX side
    (a constant) and changes nothing in either package."""

    def __init__(self, table):
        self.table = table

    def normal(self, key, n_samples, width, dtype):  # the JAX hook
        return jnp.asarray(self.table[:n_samples, :width], dtype=dtype)


class TorchTableNormal(TableNormal):
    def normal(self, generator, n_samples, width, dtype, device):
        return torch.as_tensor(self.table[:n_samples, :width], dtype=dtype,
                               device=device)


def _families(kind, d, table):
    if kind == "full":
        return (vj.FullRankGaussian(d, base_sampler=TableNormal(table)),
                vt.FullRankGaussian(d, base_sampler=TorchTableNormal(table),
                                    device="cpu", dtype=torch.float64))
    return (vj.MFGaussian(d, base_sampler=TableNormal(table)),
            vt.MFGaussian(d, base_sampler=TorchTableNormal(table),
                          device="cpu", dtype=torch.float64))


def _params(approx_j, rng, scale=0.3):
    vp = np.asarray(approx_j.init_param()) + scale * rng.randn(approx_j.var_param_dim)
    return vp


RTOL = 1e-10  # same float64 formulas; only summation order differs


@pytest.mark.parametrize("kind", ["full", "mf"])
@pytest.mark.parametrize("d", [5, 130])
def test_family_methods_match_jax(kind, d):
    rng = np.random.RandomState(d)
    table = rng.randn(64, d)
    fj, ft = _families(kind, d, table)
    vp0, vp1 = _params(fj, rng), _params(fj, rng)
    tp0, tp1 = params_from_jax(vp0, ft), params_from_jax(vp1, ft)
    for a, b in zip(fj.unpack(jnp.asarray(vp0)), ft.unpack(tp0)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)
    np.testing.assert_allclose(ft.init_param().numpy(), np.asarray(fj.init_param()))
    key = jax.random.PRNGKey(0)
    xs_j = fj.sample(jnp.asarray(vp0), 10, key)
    xs_t = ft.sample(tp0, 10, None)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=RTOL)
    s_j, h_j = fj.sample_and_entropy(jnp.asarray(vp0), 10, key)
    s_t, h_t = ft.sample_and_entropy(tp0, 10, None)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL)
    np.testing.assert_allclose(float(h_t), float(h_j), rtol=RTOL)
    np.testing.assert_allclose(ft.log_density(tp1, xs_t).numpy(),
                               np.asarray(fj.log_density(jnp.asarray(vp1), xs_j)),
                               rtol=RTOL)
    np.testing.assert_allclose(float(ft.log_density(tp1, xs_t[0])),
                               float(fj.log_density(jnp.asarray(vp1), xs_j[0])),
                               rtol=RTOL)
    np.testing.assert_allclose(float(ft.kl(tp0, tp1)),
                               float(fj.kl(jnp.asarray(vp0), jnp.asarray(vp1))),
                               rtol=RTOL)
    for a, b in zip(fj.mean_and_cov(jnp.asarray(vp0)), ft.mean_and_cov(tp0)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("d", [5, 130])
def test_stl_log_density_value_and_gradient_match_jax(d):
    """The STL hook: value, and the gradient through the samples only. The
    gradient on theta's unused strict upper triangle is exactly 0 on both
    sides."""
    rng = np.random.RandomState(100 + d)
    table = rng.randn(16, d)
    fj, ft = _families("full", d, table)
    vp = _params(fj, rng, scale=0.1)
    w = rng.randn(16)

    def f_j(p):
        samples, log_q = fj.sample_and_stl_log_density(p, 7, jax.random.PRNGKey(0))
        return jnp.sum(w[:7] * log_q) + 0.1 * jnp.sum(samples**2)

    val_j, grad_j = jax.value_and_grad(f_j)(jnp.asarray(vp))
    tp = params_from_jax(vp, ft).requires_grad_(True)
    samples, log_q = ft.sample_and_stl_log_density(tp, 7, None)
    val_t = torch.sum(torch.as_tensor(w[:7]) * log_q) + 0.1 * torch.sum(samples**2)
    (grad_t,) = torch.autograd.grad(val_t, tp)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=RTOL)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=RTOL, atol=1e-12)
    upper = np.triu(np.ones((d, d), dtype=bool), 1).reshape(-1)
    assert np.all(np.asarray(grad_j)[d:][upper] == 0.0)
    assert np.all(grad_t.numpy()[d:][upper] == 0.0)


@pytest.mark.parametrize("kind,use_path_deriv", [("full", False), ("full", True),
                                                 ("mf", False), ("mf", True)])
def test_exclusive_kl_loss_and_gradient_match_jax(kind, use_path_deriv):
    """Both estimators at S=10 and after set_num_mc_samples(40)."""
    d = 5
    rng = np.random.RandomState(7)
    table = rng.randn(64, d)
    fj, ft = _families(kind, d, table)
    model_j, _ = vj.zoo.logistic_regression(dim=d, n_data=30)
    model_t, _ = vt.zoo.logistic_regression(dim=d, n_data=30, device="cpu",
                                        dtype=torch.float64)
    obj_j = vj.ExclusiveKL(fj, model_j, 10, use_path_deriv=use_path_deriv)
    obj_t = vt.ExclusiveKL(ft, model_t, 10, use_path_deriv=use_path_deriv)
    vp = _params(fj, rng, scale=0.2)
    for S in (10, 40):
        obj_j.set_num_mc_samples(S)
        obj_t.set_num_mc_samples(S)
        val_j, grad_j = obj_j.value_and_grad(jnp.asarray(vp), jax.random.PRNGKey(1))
        val_t, grad_t = obj_t.value_and_grad(params_from_jax(vp, ft), None)
        np.testing.assert_allclose(float(val_t), float(val_j), rtol=RTOL)
        np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=RTOL,
                                   atol=1e-12)


def test_zoo_log_densities_and_gradients_match_jax():
    rng = np.random.RandomState(3)
    for (m_j, d), (m_t, _) in (
            (vj.zoo.logistic_regression(dim=6, n_data=50, seed=2),
             vt.zoo.logistic_regression(dim=6, n_data=50, seed=2, device="cpu",
                                        dtype=torch.float64)),
            (vj.zoo.funnel(), vt.zoo.funnel())):
        x = rng.randn(4, d)
        lp_j, g_j = jax.value_and_grad(lambda z: jnp.sum(m_j(z)))(jnp.asarray(x))
        xt = torch.as_tensor(x).requires_grad_(True)
        lp_t = m_t(xt)
        (g_t,) = torch.autograd.grad(lp_t.sum(), xt)
        np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(m_j(jnp.asarray(x))),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(lp_t.detach().sum()), float(lp_j), rtol=1e-12)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)


@pytest.mark.parametrize("rule", ["RMSProp", "AveragedRMSProp"])
def test_step_rules_match_jax_over_five_steps(rule):
    """Direction and state, rtol 1e-12 (identical elementwise formulas)."""
    rng = np.random.RandomState(11)
    opt_j, opt_t = getattr(vj, rule)(0.1), getattr(vt, rule)(0.1)
    st_j = opt_j.init_state(jnp.zeros(7))
    st_t = opt_t.init_state(torch.zeros(7, dtype=torch.float64))
    for _ in range(5):
        g = rng.randn(7)
        dir_j, st_j = opt_j.descent_direction(jnp.asarray(g), st_j)
        dir_t, st_t = opt_t.descent_direction(torch.as_tensor(g), st_t)
        np.testing.assert_allclose(dir_t.numpy(), np.asarray(dir_j), rtol=1e-12)
        conv = rmsprop_state_from_jax(st_j, device="cpu")
        np.testing.assert_allclose(st_t["avg_grad_sq"].numpy(),
                                   conv["avg_grad_sq"].numpy(), rtol=1e-12)
        assert st_t["t"] == conv["t"]


def test_plain_rmsprop_optimize_matches_jax():
    """bbvi's non-adaptive route (fixed_lr RMSProp with iterate averaging)
    under injected draws: the same trajectory, rtol 1e-10."""
    d = 3
    table = np.random.RandomState(0).randn(10, d)
    fj, ft = _families("full", d, table)
    model_j, _ = vj.zoo.logistic_regression(dim=d, n_data=20)
    model_t, _ = vt.zoo.logistic_regression(dim=d, n_data=20, device="cpu",
                                        dtype=torch.float64)
    res_j = vj.bbvi(d, objective=vj.ExclusiveKL(fj, model_j, 10), n_iters=60,
                    adaptive=False, fixed_lr=True, learning_rate=0.01)
    res_t = vt.bbvi(d, objective=vt.ExclusiveKL(ft, model_t, 10), n_iters=60,
                    adaptive=False, fixed_lr=True, learning_rate=0.01)
    for name in ("value_history", "opt_param", "variational_param_history",
                 "descent_dir_history"):
        np.testing.assert_allclose(res_t[name].numpy(), np.asarray(res_j[name]),
                                   rtol=1e-10, atol=1e-13)


def test_convert_checks_layouts():
    ft = vt.FullRankGaussian(3, device="cpu", dtype=torch.float64)
    assert params_from_jax(np.arange(12.0), ft).shape == (12,)
    with pytest.raises(ValueError):
        params_from_jax(np.arange(6.0), ft)
    with pytest.raises(ValueError):
        params_from_jax(np.arange(5.0), vt.MFGaussian(3, device="cpu"))
    with pytest.raises(ValueError):
        vt.convert.ring_from_jax(np.zeros((4, 8, 1)), 9, device="cpu")


def test_control_variates_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.ExclusiveKL(vt.MFGaussian(2, device="cpu"), vt.zoo.funnel()[0], 10,
                       hessian_approx_method="full")


def _zoo_pairs():
    cpu = dict(device="cpu", dtype=torch.float64)
    mean, sd = np.array([0.5, -1.0, 2.0]), np.array([1.0, 0.3, 2.5])
    means = ((-3.0, -3.0, 0.0), (3.0, 3.0, 1.0))
    return {
        "correlated_gaussian": (vj.zoo.correlated_gaussian(4, 0.7)[:2],
                                vt.zoo.correlated_gaussian(4, 0.7, **cpu)[:2]),
        "diagonal_gaussian": (vj.zoo.diagonal_gaussian(mean, sd),
                              vt.zoo.diagonal_gaussian(mean, sd, **cpu)),
        "gaussian_mixture": (vj.zoo.gaussian_mixture(means, 1.5, (1.0, 3.0))[:2],
                             vt.zoo.gaussian_mixture(means, 1.5, (1.0, 3.0), **cpu)[:2]),
        "robust_regression": (vj.zoo.robust_regression(n_data=30),
                              vt.zoo.robust_regression(n_data=30, **cpu)),
        "eight_schools": (vj.zoo.eight_schools(), vt.zoo.eight_schools(**cpu)),
    }


@pytest.mark.parametrize("name", ["correlated_gaussian", "diagonal_gaussian",
                                  "gaussian_mixture", "robust_regression",
                                  "eight_schools"])
def test_new_zoo_targets_match_jax(name):
    """Log density and gradient of each target the port added, rtol 1e-12
    (the same float64 formulas on the same numpy-made data)."""
    (m_j, d), (m_t, d_t) = _zoo_pairs()[name]
    assert d_t == d
    x = np.random.RandomState(17).randn(5, d)
    lp_j, g_j = jax.value_and_grad(lambda z: jnp.sum(m_j(z)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    lp_t = m_t(xt)
    (g_t,) = torch.autograd.grad(lp_t.sum(), xt)
    np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(m_j(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12, atol=1e-14)
    if name in ("correlated_gaussian", "gaussian_mixture"):
        info_j = getattr(vj.zoo, name)(*(() if name == "gaussian_mixture" else (4, 0.7)))[2]
        info_t = getattr(vt.zoo, name)(*(() if name == "gaussian_mixture" else (4, 0.7)),
                                       device="cpu", dtype=torch.float64)[2]
        for key, value in info_j.items():
            np.testing.assert_allclose(np.asarray(info_t[key]), np.asarray(value))
