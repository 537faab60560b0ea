"""viabel_torch's AlphaDivergence, IWELBO and ExclusiveKL (its control
variates and the new families) against the JAX package, in float64 on the
CPU.

Both packages draw their base normals from one numpy table through the
families' ``base_sampler`` hook, so value and gradient agree to round-off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_torch.convert import params_from_jax  # noqa: E402
from test_torch_families import TableNormal, TorchTableNormal  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10  # the same float64 formulas; only summation order differs
D = 5
DF = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def families(kind, d, table):
    smp_j, smp_t = TableNormal(table), TorchTableNormal(table)
    if kind == "full":
        return (vj.FullRankGaussian(d, base_sampler=smp_j),
                vt.FullRankGaussian(d, base_sampler=smp_t, **CPU))
    if kind == "mvt":
        return (vj.MultivariateT(d, DF, base_sampler=smp_j),
                vt.MultivariateT(d, DF, base_sampler=smp_t, **CPU))
    if kind == "lr":
        return (vj.LRGaussian(d, 2, base_sampler=smp_j),
                vt.LRGaussian(d, 2, base_sampler=smp_t, **CPU))
    return (vj.MFGaussian(d, base_sampler=smp_j),
            vt.MFGaussian(d, base_sampler=smp_t, **CPU))


def models(d=D):
    return (vj.zoo.logistic_regression(dim=d, n_data=30)[0],
            vt.zoo.logistic_regression(dim=d, n_data=30, **CPU)[0])


def setup(kind, seed, scale=0.2):
    rng = np.random.RandomState(seed)
    table = rng.randn(64, D + DF + 2)
    fj, ft = families(kind, D, table)
    vp = np.asarray(fj.init_param()) + scale * rng.randn(fj.var_param_dim)
    if kind == "mvt":  # nearer the target than Sigma = 10 I: tamer weights
        vp[D:] -= 0.5 * np.log(10.0) * np.eye(D).reshape(-1)
    return fj, ft, vp


def assert_value_and_grad_match(obj_j, obj_t, vp, ft, rtol=RTOL):
    val_j, grad_j = obj_j.value_and_grad(jnp.asarray(vp), jax.random.PRNGKey(1))
    val_t, grad_t = obj_t.value_and_grad(params_from_jax(vp, ft), None)
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=rtol)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=rtol,
                               atol=1e-12)
    return val_t, grad_t


@pytest.mark.parametrize("alpha", [0.5, 2.0])
@pytest.mark.parametrize("kind", ["full", "mvt", "lr", "mf"])
def test_alpha_divergence_matches_jax(kind, alpha):
    """The CUBO value and the reference's gradient ``alpha J^T w^alpha /
    S``, at S = 10 and after ``set_num_mc_samples(40)``; rtol 1e-10."""
    fj, ft, vp = setup(kind, 1)
    model_j, model_t = models()
    obj_j = vj.AlphaDivergence(fj, model_j, 10, alpha=alpha)
    obj_t = vt.AlphaDivergence(ft, model_t, 10, alpha=alpha)
    assert obj_t.alpha == alpha
    for S in (10, 40):
        obj_j.set_num_mc_samples(S)
        obj_t.set_num_mc_samples(S)
        assert_value_and_grad_match(obj_j, obj_t, vp, ft)


@pytest.mark.parametrize("use_dreg", [True, False])
@pytest.mark.parametrize("kind", ["full", "mvt", "lr", "mf"])
def test_iwelbo_matches_jax(kind, use_dreg):
    """DReG (through the families' STL hook) and the plain IWAE gradient,
    at S = 10 and 40; rtol 1e-10."""
    fj, ft, vp = setup(kind, 2)
    model_j, model_t = models()
    obj_j = vj.IWELBO(fj, model_j, 10, use_dreg=use_dreg)
    obj_t = vt.IWELBO(ft, model_t, 10, use_dreg=use_dreg)
    for S in (10, 40):
        obj_j.set_num_mc_samples(S)
        obj_t.set_num_mc_samples(S)
        assert_value_and_grad_match(obj_j, obj_t, vp, ft)


@pytest.mark.parametrize("kind", ["full", "mvt", "mf"])
def test_iwelbo_s1_dreg_is_exactly_stl(kind):
    """At S = 1 the DReG value and gradient are the STL ExclusiveKL's,
    bit for bit, as in the JAX package (tests/test_objectives.py:187);
    both also match the JAX package's at rtol 1e-10."""
    fj, ft, vp = setup(kind, 3)
    model_j, model_t = models()
    tp = params_from_jax(vp, ft)
    v_iw, g_iw = vt.IWELBO(ft, model_t, 1).value_and_grad(tp, None)
    v_stl, g_stl = vt.ExclusiveKL(ft, model_t, 1, use_path_deriv=True).value_and_grad(
        tp, None)
    assert torch.equal(v_iw, v_stl) and torch.equal(g_iw, g_stl)
    assert_value_and_grad_match(vj.IWELBO(fj, model_j, 1), vt.IWELBO(ft, model_t, 1),
                                vp, ft)


@pytest.mark.parametrize("use_path_deriv", [False, True])
@pytest.mark.parametrize("kind", ["mvt", "lr"])
def test_exclusive_kl_new_families_match_jax(kind, use_path_deriv):
    """The entropy form and the fused STL path on MultivariateT (the STL
    solve with the per-draw rescaling) and LRGaussian (Woodbury); rtol
    1e-10."""
    fj, ft, vp = setup(kind, 4)
    model_j, model_t = models()
    assert_value_and_grad_match(
        vj.ExclusiveKL(fj, model_j, 10, use_path_deriv=use_path_deriv),
        vt.ExclusiveKL(ft, model_t, 10, use_path_deriv=use_path_deriv), vp, ft)


METHODS = ["full", "mean_only", "loo_diag_approx", "loo_direct_approx"]


@pytest.mark.parametrize("use_path_deriv", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_control_variates_match_jax(method, use_path_deriv):
    """The four Miller et al. estimators on MFGaussian over the logistic
    regression, at S = 10 and 40: value and gradient, rtol 1e-10."""
    fj, ft, vp = setup("mf", 5)
    model_j, model_t = models()
    obj_j = vj.ExclusiveKL(fj, model_j, 10, use_path_deriv=use_path_deriv,
                           hessian_approx_method=method)
    obj_t = vt.ExclusiveKL(ft, model_t, 10, use_path_deriv=use_path_deriv,
                           hessian_approx_method=method)
    for S in (10, 40):
        obj_j.set_num_mc_samples(S)
        obj_t.set_num_mc_samples(S)
        assert_value_and_grad_match(obj_j, obj_t, vp, ft)


def test_control_variates_on_mfstudentt_use_its_stdevs():
    """MFStudentT provides ``mean_and_stdevs``, so the estimators take it;
    with one generator seed the gradient is reproducible and finite."""
    ft = vt.MFStudentT(D, 8.0, **CPU)
    model_t = models()[1]
    obj = vt.ExclusiveKL(ft, model_t, 10, hessian_approx_method="loo_diag_approx")
    vp = ft.init_param() - 1.5
    runs = [obj.value_and_grad(vp, torch.Generator().manual_seed(0)) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1]) and torch.isfinite(runs[0][1]).all()
    assert runs[0][1].shape == (2 * D,)


def test_invalid_hessian_approx_method():
    with pytest.raises(ValueError, match="hessian_approx_method"):
        vt.ExclusiveKL(vt.MFGaussian(2, **CPU), models(2)[1], 10,
                       hessian_approx_method="invalid method")


@pytest.mark.parametrize("family", ["FullRankGaussian", "MultivariateT", "LRGaussian"])
def test_control_variates_require_mean_field(family):
    """As in the JAX package (tests/test_objectives.py:67-75): a family
    without ``mean_and_stdevs`` is rejected up front, in both packages."""
    args = {"FullRankGaussian": (2,), "MultivariateT": (2, 5.0), "LRGaussian": (2, 1)}
    for pkg, kw in ((vj, {}), (vt, CPU)):
        model = pkg.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **kw)[0]
        with pytest.raises(ValueError, match="mean-field"):
            pkg.ExclusiveKL(getattr(pkg, family)(*args[family], **kw), model, 10,
                            hessian_approx_method="full")


def test_control_variates_name_a_model_torch_func_cannot_transform():
    """A model that leaves torch for numpy cannot be transformed by
    torch.func: the estimator raises a RuntimeError that says why, and
    takes no slower path."""
    def impure(x):
        return torch.as_tensor(-0.5 * np.sum(x.detach().numpy() ** 2, axis=-1))

    obj = vt.ExclusiveKL(vt.MFGaussian(3, **CPU), impure, 10,
                         hessian_approx_method="mean_only")
    with pytest.raises(RuntimeError, match="torch.func"):
        obj.value_and_grad(obj.approx.init_param(), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", ["mf", "full"])
def test_hessian_vector_product_matches_jax(kind):
    """The HVP of the plain objective at one set of draws; rtol 1e-10."""
    fj, ft, vp = setup(kind, 6)
    model_j, model_t = models()
    x = np.random.RandomState(7).randn(fj.var_param_dim)
    want = vj.ExclusiveKL(fj, model_j, 10).hessian_vector_product(
        jnp.asarray(vp), jnp.asarray(x), jax.random.PRNGKey(0))
    got = vt.ExclusiveKL(ft, model_t, 10).hessian_vector_product(
        params_from_jax(vp, ft), torch.as_tensor(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_raabbvi_over_a_family_without_kl_falls_back_to_faso(capsys):
    """MultivariateT has no closed-form KL, so bbvi's RAABBVI route warns
    and runs FASO, as the JAX package does (faso.py:1256-1258): one
    round and a stopping record in FASO's form. Unlike the JAX package's,
    ``k_conv`` and ``resume_state`` are RAABBVI's: a one-round list, and
    the round's FASO state under ``"flight"``."""
    table = np.random.RandomState(8).randn(64, D + DF)
    _, ft = families("mvt", D, table)
    res = vt.bbvi(D, objective=vt.ExclusiveKL(ft, models()[1], 4), n_iters=60,
                  learning_rate=0.01, RMS_kwargs=dict(diagnostics=False))
    assert "does not support KL. Using FASO." in capsys.readouterr().out
    assert res["value_history"].shape == (60,)
    assert "k_stopped" in res and "k_stopped_final" not in res
    assert res["k_conv"] == [None] and res["k_stopped"] is None
    assert int(res["resume_state"]["flight"]["k"]) == 60
