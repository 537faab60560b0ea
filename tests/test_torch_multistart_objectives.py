"""The port's multistart engines on a stateful objective (DIS) and the
plain ``multistart_optimize``, and the restart selection
(``elbo_estimates``, ``select_best_restart``), against the JAX package in
float64 on the CPU, with injected base draws (see
tests/test_torch_multistart.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.convenience as jconv  # noqa: E402
import viabel_torch as vt  # noqa: E402
from test_torch_multistart import (F64, StreamNormal, TorchStreamNormal, close,  # noqa: E402
                                   fixed_clocks, inits, objectives)
from viabel_torch.parallel import multistart_faso, multistart_optimize  # noqa: E402

__all__ = ["fixed_clocks"]  # a fixture, used by name


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multistart_faso_stateful_dis_matches_jax(fixed_clocks):
    """DISInclusiveKL (no resampling) at B = 2: one estimator state a
    restart, no failure recorded; decisions and opt_param equal JAX's."""
    dim = 3
    table = np.random.RandomState(5).randn(400000, dim)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.logistic_regression(dim=dim, n_data=40)
    model_t, _ = vt.zoo.logistic_regression(dim=dim, n_data=40, **F64)
    prior = np.zeros(2 * dim)
    kw = dict(ess_target=10, use_resampling=False, temper_prior_params=prior)
    obj_j = vj.DISInclusiveKL(vj.FullRankGaussian(dim, base_sampler=smp_j), model_j, 20,
                              temper_prior=vj.MFGaussian(dim), **kw)
    obj_t = vt.DISInclusiveKL(vt.FullRankGaussian(dim, base_sampler=smp_t, **F64),
                              model_t, 20, temper_prior=vt.MFGaussian(dim, **F64), **kw)
    x0 = inits(2, seed=3, dim=dim)
    run = dict(W_min=50, k_check=50, mcse_threshold=0.2, max_history=400)
    res_j = vj.parallel.multistart_faso(vj.RMSProp(0.05), 400, obj_j, jnp.asarray(x0),
                                        jax.random.PRNGKey(0), **run)
    res_t = multistart_faso(vt.RMSProp(0.05), 400, obj_t, torch.as_tensor(x0), **run)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    assert all(k is not None for k in res_t["k_stopped"])
    assert res_t["obj_state_errors"] == res_j["obj_state_errors"] == [None, None]
    assert smp_t.pos == smp_j.pos
    close(res_t["opt_param"], res_j["opt_param"])
    for b, state in enumerate(res_t["resume_state"]["obj_states"]):
        close(state["eps"], res_j["resume_state"]["obj_states"]["eps"][b])


def test_multistart_optimize_matches_jax():
    """The plain multistart: B = 3 fixed-rate runs with ring averages;
    opt_param, final_param and the loss histories to rtol 1e-8."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(3, seed=2)
    x0 = inits()
    res_j = vj.parallel.multistart_optimize(vj.RMSProp(0.05), 200, obj_j, jnp.asarray(x0),
                                            jax.random.PRNGKey(0))
    res_t = multistart_optimize(vt.RMSProp(0.05), 200, obj_t, torch.as_tensor(x0))
    assert smp_t.pos == smp_j.pos
    for name in ("opt_param", "final_param", "value_history"):
        assert res_t[name].shape == np.asarray(res_j[name]).shape, name
        close(res_t[name], res_j[name])


def test_multistart_optimize_refuses_stateful_objectives():
    """JAX's message for DIS, also on a restart x mc mesh, where JAX checks
    the state before the mesh."""
    model, _ = vt.zoo.logistic_regression(dim=2, n_data=20, **F64)
    dis = vt.DISInclusiveKL(vt.MFGaussian(2, **F64), model, 10, ess_target=5,
                            temper_prior=vt.MFGaussian(2, **F64),
                            temper_prior_params=np.zeros(4), use_resampling=False)
    x0 = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="estimator state"):
        multistart_optimize(vt.RMSProp(0.05), 10, dis, x0)
    mesh = type("Mesh2D", (), {"mesh_dim_names": ("restart", "mc"),
                               "size": lambda self, dim=None: 1,
                               "get_local_rank": lambda self, name=None: 0,
                               "get_group": lambda self, name=None: None})()
    with pytest.raises(ValueError, match="estimator state"):
        multistart_optimize(vt.RMSProp(0.05), 10, dis, x0, mesh=mesh, mc_axis="mc")


def _mf_pair():
    mean, sd = np.array([1.0, -2.0]), np.array([0.5, 1.5])
    table = np.random.RandomState(8).randn(5000, 2)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.diagonal_gaussian(mean, sd)
    model_t, _ = vt.zoo.diagonal_gaussian(mean, sd, **F64)
    good = np.concatenate([mean, np.log(sd)])
    rows = np.stack([good + [5.0, -5.0, 0.0, 0.0], good, good + [0.2, 0.1, -0.3, 0.2]])
    return ((model_j, vj.MFGaussian(2, base_sampler=smp_j), smp_j),
            (model_t, vt.MFGaussian(2, base_sampler=smp_t, **F64), smp_t), rows)


@pytest.mark.parametrize("family", ["mf_gaussian", "mf_student_t"])
def test_elbo_estimates_use_common_draws(family):
    """Every restart is scored on the same base draws: with an injected
    sampler one block of 1000 rows serves all restarts (JAX's shared key),
    and the scores equal JAX's to rtol 1e-10; on a family without the hook
    (MFStudentT) each row starts from the same generator state, so a
    repeated row scores exactly the same."""
    (model_j, approx_j, smp_j), (model_t, approx_t, smp_t), rows = _mf_pair()
    if family == "mf_gaussian":
        s_j = jconv.elbo_estimates(jnp.asarray(rows), model=model_j, approx=approx_j,
                                   key=jax.random.PRNGKey(0))
        s_t = vt.elbo_estimates(torch.as_tensor(rows), model=model_t, approx=approx_t)
        assert smp_t.pos == smp_j.pos == 1000
        assert approx_t.base_sampler is smp_t  # the hook is restored
        close(s_t, s_j, rtol=1e-10)
        return
    approx = vt.MFStudentT(2, 8.0, **F64)
    g = torch.Generator().manual_seed(1)
    s = vt.elbo_estimates(torch.as_tensor(rows[[1, 2, 1]]), model=model_t, approx=approx,
                          generator=g)
    assert float(s[0]) == float(s[2]) and float(s[0]) != float(s[1])


def test_select_best_restart_matches_jax():
    """The at-target row wins, as in JAX; a non-finite score loses to any
    finite one, an all-non-finite batch raises; JAX's argument errors."""
    (model_j, approx_j, _), (model_t, approx_t, _), rows = _mf_pair()
    nan = rows[1].copy()
    nan[0] = np.nan
    batch = np.stack([rows[0], rows[1], nan])
    best_j, s_j = jconv.select_best_restart(jnp.asarray(batch), model=model_j,
                                            approx=approx_j, key=jax.random.PRNGKey(0))
    best_t, s_t = vt.select_best_restart(torch.as_tensor(batch), model=model_t,
                                         approx=approx_t)
    assert best_t == best_j == 1
    assert not torch.isfinite(s_t[2]) and not np.isfinite(float(s_j[2]))
    close(s_t[:2], np.asarray(s_j)[:2], rtol=1e-10)
    for pkg, conv, model, approx in ((jconv, jnp.asarray, model_j, approx_j),
                                     (vt, torch.as_tensor, model_t, approx_t)):
        with pytest.raises(ValueError, match="non-finite"):
            pkg.select_best_restart(conv(np.stack([nan, nan])), model=model,
                                    approx=approx)
        with pytest.raises(ValueError, match="var_params must have shape"):
            pkg.elbo_estimates(conv(rows[0]), model=model, approx=approx)
        with pytest.raises(ValueError, match="supply an objective"):
            pkg.elbo_estimates(conv(rows))


def test_elbo_estimates_entropy_free_families():
    """A square NeuralNet scores through its exact pushforward density; a
    non-square one cannot be scored (JAX's message)."""
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **F64)
    square = vt.NeuralNet([(2, 2), (2, 2)], last=lambda x: x, **F64)
    rng = np.random.RandomState(0)
    vps = torch.as_tensor(rng.randn(2, square.var_param_dim) / 10)
    scores = vt.elbo_estimates(vps, model=model, approx=square)
    assert scores.shape == (2,) and torch.isfinite(scores).all()
    wide = vt.NeuralNet([(2, 5), (5, 2)], last=lambda x: x, **F64)
    with pytest.raises(ValueError, match="ELBO-scored"):
        vt.elbo_estimates(torch.as_tensor(rng.randn(2, wide.var_param_dim) / 10),
                          model=model, approx=wide)


def test_elbo_estimates_of_no_rows_is_empty():
    """(0, D) rows score to an empty tensor on the caller's device and in
    its dtype, as JAX's empty array, and draw nothing: the generator's
    state is as it was."""
    (model_j, approx_j, _), (model_t, approx_t, smp_t), _ = _mf_pair()
    s_j = jconv.elbo_estimates(jnp.zeros((0, 4)), model=model_j, approx=approx_j,
                               key=jax.random.PRNGKey(0))
    g = torch.Generator().manual_seed(3)
    before = g.get_state().clone()
    s_t = vt.elbo_estimates(torch.zeros((0, 4), dtype=torch.float64), model=model_t,
                            approx=approx_t, generator=g)
    assert s_t.shape == tuple(np.asarray(s_j).shape) == (0,)
    assert s_t.dtype == torch.float64 and s_t.device.type == "cpu"
    assert torch.equal(g.get_state(), before) and smp_t.pos == 0
