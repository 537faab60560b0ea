"""viabel_torch's Adam, AveragedAdam, Adagrad and WindowedAdagrad against
the JAX package, in float64 on the CPU: step by step, through the plain
loop, carried across with :func:`viabel_torch.convert.opt_state_from_jax`,
and under RAABBVI (whose iterate averaging depends on the rule).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from test_torch_families import TableNormal, TorchTableNormal  # noqa: E402
import test_torch_faso  # noqa: E402
from test_torch_faso import StreamNormal, TorchStreamNormal  # noqa: E402

#: the stubbed MCSE clock of the FASO parity tests, for the RAABBVI test
fixed_clocks = test_torch_faso.fixed_clocks

CPU = dict(device="cpu", dtype=torch.float64)

RULES = {
    "Adam": dict(),
    "AveragedAdam": dict(),
    "AveragedAdam-norm": dict(component_wise=False),
    "Adagrad": dict(),
    "WindowedAdagrad": dict(window_size=5),
}


def rules(name, lr=0.1):
    cls, kw = name.split("-")[0], RULES[name]
    return getattr(vj, cls)(lr, **kw), getattr(vt, cls)(lr, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_state_equal(st_t, st_j, D):
    conv = opt_state_from_jax(st_j, dim=D, device="cpu")
    assert st_t.keys() == conv.keys()
    for name, value in conv.items():
        if name == "t":
            assert st_t[name] == value
        else:
            np.testing.assert_allclose(st_t[name].numpy(), value.numpy(), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(RULES))
def test_step_rules_match_jax(name):
    """Twelve steps (past WindowedAdagrad's window of 5): the direction
    and the converted state, rtol 1e-12 (the same elementwise formulas)."""
    D = 7
    rng = np.random.RandomState(13)
    opt_j, opt_t = rules(name)
    st_j = opt_j.init_state(jnp.zeros(D))
    st_t = opt_t.init_state(torch.zeros(D, dtype=torch.float64))
    for _ in range(12):
        g = rng.randn(D)
        dir_j, st_j = opt_j.descent_direction(jnp.asarray(g), st_j)
        dir_t, st_t = opt_t.descent_direction(torch.as_tensor(g), st_t)
        np.testing.assert_allclose(dir_t.numpy(), np.asarray(dir_j), rtol=1e-12)
        _assert_state_equal(st_t, st_j, D)


@pytest.mark.parametrize("name", sorted(RULES))
def test_jax_state_carried_across_takes_the_same_step(name):
    """A JAX state after 3 steps, converted, then one step on each side
    from the same gradient: the same direction and state, rtol 1e-12."""
    D = 11
    rng = np.random.RandomState(17)
    opt_j, opt_t = rules(name)
    st_j = opt_j.init_state(jnp.zeros(D))
    for _ in range(3):
        _, st_j = opt_j.descent_direction(jnp.asarray(rng.randn(D)), st_j)
    st_t = opt_state_from_jax(st_j, dim=D, device="cpu")
    g = rng.randn(D)
    dir_j, st_j = opt_j.descent_direction(jnp.asarray(g), st_j)
    dir_t, st_t = opt_t.descent_direction(torch.as_tensor(g), st_t)
    np.testing.assert_allclose(dir_t.numpy(), np.asarray(dir_j), rtol=1e-12)
    _assert_state_equal(st_t, st_j, D)


def test_state_converter_checks_its_input():
    with pytest.raises(ValueError, match="dim"):
        opt_state_from_jax({"ring": np.zeros((2, 8, 1)), "t": 0}, device="cpu")
    with pytest.raises(ValueError, match="no step-rule state entry"):
        opt_state_from_jax({"velocity": np.zeros(3)}, device="cpu")


@pytest.mark.parametrize("name", ["Adam", "AveragedAdam", "Adagrad", "WindowedAdagrad"])
def test_plain_loop_matches_jax(name):
    """``optimize`` with each rule over ExclusiveKL on MFGaussian (the
    same draws every step): the loss history and the iterate average,
    rtol 1e-10."""
    d = 3
    table = np.random.RandomState(0).randn(10, d)
    opt_j, opt_t = rules(name, lr=0.05)
    model_j, _ = vj.zoo.logistic_regression(dim=d, n_data=20)
    model_t, _ = vt.zoo.logistic_regression(dim=d, n_data=20, **CPU)
    obj_j = vj.ExclusiveKL(vj.MFGaussian(d, base_sampler=TableNormal(table)), model_j, 10)
    obj_t = vt.ExclusiveKL(vt.MFGaussian(d, base_sampler=TorchTableNormal(table), **CPU),
                           model_t, 10)
    init = np.asarray(obj_j.approx.init_param())
    res_j = opt_j.optimize(60, obj_j, jnp.asarray(init), key=jax.random.PRNGKey(0))
    res_t = opt_t.optimize(60, obj_t, params_from_jax(init, obj_t.approx))
    for key in ("value_history", "opt_param"):
        np.testing.assert_allclose(res_t[key].numpy(), np.asarray(res_j[key]),
                                   rtol=1e-10, atol=1e-13)


def test_raabbvi_over_averaged_adam_matches_jax(fixed_clocks):
    """RAABBVI over AveragedAdam takes the averaged-rule branch in both
    packages (the iterate average restarts each round): under one draw
    stream every round's events, the learning rates and the iterate
    averages agree (rtol 1e-8)."""
    D = 4
    table = np.random.RandomState(1).randn(40000, D)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.logistic_regression(dim=D, n_data=40)
    model_t, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **CPU)
    obj_j = vj.ExclusiveKL(vj.FullRankGaussian(D, base_sampler=smp_j), model_j, 4,
                           use_path_deriv=True)
    obj_t = vt.ExclusiveKL(vt.FullRankGaussian(D, base_sampler=smp_t, **CPU), model_t, 4,
                           use_path_deriv=True)
    kw = dict(W_min=50, k_check=50, mc_escalation=4.0)
    opt_j = vj.RAABBVI(vj.AveragedAdam(0.1, diagnostics=True), **kw)
    opt_t = vt.RAABBVI(vt.AveragedAdam(0.1, diagnostics=True), **kw)
    assert opt_t._averaged_sgo() and opt_j._averaged_sgo()
    init = np.asarray(obj_j.approx.init_param())
    res_j = opt_j.optimize(260, obj_j, jnp.asarray(init), key=jax.random.PRNGKey(0))
    res_t = opt_t.optimize(260, obj_t, params_from_jax(init, obj_t.approx))
    for name in ("k_conv", "k_Rhat", "k_mcse"):
        assert res_t[name] == res_j[name], name
    assert len(res_t["k_mcse"]) >= 2  # at least one finished round
    assert smp_t.pos == smp_j.pos
    np.testing.assert_array_equal(res_t["learning_rate_hist"], res_j["learning_rate_hist"])
    np.testing.assert_allclose(res_t["iterate_average_curr_hist"].numpy(),
                               np.asarray(res_j["iterate_average_curr_hist"]),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res_t["value_history"].numpy(),
                               np.asarray(res_j["value_history"]), rtol=1e-8)


@pytest.mark.parametrize("name", ["RMSProp", "AveragedRMSProp", "Adam", "AveragedAdam",
                                  "Adagrad", "WindowedAdagrad"])
def test_reset_state_is_the_jax_no_op(name):
    """Every step rule keeps JAX's ``reset_state`` for API parity: it
    returns None and changes nothing (the state is explicit)."""
    sgo_j, sgo_t = getattr(vj, name)(0.01), getattr(vt, name)(0.01)
    assert sgo_j.reset_state() is None
    assert sgo_t.reset_state() is None
    assert sgo_t._learning_rate == 0.01
