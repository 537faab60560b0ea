"""RAABBVI's round regression (``viabel_torch.ops.wlr_hmc``) against the
JAX package, on the CPU.

The regression's HMC draws cannot be shared between the packages (JAX
keys and torch generators), so its posterior means are compared
statistically: within 4 Monte Carlo standard errors, each the batch-means
error of a mean of correlated draws (``test_torch_faso._batch_mean_se``),
the two packages' errors combined in quadrature. On a CPU tensor the
wrapper takes its plain version, ``hmc_sample`` on the analytic targets;
the kernel itself is held against that plain version on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
import test_torch_faso  # noqa: E402
from test_torch_faso import D, _batch_mean_se, _objectives  # noqa: E402
from viabel_torch import ops  # noqa: E402
from viabel_torch.hmc import draw_randomness  # noqa: E402
from viabel_torch.ops.wlr import wlr_hmc, wlr_hmc_plain  # noqa: E402


#: the MCSE timer and the recheck clock stubbed in both packages
fixed_clocks = test_torch_faso.fixed_clocks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _history(n_rounds=5, seed=0):
    """A RAABBVI history: log SKL against log lr over ``n_rounds`` halvings,
    SKL ~ c lr^(2 kappa) with kappa 0.6, c 0.8 and lognormal noise."""
    rng = np.random.RandomState(seed)
    lr = 0.1 * 0.5 ** np.arange(n_rounds)
    skl = 0.8 * lr ** 1.2 * np.exp(0.1 * rng.randn(n_rounds))
    return np.log(skl), np.log(lr)


def _within_4_se(a, b, name):
    se = np.hypot(_batch_mean_se(a), _batch_mean_se(b))
    assert abs(np.mean(a) - np.mean(b)) < 4 * se, (name, np.mean(a), np.mean(b), se)


@pytest.mark.parametrize("averaged", [False, True])
def test_wlr_regression_posterior_matches_jax(averaged):
    """``RAABBVI.weighted_linear_regression`` at RAABBVI's settings (4
    chains, 500 + 500 iterations, 24 leapfrog steps), through the wrapper
    on CPU tensors: the posterior means of kappa (general target) and
    log c within 4 Monte Carlo standard errors of the JAX package's
    regression on the same (y, x)."""
    y, x = _history()
    sgo_j = vj.AveragedRMSProp(0.01) if averaged else vj.RMSProp(0.01)
    sgo_t = vt.AveragedRMSProp(0.01) if averaged else vt.RMSProp(0.01)
    fit_j, kappa_j, c_j = vj.RAABBVI(sgo_j, rho=0.5).weighted_linear_regression(
        y, x, key=jax.random.PRNGKey(0))
    fit_t, kappa_t, c_t = vt.RAABBVI(sgo_t, rho=0.5).weighted_linear_regression(
        y, x, generator=torch.Generator().manual_seed(0))
    assert fit_t["log_c"].shape == (2000,) and fit_t["log_c"].device.type == "cpu"
    _within_4_se(fit_t["log_c"].numpy(), np.asarray(fit_j["log_c"]), "log_c")
    assert math.isclose(math.log(c_t), float(fit_t["log_c"].mean()), rel_tol=1e-12)
    if averaged:
        assert kappa_t == kappa_j == 1.0
    else:
        _within_4_se(fit_t["kappa"].numpy(), np.asarray(fit_j["kappa"]), "kappa")
        assert math.isclose(kappa_t, float(fit_t["kappa"].mean()), rel_tol=1e-12)


@pytest.mark.parametrize("d", [3, 2])
def test_wlr_hmc_run_is_a_function_of_the_generator_state(d):
    """Two runs from one seed are bit-equal, and a run advances its
    generator by exactly (T, C, d) normals and then (T, C) uniforms, T =
    num_warmup + num_samples, drawn before the first iteration."""
    y, x = _history()
    w = 1.0 / (1.0 + np.arange(5)[::-1] ** 2 / 9.0) ** 0.25
    data = tuple(torch.as_tensor(v) for v in (y, x, w)) + (0.5,)
    init = torch.as_tensor(np.random.RandomState(1).randn(3, d))
    settings = dict(num_warmup=20, num_samples=10, num_leapfrog=3)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(wlr_hmc(init, gen, data, **settings))
        state = gen.get_state()
    assert runs[0].shape == (3, 10, d) and torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    ref = torch.Generator().manual_seed(5)
    normals, uniforms = draw_randomness(ref, 30, 3, d, torch.float64, "cpu")
    assert normals.shape == (30, 3, d) and uniforms.shape == (30, 3)
    assert torch.equal(state, ref.get_state())
    # the generator's state alone decides the run: a generator set to the
    # seed's state by set_state gives the same draws
    other = torch.Generator()
    other.set_state(torch.Generator().manual_seed(5).get_state())
    assert torch.equal(wlr_hmc_plain(init, other, data, **settings), runs[0])


def test_raabbvi_real_regression_rounds_match_jax(fixed_clocks):
    """RAABBVI.optimize on the CPU with the real regression (no stub):
    under one draw stream the port takes the same rounds as the JAX
    package (events, learning rates, SKL history), and each round's
    kappa and log c posterior means agree within 4 Monte Carlo standard
    errors. The inefficiency criterion stays near 0.33 in both packages,
    far from its threshold of 1, so the regressions' Monte Carlo noise
    cannot flip the termination decision."""
    table = np.random.RandomState(1).randn(60000, D)
    (obj_j, smp_j), (obj_t, smp_t) = _objectives(4, table)
    kw = dict(n_iters=360, learning_rate=0.1, RMS_kwargs=dict(diagnostics=True),
              RAABBVI_kwargs=dict(W_min=50, k_check=50))
    res_j = vj.bbvi(D, objective=obj_j, **kw)
    res_t = vt.bbvi(D, objective=obj_t, device="cpu", **kw)
    for name in ("k_conv", "k_Rhat", "k_mcse"):
        assert res_t[name] == res_j[name], name
    assert smp_t.pos == smp_j.pos
    np.testing.assert_array_equal(res_t["learning_rate_hist"], res_j["learning_rate_hist"])
    np.testing.assert_allclose(res_t["SKL_history"], res_j["SKL_history"], rtol=1e-8)
    assert len(res_t["kappa_hist"]) == len(res_j["kappa_hist"]) == 2
    assert len(res_t["stopping_crt"]) == len(res_j["stopping_crt"]) == 1
    assert max(res_t["stopping_crt"][0], res_j["stopping_crt"][0]) < 0.5
    for r in range(2):
        kappa_t, kappa_j = res_t["kappa_sample_hist"][r], res_j["kappa_sample_hist"][r]
        _within_4_se(np.asarray(kappa_t), np.asarray(kappa_j), f"kappa round {r}")
        assert math.isclose(res_t["kappa_hist"][r], np.mean(kappa_t), rel_tol=1e-12)
        log_c_t = np.log(res_t["c_sample_hist"][r])
        log_c_j = np.log(np.asarray(res_j["c_sample_hist"][r]))
        _within_4_se(log_c_t, log_c_j, f"log_c round {r}")
        assert math.isclose(math.log(res_t["c_hist"][r]), np.mean(log_c_t), rel_tol=1e-9)


def test_regression_runs_on_the_generator_device(fixed_clocks, monkeypatch):
    """The regression follows its generator: RAABBVI.optimize on CPU
    tensors seeds its HMC generator on the CPU and hands the wrapper CPU
    tensors, so nothing launches; without a generator the regression
    defaults to the card and raises where there is none. (The spy runs
    the real wrapper at 20 + 20 iterations: this test is about
    placement.)"""
    seen = []
    real = tfaso.wlr_hmc

    def spy(init, generator, data, **kw):
        seen.append((init.device.type, generator.device.type,
                     {t.device.type for t in data[:3]}))
        return real(init, generator, data, num_warmup=20, num_samples=20)

    monkeypatch.setattr(tfaso, "wlr_hmc", spy)
    ops.reset_launch_counts()
    _, (objective, _) = _objectives(4, np.random.RandomState(1).randn(60000, D))
    res = vt.RAABBVI(vt.RMSProp(0.1, diagnostics=True), W_min=50, k_check=50).optimize(
        360, objective, objective.approx.init_param(),
        generator=torch.Generator().manual_seed(0))
    assert len(res["kappa_hist"]) == len(seen) == 2
    assert all(s == ("cpu", "cpu", {"cpu"}) for s in seen)
    assert ops.launch_counts()["wlr_hmc"] == 0
    assert res["resume_state"] is None or res["resume_state"]["hmc_generator_state"].numel() \
        == torch.Generator().get_state().numel()
    helper = vt.RAABBVI(vt.RMSProp(0.1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        helper.weighted_linear_regression(*_history())


def test_hmc_sampler_amplifies_round_off():
    """Why the kernel is held draw for draw only over short runs: at
    RAABBVI's 24 leapfrog steps the sampler amplifies a last-bit change
    of its start past 1e-9 within 60 iterations (the kernel's sums are
    reassociated, so its chains part from the plain version's in the same
    way). Over that horizon a relative change of 1e-15 grows by more
    than a factor 1e6."""
    y, x = _history()
    w = 1.0 / (1.0 + np.arange(5)[::-1] ** 2 / 9.0) ** 0.25
    data = tuple(torch.as_tensor(v) for v in (y, x, w)) + (0.5,)
    init = torch.tensor([[math.log(4.0), float(np.mean(y)), 0.0]] * 4, dtype=torch.float64)
    settings = dict(num_warmup=50, num_samples=10, num_leapfrog=24)
    a = wlr_hmc(init, torch.Generator().manual_seed(0), data, **settings)
    b = wlr_hmc(init * (1.0 + 1e-15), torch.Generator().manual_seed(0), data, **settings)
    assert float((a - b).abs().max()) > 1e-9
