"""The port's adaptive path (FASO, RAABBVI, HMC, bbvi) against the JAX
package.

Both runs consume one numpy stream of base normal draws through the
families' ``base_sampler`` hook, so their trajectories agree to round-off
and every discrete decision (R-hat verdicts, escalations, stops) must be
equal. The MCSE recheck schedule reads the wall clock, so both packages'
clocks are stubbed deterministically (as tests/test_mc_escalation.py
does). HMC draws cannot be shared, so the regression posteriors are
compared statistically.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.faso as jfaso  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixed_clocks(monkeypatch):
    """A negligible fake MCSE cost: the recheck growth factor sits at its
    1.05 floor in both packages."""

    class FixedTimer:
        interval = 1e-9

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class FakeClock:
        t = 0.0

        @classmethod
        def now(cls):
            cls.t += 1.0
            return cls.t

    for mod in (jfaso, tfaso):
        monkeypatch.setattr(mod, "Timer", FixedTimer)
        monkeypatch.setattr(mod, "_now", FakeClock.now)


class StreamNormal:
    """Consecutive rows of one numpy table of standard normals. On the JAX
    side a ``pure_callback`` hands them out inside the jitted segment scan,
    one call per step; the port takes the same rows in the same order."""

    def __init__(self, table):
        self.table, self.pos = table, 0

    def take(self, n, width):
        rows = self.table[self.pos:self.pos + n, :width]
        assert rows.shape[0] == n, "draw table exhausted"
        self.pos += n
        return rows

    def normal(self, key, n_samples, width, dtype):  # the JAX hook
        return jax.pure_callback(
            lambda _key: self.take(n_samples, width).astype(dtype),
            jax.ShapeDtypeStruct((n_samples, width), dtype), key)


class TorchStreamNormal(StreamNormal):
    def normal(self, generator, n_samples, width, dtype, device):
        return torch.as_tensor(self.take(n_samples, width), dtype=dtype,
                               device=device)


D = 4


def _objectives(S, table):
    """STL ExclusiveKL over FullRankGaussian on the flagship's model,
    logistic_regression, at a small width, on both sides."""
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.logistic_regression(dim=D, n_data=40)
    model_t, _ = vt.zoo.logistic_regression(dim=D, n_data=40, device="cpu",
                                        dtype=torch.float64)
    obj_j = vj.ExclusiveKL(vj.FullRankGaussian(D, base_sampler=smp_j), model_j, S,
                           use_path_deriv=True)
    obj_t = vt.ExclusiveKL(vt.FullRankGaussian(D, base_sampler=smp_t, device="cpu",
                                               dtype=torch.float64),
                           model_t, S, use_path_deriv=True)
    return (obj_j, smp_j), (obj_t, smp_t)


@pytest.mark.parametrize("diagnostics", [True, False])
@pytest.mark.parametrize("rhat_threshold,n_iters", [(1.1, 400), (1.01, 600)])
def test_faso_slice_matches_jax(fixed_clocks, diagnostics, rhat_threshold,
                                n_iters):
    """bbvi's FASO route end to end, with per-step diagnostics (verdicts
    read at once) and with pipelined verdicts. At the default gate the run
    converges; at 1.01 the gate stalls and mc_escalation climbs. Decisions
    must be equal and opt_param agree to rtol 1e-8 (the trajectories differ
    only by round-off)."""
    table = np.random.RandomState(0).randn(50000, D)
    (obj_j, smp_j), (obj_t, smp_t) = _objectives(1, table)
    kw = dict(n_iters=n_iters, fixed_lr=True, learning_rate=0.05,
              RMS_kwargs=dict(diagnostics=diagnostics),
              FASO_kwargs=dict(W_min=50, k_check=50, rhat_threshold=rhat_threshold))
    res_j = vj.bbvi(D, objective=obj_j, **kw)
    res_t = vt.bbvi(D, objective=obj_t, **kw)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                  res_j["mc_escalation_history"])
    assert res_t["value_history"].shape[0] == np.asarray(res_j["value_history"]).shape[0]
    assert smp_t.pos == smp_j.pos  # the same draws were consumed
    assert obj_t.num_mc_samples == obj_j.num_mc_samples
    np.testing.assert_allclose(res_t["opt_param"].numpy(),
                               np.asarray(res_j["opt_param"]), rtol=1e-8, atol=1e-12)
    if rhat_threshold == 1.1:
        assert res_t["k_conv"] is not None
    else:
        assert len(res_t["mc_escalation_history"]) >= 1
    if diagnostics:
        np.testing.assert_array_equal(res_t["iterate_average_k_history"],
                                      res_j["iterate_average_k_history"])
        np.testing.assert_allclose(res_t["grad_history"],
                                   np.asarray(res_j["grad_history"]),
                                   rtol=1e-8, atol=1e-10)


class SNRObjective:
    """The synthetic SNR wall of tests/test_mc_escalation.py: a quadratic
    whose gradient noise scales as ``sigma / sqrt(num_mc_samples)``, with
    the noise read from a shared numpy stream (``pure_callback`` on the JAX
    side)."""

    scannable = True

    def __init__(self, S, table, torch_side, sigma=4.0):
        self.num_mc_samples = S
        self.table, self.pos, self.sigma, self.torch_side = table, 0, sigma, torch_side

    def take(self):
        self.pos += 1
        return self.table[self.pos - 1]

    def value_and_grad(self, vp, key_or_generator):
        scale = self.sigma / (1.0 * self.num_mc_samples) ** 0.5
        if self.torch_side:
            return 0.5 * torch.sum(vp * vp), vp + scale * torch.as_tensor(self.take())
        noise = jax.pure_callback(lambda _key: self.take(),
                                  jax.ShapeDtypeStruct(vp.shape, vp.dtype),
                                  key_or_generator)
        return 0.5 * jax.numpy.sum(vp * vp), vp + scale * noise

    def update(self, vp, direction):
        return vp - direction


def test_snr_wall_escalation_matches_jax(fixed_clocks):
    """The ring-capped MCSE/ESS gate stalls at S=4 and mc_escalation
    ladders S up (4 -> 16 -> 64 -> 256) until the run stops: every event,
    the stop and opt_param (rtol 1e-10) equal the JAX run's."""
    table = np.random.RandomState(0).randn(20000, 4)
    results = {}
    for name, pkg, init in (("jax", vj, jax.numpy.full(4, 3.0)),
                            ("torch", vt, torch.full((4,), 3.0, dtype=torch.float64))):
        obj = SNRObjective(4, table, torch_side=name == "torch")
        opt = pkg.FASO(pkg.RMSProp(0.05), W_min=200, ESS_min=60, mcse_threshold=0.2,
                       max_history=800, mc_escalation=4.0, mc_max_samples=256)
        results[name] = (opt.optimize(8000, obj, init), obj)
    (res_j, obj_j), (res_t, obj_t) = results["jax"], results["torch"]
    assert res_t["k_stopped"] is not None
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                  res_j["mc_escalation_history"])
    assert list(res_t["mc_escalation_history"][:, 1]) == [16, 64, 256]
    assert int(res_t["mc_escalation_history"][0, 0]) > 800  # ring-capped first
    assert obj_t.pos == obj_j.pos
    np.testing.assert_allclose(res_t["opt_param"].numpy(),
                               np.asarray(res_j["opt_param"]), rtol=1e-10)


def _batch_mean_se(x, n_batches=20):
    """Monte Carlo standard error of a mean of correlated draws (batch
    means; draws are chain-major, so batches stay inside chains)."""
    means = np.asarray(x).reshape(n_batches, -1).mean(axis=1)
    return means.std(ddof=1) / np.sqrt(n_batches)


def test_raabbvi_slice_matches_jax(fixed_clocks):
    """Three RAABBVI rounds under one draw stream: every round's events are
    equal (the FASO rounds never read the HMC result, which only feeds the
    termination rule); the regression's kappa and log c posterior means
    agree within 4 Monte Carlo standard errors."""
    table = np.random.RandomState(1).randn(40000, D)
    (obj_j, smp_j), (obj_t, smp_t) = _objectives(4, table)
    kw = dict(n_iters=260, learning_rate=0.1, RMS_kwargs=dict(diagnostics=True),
              RAABBVI_kwargs=dict(W_min=50, k_check=50))
    res_j = vj.bbvi(D, objective=obj_j, **kw)
    res_t = vt.bbvi(D, objective=obj_t, **kw)
    for name in ("k_conv", "k_Rhat", "k_mcse"):
        assert res_t[name] == res_j[name], name
    assert len(res_t["k_mcse"]) == 4  # two finished rounds, a third cut short
    np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                  res_j["mc_escalation_history"])
    assert smp_t.pos == smp_j.pos
    np.testing.assert_array_equal(res_t["learning_rate_hist"],
                                  res_j["learning_rate_hist"])
    np.testing.assert_allclose(res_t["SKL_history"], res_j["SKL_history"], rtol=1e-8)
    np.testing.assert_allclose(res_t["iterate_average_curr_hist"].numpy(),
                               np.asarray(res_j["iterate_average_curr_hist"]),
                               rtol=1e-8, atol=1e-12)
    assert len(res_t["kappa_hist"]) == len(res_j["kappa_hist"]) == 1
    for name, samples in (("kappa", "kappa_sample_hist"), ("log_c", "c_sample_hist")):
        x_j, x_t = res_j[samples][0], res_t[samples][0]
        if name == "log_c":
            x_j, x_t = np.log(x_j), np.log(x_t)
        se = np.hypot(_batch_mean_se(x_j), _batch_mean_se(x_t))
        assert abs(x_t.mean() - x_j.mean()) < 4 * se, name


def test_hmc_regression_posterior_matches_jax():
    """The weighted-regression posterior RAABBVI samples: posterior means
    of kappa and log c within 4 Monte Carlo standard errors of the JAX
    sampler's (shorter runs than RAABBVI's; the sampler is the same)."""
    from viabel_tpu.hmc import hmc_sample as jax_hmc
    from viabel_torch.hmc import hmc_sample as torch_hmc
    y = np.log([3e-3, 1.2e-3, 7e-4, 2e-4])
    x = np.log([0.1, 0.05, 0.025, 0.0125])
    w = 1.0 / (1.0 + np.arange(4)[::-1] ** 2 / 9.0) ** 0.25
    init = np.tile([np.log(0.8 / 0.2), -1.0, 0.0], (4, 1))
    settings = dict(num_warmup=300, num_samples=500, num_leapfrog=12)
    draws_j = np.asarray(jax_hmc(
        jfaso._wlr_logprob_general, jax.numpy.asarray(init), jax.random.PRNGKey(0),
        data=tuple(map(jax.numpy.asarray, (y, x, w, 0.5))), **settings))
    data_t = (torch.as_tensor(y), torch.as_tensor(x), torch.as_tensor(w), 0.5)
    draws_t = torch_hmc(tfaso._wlr_general, torch.as_tensor(init),
                        torch.Generator().manual_seed(0), data=data_t,
                        **settings).numpy()
    for name, col, fn in (("kappa", 0, lambda v: 1 / (1 + np.exp(-v))),
                          ("log_c", 1, lambda v: v)):
        a, b = fn(draws_j[..., col]).reshape(-1), fn(draws_t[..., col]).reshape(-1)
        se = np.hypot(_batch_mean_se(a), _batch_mean_se(b))
        assert abs(a.mean() - b.mean()) < 4 * se, name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("averaged", [False, True])
def test_wlr_log_density_and_gradient_match_jax(averaged, seed):
    """The port's HMC targets return their gradients by hand, where JAX
    differentiates its log density. A wrong gradient would only lower HMC's
    acceptance rate, which the posterior-mean tests cannot see, so the
    value and both gradients (autograd of the port's value, jax.grad of the
    reference's) are held at random points, with a zero-weight padding row
    as RAABBVI's JAX regression adds. rtol 1e-10 (the same float64
    arithmetic, reassociated)."""
    rng = np.random.RandomState(10 + seed)
    y = np.append(np.log([3e-3, 1.2e-3, 7e-4, 2e-4]), 0.0)
    x = np.append(np.log([0.1, 0.05, 0.025, 0.0125]), 0.0)
    w = np.append(1.0 / (1.0 + np.arange(4)[::-1] ** 2 / 9.0) ** 0.25, 0.0)
    rho = 0.5
    width = 2 if averaged else 3
    points = rng.randn(4, width) * (2.0 if averaged else [1.5, 2.0, 1.0])
    port_fn = tfaso._wlr_averaged if averaged else tfaso._wlr_general
    jax_fn = jfaso._wlr_logprob_averaged if averaged else jfaso._wlr_logprob_general
    data_t = (torch.as_tensor(y), torch.as_tensor(x), torch.as_tensor(w), rho)
    theta = torch.as_tensor(points).requires_grad_(True)
    lp, grad = port_fn(theta, data_t)
    (auto_grad,) = torch.autograd.grad(lp.sum(), theta)
    data_j = tuple(map(jax.numpy.asarray, (y, x, w, rho)))
    for i, point in enumerate(points):
        lp_j, grad_j = jax.value_and_grad(jax_fn)(jax.numpy.asarray(point), data_j)
        np.testing.assert_allclose(float(lp[i].detach()), float(lp_j), rtol=1e-10)
        np.testing.assert_allclose(grad[i].detach().numpy(), np.asarray(grad_j),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(grad.detach().numpy(), auto_grad.numpy(),
                               rtol=1e-10, atol=1e-12)


def test_wls_and_skl_round_update_match_jax(monkeypatch):
    """The deterministic RAABBVI bookkeeping is equal exactly once the
    regression's (kappa, c) are fixed on both sides."""
    rng = np.random.RandomState(2)
    x, y = rng.randn(6), rng.randn(6)
    assert vt.RAABBVI.wls(x, y) == vj.RAABBVI.wls(x, y)
    fake = (None, 0.6, 0.8)
    monkeypatch.setattr(vj.RAABBVI, "weighted_linear_regression",
                        lambda self, *a, **k: fake)
    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression",
                        lambda self, *a, **k: fake)
    fj = vj.FullRankGaussian(3)
    ft = vt.FullRankGaussian(3, device="cpu", dtype=torch.float64)
    vp0, vp1 = 0.1 * rng.randn(12), 0.1 * rng.randn(12)
    hists = {}
    for name, pkg, approx, conv, extra in (
            ("jax", vj, fj, jax.numpy.asarray, dict(key=jax.random.PRNGKey(0))),
            ("torch", vt, ft, torch.as_tensor, dict(generator=torch.Generator()))):
        opt = pkg.RAABBVI(pkg.RMSProp(0.1), rho=0.5)
        h = dict(skl_hist=[1e-2, 4e-3], lr_hist=[0.1, 0.05, 0.025],
                 conv_iters=[300, 500], kappa_hist=[], c_hist=[], pred_hist=[],
                 crt_hist=[])
        out = opt.skl_round_update(approx, conv(vp0), conv(vp1), **h, **extra)
        hists[name] = (h, out[1:])
    (h_j, out_j), (h_t, out_t) = hists["jax"], hists["torch"]
    assert out_t == out_j
    for name in h_j:
        np.testing.assert_allclose(h_t[name], h_j[name], rtol=1e-12)


def test_port_runs_without_jax():
    """viabel_torch imports nothing of JAX: with JAX blocked, the package
    imports and a 20-step bbvi runs."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch, viabel_torch as vt\n"
        "model, dim = vt.zoo.funnel()\n"
        "res = vt.bbvi(dim, log_density=model, n_iters=20, device='cpu',\n"
        "              dtype=torch.float64)\n"
        "assert res['value_history'].shape == (20,)\n"
        "assert torch.isfinite(res['opt_param']).all()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m.startswith('viabel_tpu')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("kwargs", [dict(num_restarts=2), dict(standardize=True),
                                    dict(init_method="pathfinder"), dict(fit=object()),
                                    dict(FASO_kwargs=dict(max_time=1.0), fixed_lr=True),
                                    dict(RAABBVI_kwargs=dict(init_rmsprop=True))])
def test_deferred_routes_raise_with_a_roadmap_pointer(kwargs):
    model, dim = vt.zoo.funnel()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.bbvi(dim, log_density=model, n_iters=5, device="cpu", **kwargs)


@pytest.mark.parametrize("name", ["MFStudentT", "MultivariateT", "LRGaussian",
                                  "NeuralNet", "NVPFlow", "IWELBO",
                                  "DISInclusiveKL", "AlphaDivergence", "Adam",
                                  "Adagrad"])
def test_unported_names_raise_with_a_roadmap_pointer(name):
    assert hasattr(vj, name)  # each exists in the reference
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item"):
        getattr(vt, name)
    with pytest.raises(AttributeError):
        vt.no_such_name
