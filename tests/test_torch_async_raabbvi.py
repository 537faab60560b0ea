"""The port's async ``multistart_raabbvi`` (per-restart round clocks)
against the JAX package in float64 on the CPU, and against the port's own
``RAABBVI`` at ``B = 1``.

The draws are injected as in tests/test_torch_multistart.py and the
regression is stubbed with a fixed ``(kappa, c)`` on both sides, as in
tests/test_torch_multistart_raabbvi.py. Each paired JAX/port run sits in
one test. DIS's resampling indices come from one table on both sides:
``jax.random.choice`` is replaced by a callback into it for the JAX run,
and the port's ``resampler`` hook reads the same rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.parallel.raabbvi as jrb  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.parallel.raabbvi as trb  # noqa: E402
from test_torch_multistart import (F64, FixedTimer, StreamNormal,  # noqa: E402
                                   TorchStreamNormal, close, fixed_clocks, inits, objectives)
from viabel_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from viabel_torch.parallel import multistart_raabbvi  # noqa: E402

D = 3
FIT = (None, 0.6, 0.8)  # the stubbed regression's (fit, kappa, c)
#: two restarts on an lr grid (tests/test_torch_multistart_raabbvi.py's
#: lockstep setting): the fast restart terminates first and its rounds
#: end at other checks than the slow one's
AS_KW = dict(W_min=50, k_check=50, iters0=10, max_history=600,
             learning_rate=np.array([0.1, 0.05]), schedule="async", verbose=False)
INT_KEYS = ("k_stopped_final", "n_rounds_per_restart", "n_rounds", "k_global_steps",
            "k_total", "conv_iters_hist", "budget_overrun", "predicted_iters_hist",
            "obj_state_errors")
FLOAT_KEYS = ("learning_rate_hist", "SKL_history", "stopping_crt", "kappa_hist", "c_hist")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def async_clocks(fixed_clocks):
    """tests/test_torch_multistart.py's stubbed clocks, and the MCSE timer
    of both packages' async schedules."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jrb, trb):
            mp.setattr(mod, "Timer", FixedTimer)
        yield


@pytest.fixture(scope="module")
def fixed_regression():
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (vj, vt):
            mp.setattr(pkg.RAABBVI, "weighted_linear_regression", lambda self, *a, **k: FIT)
        yield


def assert_same_run(res_t, res_j, keys=INT_KEYS):
    for name in keys:
        if name in res_j:
            assert res_t[name] == res_j[name], name
    for name in FLOAT_KEYS:
        assert [len(h) for h in res_t[name]] == [len(h) for h in res_j[name]], name
        for got, want in zip(res_t[name], res_j[name]):
            close(np.asarray(got, dtype=float), np.asarray(want, dtype=float))
    close(res_t["opt_param"], res_j["opt_param"])


def test_async_raabbvi_lr_grid_matches_jax(async_clocks, fixed_regression):
    """B = 2 on an lr grid: the restarts' rounds end at different checks
    and each terminates on its own round clock. Every integer decision and
    the draws consumed are equal; the histories and the optima agree to
    rtol 1e-8. The async run takes fewer global steps than the lockstep
    run of the same setting."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D)
    x0 = inits(2, dim=D)
    res_j = vj.parallel.multistart_raabbvi(vj.RMSProp(0.1), 3000, obj_j, jnp.asarray(x0),
                                           jax.random.PRNGKey(0), **AS_KW)
    res_t = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj_t, torch.as_tensor(x0), **AS_KW)
    assert_same_run(res_t, res_j)
    assert smp_t.pos == smp_j.pos
    assert all(k is not None for k in res_t["k_stopped_final"])
    assert len(set(res_t["k_stopped_final"])) == 2
    assert res_t["n_rounds_per_restart"][0] != res_t["n_rounds_per_restart"][1]
    (_, _), (obj_l, _) = objectives(4, dim=D)
    lock = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj_l, torch.as_tensor(x0),
                              **{**AS_KW, "schedule": "lockstep"})
    assert res_t["k_global_steps"] < lock["k_global_steps"]


@pytest.mark.parametrize("init_rmsprop", [False, True])
def test_async_raabbvi_b1_is_the_ports_raabbvi(async_clocks, monkeypatch, init_rmsprop):
    """At B = 1 the async schedule is RAABBVI.optimize on the same
    generator, bit for bit: each round's ring restarts with the round, and
    every regression call sees the same HMC generator state."""
    seen = []

    def record(self, y, x, generator=None, device=None, **kw):
        seen.append((generator.initial_seed(), generator.get_state().clone()))
        return FIT

    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", record)
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits(1, dim=D)[0])
    kw = dict(W_min=50, k_check=50, iters0=10, max_history=600, init_rmsprop=init_rmsprop)
    K = 4000 if init_rmsprop else 2000
    res_m = multistart_raabbvi(vt.RMSProp(0.1), K, obj, x0[None],
                               torch.Generator().manual_seed(5), verbose=False,
                               schedule="async", **kw)
    calls_m, seen[:] = list(seen), []
    res_s = vt.RAABBVI(vt.RMSProp(0.1), **kw).optimize(
        K, obj, x0, generator=torch.Generator().manual_seed(5))
    assert res_s["k_stopped_final"] is not None
    assert res_m["k_stopped_final"] == [res_s["k_stopped_final"]]
    assert res_m["n_rounds_per_restart"] == [len(res_s["k_mcse"]) - 1]
    assert res_m["conv_iters_hist"][0] == list(res_s["conv_iters_hist"])
    for name in ("learning_rate_hist", "SKL_history", "kappa_hist"):
        assert np.array_equal(res_m[name][0], res_s[name]), name
    assert torch.equal(res_m["opt_param"][0], res_s["opt_param"])
    assert res_m["budget_overrun"] == [0]
    assert len(calls_m) == len(seen) >= 1
    for (seed_m, state_m), (seed_s, state_s) in zip(calls_m, seen):
        assert seed_m == seed_s == 5 and torch.equal(state_m, state_s)


class TableChoice:
    """Resampling indices by inverse-CDF lookup of uniforms read in order
    from one table: a ``jax.random.choice`` stand-in (a callback that vmap
    calls once a restart) and the port's ``resampler`` hook."""

    def __init__(self, uniforms):
        self.uniforms, self.pos = uniforms, 0

    def take(self, p, n):
        u = self.uniforms[self.pos:self.pos + n]
        assert u.shape[0] == n, "uniform table exhausted"
        self.pos += n
        cdf = np.cumsum(np.asarray(p, dtype=float))
        return np.minimum(np.searchsorted(cdf / cdf[-1], u, side="right"), len(cdf) - 1)

    def jax_choice(self, key, a, shape=(), replace=True, p=None, axis=0):
        n = int(np.prod(shape))
        return jax.pure_callback(
            lambda _key, p_: self.take(p_, n).astype(np.int32).reshape(shape),
            jax.ShapeDtypeStruct(tuple(shape), jnp.int32), key, p,
            vmap_method="sequential")

    def choice(self, generator, p, n):
        return torch.as_tensor(self.take(p.cpu().numpy(), n), device=p.device)


@pytest.mark.parametrize("use_resampling", [False, True], ids=["plain", "resampling"])
def test_async_raabbvi_dis_matches_jax(async_clocks, fixed_regression, use_resampling):
    """Stateful DIS at B = 2 on an lr grid, in both modes: the round reset
    gives the advanced restart a fresh eps; with resampling it zeroes every
    restart's refresh clock, as the JAX package zeroes its shared one, so
    every restart refreshes at the next step. Decisions, draws and
    resampling indices consumed, and the optima equal JAX's."""
    dim, S, ess = 2, 50, 25
    table = np.random.RandomState(7).randn(200000, dim)
    idx_j = TableChoice(np.random.RandomState(8).rand(200000))
    idx_t = TableChoice(idx_j.uniforms)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.diagonal_gaussian(np.array([0.8, -0.3]), np.ones(dim))
    model_t, _ = vt.zoo.diagonal_gaussian(np.array([0.8, -0.3]), np.ones(dim), **F64)
    kw = dict(ess_target=ess, num_resampling_batches=3, use_resampling=use_resampling,
              temper_prior_params=np.zeros(2 * dim))
    x0 = np.zeros((2, 2 * dim)) + 0.3 * np.random.RandomState(1).randn(2, 2 * dim)
    # verdicts read at once: each round can end at its first check
    run = dict(learning_rate=np.array([0.08, 0.04]), mcse_threshold=5.0, W_min=50,
               k_check=50, ESS_min=2, check_pipeline=0, max_history=700, iters0=10,
               schedule="async", verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "choice", idx_j.jax_choice)
        obj_j = vj.DISInclusiveKL(vj.MFGaussian(dim, base_sampler=smp_j), model_j, S,
                                  temper_prior=vj.MFGaussian(dim), **kw)
        res_j = vj.parallel.multistart_raabbvi(vj.AveragedRMSProp(0.05), 700, obj_j,
                                               jnp.asarray(x0), jax.random.PRNGKey(5),
                                               **run)
    obj_t = vt.DISInclusiveKL(vt.MFGaussian(dim, base_sampler=smp_t, **F64), model_t, S,
                              temper_prior=vt.MFGaussian(dim, **F64), resampler=idx_t, **kw)
    res_t = multistart_raabbvi(vt.AveragedRMSProp(0.05), 700, obj_t, torch.as_tensor(x0),
                               **run)
    assert_same_run(res_t, res_j)
    assert res_t["obj_state_errors"] == [None, None]
    assert max(res_t["n_rounds_per_restart"]) >= 2
    assert smp_t.pos == smp_j.pos and idx_t.pos == idx_j.pos
    states_j = res_j["resume_state"]["obj_states"]
    for b, state in enumerate(res_t["resume_state"]["obj_states"]):
        close(state["eps"], states_j["eps"][b])
        assert int(state["step"]) == int(states_j["step"])


@pytest.mark.parametrize("use_resampling", [False, True], ids=["plain", "resampling"])
def test_dis_reset_obj_state_rows_matches_jax(use_resampling):
    """One restart of three reset: its eps and ok are fresh; with
    resampling every restart's refresh clock is zero (JAX's one shared
    clock), without it the clock is left; the caches are untouched."""
    dim, S = 2, 6
    kw = dict(ess_target=3, use_resampling=use_resampling, temper_prior_params=np.zeros(4))
    model_j, _ = vj.zoo.diagonal_gaussian(np.zeros(dim), np.ones(dim))
    model_t, _ = vt.zoo.diagonal_gaussian(np.zeros(dim), np.ones(dim), **F64)
    dis_j = vj.DISInclusiveKL(vj.MFGaussian(dim), model_j, S,
                              temper_prior=vj.MFGaussian(dim), **kw)
    dis_t = vt.DISInclusiveKL(vt.MFGaussian(dim, **F64), model_t, S,
                              temper_prior=vt.MFGaussian(dim, **F64), **kw)
    eps, ok = np.array([0.3, 0.2, 0.1]), np.array([True, False, True])
    cache = np.random.RandomState(0).randn(3, S, dim)
    st_j = {"eps": jnp.asarray(eps), "ok": jnp.asarray(ok), "step": jnp.asarray(4)}
    st_t = [{"eps": torch.tensor(e, dtype=torch.float64), "ok": torch.tensor(bool(o)),
             "step": torch.tensor(4)} for e, o in zip(eps, ok)]
    if use_resampling:
        st_j["samples"] = jnp.asarray(cache)
        for b, st in enumerate(st_t):
            st["samples"] = torch.as_tensor(cache[b])
    new_j = dis_j.reset_obj_state_rows(st_j, jnp.asarray([1]))
    new_t = dis_t.reset_obj_state_rows(st_t, [1])
    for b, st in enumerate(new_t):
        assert float(st["eps"]) == float(new_j["eps"][b])
        assert bool(st["ok"]) == bool(new_j["ok"][b])
        assert int(st["step"]) == int(new_j["step"])
        if use_resampling:
            close(st["samples"], new_j["samples"][b], rtol=0)
    assert float(new_t[1]["eps"]) == 1.0 and bool(new_t[1]["ok"])
    assert float(st_t[1]["eps"]) == 0.2  # the caller's list is not written


def test_async_raabbvi_resume_mid_round_matches_uninterrupted(async_clocks,
                                                              fixed_regression, tmp_path):
    """A segment-boundary snapshot taken while a restart is mid-round,
    written to .npz and read back, continues to the uninterrupted run's
    results: decisions, histories, the global step count and the optima."""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits(2, dim=D))
    snaps = []
    full = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj, x0,
                              torch.Generator().manual_seed(2),
                              round_callback=lambda n, s: snaps.append(s), **AS_KW)
    mid = [s for s in snaps if s["active"].all() and 0 < s["round_start"].max()
           and len(set(s["round_start"].tolist())) == 2]
    assert mid, "no snapshot with both restarts running on different round clocks"
    path = str(tmp_path / "async.npz")
    save_pytree(path, mid[0])
    resumed = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj, x0,
                                 torch.Generator().manual_seed(2),
                                 resume_state=load_pytree(path, like=mid[0]), **AS_KW)
    for name in INT_KEYS + FLOAT_KEYS:
        assert resumed[name] == full[name], name
    assert torch.equal(resumed["opt_param"], full["opt_param"])


def test_async_raabbvi_prelude_timeout_resumes(async_clocks, fixed_regression):
    """A wall-clock budget that runs out inside the init_rmsprop warm
    round returns a timed-out result whose resume_state carries the
    round's own state (prelude_flight); resuming finishes as the
    unbudgeted run does. (The stubbed clock advances one second a
    reading, so the budget runs out a few segments in.)"""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits(2, dim=D))
    kw = {**AS_KW, "init_rmsprop": True}
    part = multistart_raabbvi(vt.RMSProp(0.1), 4000, obj, x0, torch.Generator().manual_seed(3),
                              max_time=5.5, **kw)
    assert part["timed_out"] and "prelude_flight" in part["resume_state"]
    assert part["k_stopped_final"] == [None, None] and part["n_rounds_per_restart"] == [0, 0]
    assert part["k_global_steps"] > 0
    full = multistart_raabbvi(vt.RMSProp(0.1), 4000, obj, x0, torch.Generator().manual_seed(3),
                              **kw)
    resumed = multistart_raabbvi(vt.RMSProp(0.1), 4000, obj, x0,
                                 torch.Generator().manual_seed(3),
                                 resume_state=part["resume_state"], **kw)
    assert not full["timed_out"] and not resumed["timed_out"]
    for name in ("k_stopped_final", "n_rounds_per_restart", "k_global_steps",
                 "conv_iters_hist", "learning_rate_hist", "SKL_history"):
        assert resumed[name] == full[name], name
    assert torch.equal(resumed["opt_param"], full["opt_param"])


@pytest.mark.parametrize("init_rmsprop", [False, True], ids=["continuous", "prelude"])
def test_async_raabbvi_escalation_matches_jax(async_clocks, fixed_regression, init_rmsprop):
    """The shared ladder on the async schedule (and, with init_rmsprop, in
    the warm lockstep round, whose events carry over unshifted): the
    climbs land on the same global steps at the same S as in the JAX
    package, with every decision and the draws consumed equal."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(2, dim=D)
    x0 = inits(2, dim=D)
    run = dict(AS_KW, learning_rate=np.array([0.05, 0.03]), rhat_threshold=1.05,
               mc_escalation=4.0, init_rmsprop=init_rmsprop)
    K = 4000 if init_rmsprop else 3000
    res_j = vj.parallel.multistart_raabbvi(vj.RMSProp(0.05), K, obj_j, jnp.asarray(x0),
                                           jax.random.PRNGKey(0), **run)
    res_t = multistart_raabbvi(vt.RMSProp(0.05), K, obj_t, torch.as_tensor(x0), **run)
    np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                  res_j["mc_escalation_history"])
    assert len(res_t["mc_escalation_history"]) >= 1
    assert obj_t.num_mc_samples == obj_j.num_mc_samples
    assert_same_run(res_t, res_j)
    assert smp_t.pos == smp_j.pos
    assert int(res_t["resume_state"]["mc_samples"]) == obj_t.num_mc_samples


def test_async_warm_prelude_budget_exhaustion_books_the_lr(async_clocks, fixed_regression):
    """A restart whose budget runs out exactly after the warm round still
    reports its round-one lr entry, on both schedules (the JAX package's
    test_async_warm_prelude_budget_exhaustion_keeps_lr_bookkeeping)."""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits(1, dim=D))
    gens = [torch.Generator().manual_seed(3)]
    hmc = [torch.Generator().manual_seed(3)]
    probe = trb._async_warm_prelude(vt.RMSProp(0.1), 4000, obj, x0, gens, hmc, rho=0.5,
                                    learning_rate=None, mcse_threshold=0.1,
                                    max_history=600, max_time=None)
    ks = int(probe["k_total"][0])
    assert ks > 0 and probe["lr_hist"][0] == [0.1 * 0.5]
    kw = dict(W_min=50, k_check=50, max_history=600, init_rmsprop=True, verbose=False)
    for schedule in ("lockstep", "async"):
        res = multistart_raabbvi(vt.RMSProp(0.1), ks + 1, obj, x0,
                                 torch.Generator().manual_seed(3), schedule=schedule, **kw)
        assert res["k_stopped_final"] == [None], schedule
        assert res["learning_rate_hist"] == [[0.1 * 0.5]], schedule


def test_async_raabbvi_validation():
    """JAX's ValueErrors for a stateful objective without the row reset
    and a bad schedule, and for a mesh without the restart axis. Departure: with an
    explicit mc_max_samples on an objective without num_mc_samples the
    JAX package's async leg raises a bare AttributeError, the port the
    ValueError of its lockstep leg."""

    class Stateful:
        approx = vt.MFGaussian(2, **F64)
        model = None

        def init_obj_state(self, var_param):
            return {"n": torch.tensor(0)}

        def value_and_grad_with_state(self, var_param, generator, state):
            return var_param.sum(), var_param, state

        def update(self, var_param, direction):
            return var_param - direction

    x0 = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="reset_obj_state_rows"):
        multistart_raabbvi(vt.RMSProp(0.05), 100, Stateful(), x0, schedule="async")
    model, _ = vt.zoo.logistic_regression(dim=2, n_data=20, **F64)
    obj = vt.ExclusiveKL(vt.MFGaussian(2, **F64), model, 2)
    with pytest.raises(ValueError, match='"schedule"'):
        multistart_raabbvi(vt.RMSProp(0.05), 100, obj, x0, schedule="bogus")
    with pytest.raises(ValueError, match="no 'restart' axis"):
        multistart_raabbvi(vt.RMSProp(0.05), 100, obj, x0, schedule="async",
                           mesh=type("MCMesh", (), {"mesh_dim_names": ("mc",)})())

    class NoS:
        approx = vj.MFGaussian(2)
        model = None
        scannable = True

    with pytest.raises(AttributeError):
        vj.parallel.multistart_raabbvi(vj.RMSProp(0.05), 100, NoS(), jnp.zeros((2, 4)),
                                       jax.random.PRNGKey(0), schedule="async",
                                       mc_escalation=4.0, mc_max_samples=64)
    NoS.approx = vt.MFGaussian(2, **F64)
    with pytest.raises(ValueError, match="num_mc_samples"):
        multistart_raabbvi(vt.RMSProp(0.05), 100, NoS(), x0, schedule="async",
                           mc_escalation=4.0, mc_max_samples=64)


@pytest.mark.parametrize("init_rmsprop", [False, True])
def test_bbvi_async_schedule_runs(init_rmsprop):
    """bbvi routes multistart_kwargs=dict(schedule="async") to the async
    schedule, with the default escalation armed (no climb on a healthy
    target), with and without the init_rmsprop warm round."""
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **F64)
    res = vt.bbvi(2, log_density=model, num_mc_samples=40, n_iters=3000, num_restarts=2,
                  learning_rate=0.1, device="cpu", dtype=torch.float64,
                  RAABBVI_kwargs=dict(init_rmsprop=init_rmsprop, mcse_threshold=0.05,
                                      ESS_min=10, max_history=2000),
                  multistart_kwargs=dict(schedule="async", verbose=False),
                  generator=torch.Generator().manual_seed(11))
    assert res["opt_params"].shape == (2, 4)
    assert torch.isfinite(res["opt_param"]).all()
    assert min(res["n_rounds_per_restart"]) >= 1
    assert len(res["mc_escalation_history"]) == 0
    close(res["opt_param"][:2], np.zeros(2), atol=0.2)
