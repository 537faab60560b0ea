"""The port's lockstep ``multistart_raabbvi`` against the JAX package, in
float64 on the CPU, and against the port's own ``RAABBVI`` at ``B = 1``.

The draws are injected as in tests/test_torch_multistart.py. The
regression's HMC draws cannot be shared between the packages (and take
several seconds a call on a CPU), so ``RAABBVI.weighted_linear_regression`` is
stubbed on both sides with a fixed ``(kappa, c)``, as
tests/test_torch_faso.py's ``test_wls_and_skl_round_update_match_jax``
does; the B = 1 test records the HMC generator each call receives.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from test_torch_multistart import (F64, close, fixed_clocks, inits,  # noqa: E402
                                   objectives)
from viabel_torch.parallel import multistart_raabbvi  # noqa: E402

__all__ = ["fixed_clocks"]  # a fixture, used by name
D = 3
FIT = (None, 0.6, 0.8)  # the stubbed regression's (fit, kappa, c)
#: two restarts on an lr grid; iters0 = 10 makes each round's predicted
#: cost count, so restart 1 terminates a round before restart 0
RB_KW = dict(W_min=50, k_check=50, iters0=10, max_history=600,
             learning_rate=np.array([0.1, 0.05]))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixed_regression():
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (vj, vt):
            mp.setattr(pkg.RAABBVI, "weighted_linear_regression", lambda self, *a, **k: FIT)
        yield


def test_multistart_raabbvi_matches_jax(fixed_clocks, fixed_regression):
    """Rounds, per-restart terminations, budgets, convergence iterations
    and the draws consumed are equal (restart 1 terminates a round before
    restart 0 and rides along at lr = 0); each restart's per-round
    histories and the final averages agree to rtol 1e-8."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D)
    x0 = inits(2, dim=D)
    res_j = vj.parallel.multistart_raabbvi(vj.RMSProp(0.1), 3000, obj_j, jnp.asarray(x0),
                                           jax.random.PRNGKey(0), verbose=False, **RB_KW)
    res_t = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj_t, torch.as_tensor(x0),
                               verbose=False, **RB_KW)
    for name in ("k_stopped_final", "n_rounds", "k_global_steps", "k_total",
                 "conv_iters_hist", "budget_overrun", "predicted_iters_hist"):
        assert res_t[name] == res_j[name], name
    assert all(k is not None for k in res_t["k_stopped_final"])
    assert len(res_t["learning_rate_hist"][0]) > len(res_t["learning_rate_hist"][1])
    assert smp_t.pos == smp_j.pos
    for name in ("learning_rate_hist", "SKL_history", "stopping_crt", "kappa_hist",
                 "c_hist"):
        assert [len(h) for h in res_t[name]] == [len(h) for h in res_j[name]], name
        for got, want in zip(res_t[name], res_j[name]):
            close(np.asarray(got, dtype=float), np.asarray(want, dtype=float))
    close(res_t["opt_param"], res_j["opt_param"])


@pytest.mark.parametrize("init_rmsprop", [False, True])
def test_multistart_raabbvi_b1_is_the_ports_raabbvi(fixed_clocks, monkeypatch, init_rmsprop):
    """At B = 1 the restart draws from the caller's generator and its
    regression from an HMC generator seeded like RAABBVI's: the run is
    RAABBVI.optimize's, bit for bit, and every regression call sees the
    same HMC generator state."""
    seen = []

    def record(self, y, x, generator=None, device=None, **kw):
        seen.append((generator.initial_seed(), generator.get_state().clone()))
        return FIT

    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", record)
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits(1, dim=D)[0])
    kw = dict(W_min=50, k_check=50, iters0=10, max_history=600, init_rmsprop=init_rmsprop)
    res_m = multistart_raabbvi(vt.RMSProp(0.1), 2000, obj, x0[None],
                               torch.Generator().manual_seed(5), verbose=False, **kw)
    calls_m, seen[:] = list(seen), []
    res_s = vt.RAABBVI(vt.RMSProp(0.1), **kw).optimize(
        2000, obj, x0, generator=torch.Generator().manual_seed(5))
    assert res_m["k_stopped_final"][0] == res_s["k_stopped_final"]
    assert res_m["n_rounds"] == len(res_s["k_mcse"]) - 1
    close(res_m["learning_rate_hist"][0], res_s["learning_rate_hist"], rtol=0)
    close(res_m["SKL_history"][0], res_s["SKL_history"], rtol=0)
    assert torch.equal(res_m["opt_param"][0], res_s["opt_param"])
    assert len(calls_m) == len(seen) >= 1
    for (seed_m, state_m), (seed_s, state_s) in zip(calls_m, seen):
        assert seed_m == seed_s == 5 and torch.equal(state_m, state_s)


def test_multistart_raabbvi_round_resume_matches_uninterrupted(fixed_clocks,
                                                               fixed_regression):
    """A round-boundary snapshot from round_callback, passed back as
    resume_state, continues to the uninterrupted run's results."""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits(2, dim=D))
    snaps = {}
    full = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj, x0, torch.Generator().manual_seed(2),
                              verbose=False, round_callback=lambda n, s: snaps.setdefault(n, s),
                              **RB_KW)
    assert full["n_rounds"] >= 3 and 2 in snaps
    resumed = multistart_raabbvi(vt.RMSProp(0.1), 3000, obj, x0, verbose=False,
                                 resume_state=snaps[2], **RB_KW)
    for name in ("k_stopped_final", "n_rounds", "k_global_steps", "conv_iters_hist",
                 "learning_rate_hist", "SKL_history"):
        assert resumed[name] == full[name], name
    assert torch.equal(resumed["opt_param"], full["opt_param"])


def test_multistart_raabbvi_schedule_and_mesh_are_deferred():
    """The mesh runs (tests/test_torch_multistart_sharded.py) and refuses
    one without the restart axis, and the async schedule runs
    (tests/test_torch_async_raabbvi.py); JAX's ValueErrors for those, for
    an unknown schedule and for a family without closed-form KL."""
    model, _ = vt.zoo.logistic_regression(dim=2, n_data=20, **F64)
    obj = vt.ExclusiveKL(vt.MFGaussian(2, **F64), model, 2)
    x0 = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="no 'restart' axis"):
        multistart_raabbvi(vt.RMSProp(0.05), 10, obj, x0,
                           mesh=type("MCMesh", (), {"mesh_dim_names": ("mc",)})())
    with pytest.raises(ValueError, match='"schedule"'):
        multistart_raabbvi(vt.RMSProp(0.05), 10, obj, x0, schedule="other")
    net = vt.NeuralNet([(2, 2)], **F64)
    with pytest.raises(ValueError, match="closed-form"):
        multistart_raabbvi(vt.RMSProp(0.05), 10, vt.ExclusiveKL(net, model, 2),
                           torch.zeros((2, net.var_param_dim), dtype=torch.float64))
