"""The port's ``multistart_faso`` against the JAX package, in float64 on
the CPU, and against the port's own ``FASO`` at ``B = 1``. The helpers
here (the injected draws, the stubbed clocks) serve the other
``test_torch_multistart_*`` files too.

Both packages draw their base normals from one numpy table through the
families' ``base_sampler`` hook. The JAX engine vmaps its segment scan
over restarts, so its ``pure_callback`` hook runs with
``vmap_method="sequential"``: inside each step it is called once a
restart, restart 0 first, which is the order in which the port steps its
restarts. The MCSE recheck clock is stubbed in both packages, as in
tests/test_torch_faso.py.

Departure, pinned by ``test_restart_generators_are_the_callers_at_b1``:
the JAX package splits the key per restart; the port seeds one
``torch.Generator`` a restart from the caller's generator, and a single
restart draws from the caller's generator itself.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.faso as jfaso  # noqa: E402
import viabel_tpu.parallel.multistart as jms  # noqa: E402
import viabel_tpu.parallel.raabbvi as jrb  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
import viabel_torch.parallel.multistart as tms  # noqa: E402
import viabel_torch.parallel.raabbvi as trb  # noqa: E402
from viabel_torch.parallel import multistart_faso  # noqa: E402
from viabel_torch.parallel.multistart import restart_generators  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)
D = 4   # the model's dimension; FullRankGaussian(D) has D + D^2 parameters
B = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FixedTimer:
    """A negligible MCSE cost: the recheck growth sits at its 1.05 floor."""

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


@pytest.fixture(scope="module")
def fixed_clocks():
    """The stubbed clocks of both packages' FASO and multistart engines,
    for a whole module (the JAX runs are shared through module fixtures)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jfaso, tfaso, jms, tms):
            mp.setattr(mod, "Timer", FixedTimer)
        for mod in (jfaso, tfaso, jms, tms, jrb, trb):
            mp.setattr(mod, "_now", FakeClock.now)
        yield


class StreamNormal:
    """Consecutive rows of one numpy table of standard normals, handed out
    on the JAX side by a ``pure_callback`` that vmap calls once a restart."""

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
            jax.ShapeDtypeStruct((n_samples, width), dtype), key,
            vmap_method="sequential")


class TorchStreamNormal(StreamNormal):
    def normal(self, generator, n_samples, width, dtype, device):
        return torch.as_tensor(self.take(n_samples, width), dtype=dtype, device=device)


def objectives(S, seed=0, dim=D):
    """STL ExclusiveKL over FullRankGaussian(dim) on logistic_regression in
    both packages, drawing from one table."""
    table = np.random.RandomState(seed).randn(400000, dim)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.logistic_regression(dim=dim, n_data=40)
    model_t, _ = vt.zoo.logistic_regression(dim=dim, n_data=40, **F64)
    obj_j = vj.ExclusiveKL(vj.FullRankGaussian(dim, base_sampler=smp_j), model_j, S,
                           use_path_deriv=True)
    obj_t = vt.ExclusiveKL(vt.FullRankGaussian(dim, base_sampler=smp_t, **F64), model_t,
                           S, use_path_deriv=True)
    return (obj_j, smp_j), (obj_t, smp_t)


def inits(n=B, seed=1, dim=D, scale=0.1):
    return scale * np.random.RandomState(seed).randn(n, dim + dim * dim)


def close(got, want, rtol=1e-8, atol=1e-12, **kw):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, **kw)


#: B = 3 with a per-restart lr grid and MCSE thresholds at a gate (1.05)
#: that stalls once: the shared ladder climbs S 2 -> 8, then every
#: restart stops, at different iterations
FASO_KW = dict(learning_rate=np.array([0.05, 0.03, 0.08]),
               mcse_threshold=np.array([0.1, 0.15, 0.2]), W_min=50, k_check=50,
               rhat_threshold=1.05, mc_escalation=4.0)


@pytest.mark.parametrize("diagnostics", [False, True], ids=["pipelined", "diagnostics"])
def test_multistart_faso_matches_jax(fixed_clocks, diagnostics):
    """B = 3 against the JAX engine: per-restart k_conv / k_Rhat /
    k_stopped, the shared escalation ladder and the draws consumed are
    equal; opt_param (frozen at each restart's own stop), final_param, the
    loss histories and the at-stop step-rule states agree to rtol 1e-8;
    with diagnostics, so do the per-check iterate-average trail (stopped
    rows frozen), the due masks, the MCSE rows and the gradient
    histories. (One test a mode: under xdist each test of a shared
    fixture would run the pair again on its own worker.)"""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(2)
    x0 = inits()
    res_j = vj.parallel.multistart_faso(vj.RMSProp(0.05), 1000, obj_j, jnp.asarray(x0),
                                        jax.random.PRNGKey(0), diagnostics=diagnostics,
                                        **FASO_KW)
    res_t = multistart_faso(vt.RMSProp(0.05), 1000, obj_t, torch.as_tensor(x0),
                            torch.Generator().manual_seed(0), diagnostics=diagnostics,
                            **FASO_KW)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    assert all(k is not None for k in res_t["k_stopped"])
    assert len(set(res_t["k_stopped"])) > 1  # the restarts stop apart
    np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                  res_j["mc_escalation_history"])
    assert len(res_t["mc_escalation_history"]) >= 1
    assert obj_t.num_mc_samples == obj_j.num_mc_samples
    assert smp_t.pos == smp_j.pos
    close(res_t["opt_param"], res_j["opt_param"])
    close(res_t["final_param"], res_j["final_param"])
    close(res_t["value_history"], res_j["value_history"])
    for b, state in enumerate(res_t["opt_states_at_stop"]):
        close(state["avg_grad_sq"], res_j["opt_states_at_stop"]["avg_grad_sq"][b])
    if not diagnostics:
        assert "grad_history" not in res_t and "grad_history" not in res_j
        return
    np.testing.assert_array_equal(res_t["iterate_average_k_history"],
                                  res_j["iterate_average_k_history"])
    close(res_t["iterate_average_history"], res_j["iterate_average_history"])
    np.testing.assert_array_equal(res_t["ess_and_mcse_k_history"],
                                  res_j["ess_and_mcse_k_history"])
    np.testing.assert_array_equal(res_t["ess_due_history"], res_j["ess_due_history"])
    # the JAX rows carry its packed layout's padding past the D + D^2 columns
    due, n = res_t["ess_due_history"], res_t["mcse_history"].shape[-1]
    close(res_t["mcse_history"][due], np.asarray(res_j["mcse_history"])[due][:, :n],
          rtol=1e-6)
    close(res_t["grad_history"], res_j["grad_history"], atol=1e-10)


@pytest.mark.parametrize("diagnostics", [False, True])
def test_multistart_faso_b1_is_the_ports_faso(fixed_clocks, diagnostics):
    """A single restart draws from the caller's generator itself: at B = 1
    the engine is FASO.optimize on the same generator, bit for bit."""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 2, use_path_deriv=True)
    x0 = torch.as_tensor(inits(1)[0])
    kw = dict(W_min=50, k_check=50, mcse_threshold=0.2, mc_escalation=4.0)
    sgo = vt.RMSProp(0.05, diagnostics=diagnostics)
    res_m = multistart_faso(sgo, 800, obj, x0[None], torch.Generator().manual_seed(4), **kw)
    obj.num_mc_samples = 2
    res_s = vt.FASO(sgo, **kw).optimize(800, obj, x0, generator=torch.Generator().manual_seed(4))
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_m[name][0] == res_s[name], name
    np.testing.assert_array_equal(res_m["mc_escalation_history"],
                                  res_s["mc_escalation_history"])
    assert torch.equal(res_m["opt_param"][0], res_s["opt_param"])
    assert torch.equal(res_m["value_history"][0], res_s["value_history"])
    if diagnostics:
        assert torch.equal(res_m["iterate_average_history"][:, 0],
                           res_s["iterate_average_history"])
        np.testing.assert_array_equal(res_m["grad_history"][0], res_s["grad_history"])


def test_multistart_faso_resume_matches_uninterrupted(fixed_clocks, tmp_path):
    """Stop a B = 3 run with verdicts in flight, write its resume_state to
    a checkpoint, read it back and resume: the per-restart results equal
    the uninterrupted run's, generators included."""
    from viabel_torch.checkpoint import load_pytree, save_pytree
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 4, use_path_deriv=True)
    x0 = torch.as_tensor(inits())
    kw = dict(W_min=50, k_check=50, mcse_threshold=0.1, max_history=600,
              learning_rate=np.array([0.05, 0.03, 0.08]))
    full = multistart_faso(vt.RMSProp(0.05), 1500, obj, x0,
                           torch.Generator().manual_seed(9), **kw)
    part = multistart_faso(vt.RMSProp(0.05), 300, obj, x0,
                           torch.Generator().manual_seed(9), **kw)
    assert part["resume_state"]["pending_checks"], "expected in-flight checks"
    path = str(tmp_path / "multistart.npz")
    save_pytree(path, part["resume_state"])
    restored = load_pytree(path, like=part["resume_state"])
    kw.pop("learning_rate")  # the checkpointed lr grid is restored
    resumed = multistart_faso(vt.RMSProp(0.05), 1500, obj, x0, resume_state=restored, **kw)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert resumed[name] == full[name], name
    assert all(k is not None for k in full["k_stopped"])
    assert torch.equal(resumed["opt_param"], full["opt_param"])
    assert torch.equal(resumed["final_param"], full["final_param"])


def test_multistart_faso_validation():
    """JAX's errors: a host-loop objective, an unsettable escalation, a
    mesh without the restart axis; a generators list of the wrong
    length."""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    obj = vt.ExclusiveKL(vt.FullRankGaussian(D, **F64), model, 2)
    x0 = torch.zeros((2, D + D * D), dtype=torch.float64)

    class HostLoop:
        scannable = False
        approx = obj.approx

    with pytest.raises(ValueError, match="scannable"):
        multistart_faso(vt.RMSProp(0.05), 10, HostLoop(), x0)
    with pytest.raises(ValueError, match="StochasticGradientOptimizer"):
        multistart_faso(object(), 10, obj, x0)
    with pytest.raises(ValueError, match="greater than one"):
        multistart_faso(vt.RMSProp(0.05), 10, obj, x0, mc_escalation=1.0)
    with pytest.raises(ValueError, match="2 restarts"):
        multistart_faso(vt.RMSProp(0.05), 10, obj, x0, generators=[torch.Generator()])
    with pytest.raises(ValueError, match="no 'restart' axis"):
        multistart_faso(vt.RMSProp(0.05), 10, obj, x0,
                        mesh=type("MCMesh", (), {"mesh_dim_names": ("mc",)})())


def test_restart_generators_are_the_callers_at_b1():
    """The documented departure: B = 1 takes the caller's generator; B > 1
    seeds one generator a restart from it, distinct and reproducible."""
    g = torch.Generator().manual_seed(3)
    assert restart_generators(g, 1, "cpu")[0] is g
    draws = [[torch.randn(2, generator=r) for r in restart_generators(
        torch.Generator().manual_seed(3), 3, "cpu")] for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    assert not torch.equal(draws[0][0], draws[0][1])
