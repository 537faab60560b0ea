"""Checkpoint, resume and wall-clock budgets of the port's FASO and
RAABBVI, within the port and across from the JAX package.

The port's runs are compared with themselves: a run stopped by its
iteration or time budget, written with ``viabel_torch.checkpoint`` and
resumed must reproduce the uninterrupted run. A FASO checkpoint that the
JAX package writes resumes in the port on the same injected draw stream.
The MCSE recheck schedule reads the wall clock, so the clocks are stubbed
where runs are compared (as tests/test_checkpoint.py's and
tests/test_max_time.py's counterparts do in the JAX package).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.faso as jfaso  # noqa: E402
from viabel_tpu import checkpoint as jcheckpoint  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
from viabel_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from viabel_torch.convert import resume_state_from_jax  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixed_clocks(monkeypatch):
    """A negligible fake MCSE cost in both packages: the recheck growth
    sits at its 1.05 floor, whatever the clock reads."""

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


@pytest.fixture
def ticking_clock(monkeypatch):
    """The port's counterpart of tests/test_optimizers.py::_stub_clock: a
    fake clock that ticks one second a read, and a Timer that ticks the
    same clock on entry and exit."""

    class FakeClock:
        t = 0.0

        @classmethod
        def now(cls):
            cls.t += 1.0
            return cls.t

    class TickingTimer:
        interval = 1.0

        def __enter__(self):
            self.start = FakeClock.now()
            return self

        def __exit__(self, *exc):
            self.interval = FakeClock.now() - self.start
            return False

    monkeypatch.setattr(tfaso, "Timer", TickingTimer)
    monkeypatch.setattr(tfaso, "_now", FakeClock.now)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_pytree_roundtrip_keeps_structure_kinds_and_dtypes(tmp_path):
    """Nested dicts, lists and tuples of tensors, numpy arrays and Python
    scalars come back as the template's leaves; None and empty
    containers hold no leaf; without a template, a list of tensors."""
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3), dtype=torch.float64),
                                          "d": 7, "f": 0.25},
            "e": [torch.tensor(1.5), torch.tensor([True, False])],
            "n": np.arange(3, dtype=np.int32), "flight": (), "none": None}
    path = str(tmp_path / "state.npz")
    save_pytree(path, tree)
    restored = load_pytree(path, like=tree)
    assert list(restored) == list(tree) and restored["flight"] == ()
    assert restored["none"] is None
    assert restored["b"]["d"] == 7 and isinstance(restored["b"]["d"], int)
    assert restored["b"]["f"] == 0.25
    assert restored["b"]["c"].dtype == torch.float64
    assert torch.equal(restored["e"][1], tree["e"][1])
    assert restored["n"].dtype == np.int32
    flat = load_pytree(path, device="cpu")
    assert len(flat) == 7 and all(isinstance(x, torch.Tensor) for x in flat)
    torch.testing.assert_close(flat[0], tree["a"])  # "a" sorts first
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, like={"a": torch.zeros(3)})


def test_pytree_files_cross_between_the_packages(tmp_path):
    """The layout is the JAX package's: each package reads the other's
    file in the same leaf order."""
    tree = {"z": np.arange(4.0), "a": {"k": 3, "v": np.ones(2, np.float32)},
            "l": [np.asarray(True), np.zeros((2, 2))]}
    p_jax, p_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcheckpoint.save_pytree(p_jax, {k: jax.tree_util.tree_map(jnp.asarray, v)
                                    for k, v in tree.items()})
    save_pytree(p_port, tree)
    from_jax = load_pytree(p_jax, like=tree)
    from_port = jcheckpoint.load_pytree(p_port, like=tree)
    for a, b, c in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(from_jax),
                       jax.tree_util.tree_leaves(from_port)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_orbax_backend_is_deferred_with_a_roadmap_pointer(tmp_path):
    """The Orbax pair is no longer deferred: both packages have it, and the
    port's (over torch.distributed.checkpoint) round-trips a tree in one
    process (tests/test_torch_dcp.py holds it further)."""
    from viabel_torch import checkpoint
    for name in ("save_pytree_orbax", "load_pytree_orbax"):
        assert hasattr(jcheckpoint, name) and callable(getattr(checkpoint, name))
    tree = {"ring": torch.arange(6.0).reshape(2, 3), "k": 4}
    checkpoint.save_pytree_orbax(str(tmp_path / "ckpt"), tree)
    back = checkpoint.load_pytree_orbax(str(tmp_path / "ckpt"), like=tree)
    assert torch.equal(back["ring"], tree["ring"]) and back["k"] == 4


def _gaussian_objective():
    """tests/test_checkpoint.py's setup: MFGaussian(2) on a standard
    diagonal Gaussian, S = 20."""
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **F64)
    approx = vt.MFGaussian(2, **F64)
    return vt.ExclusiveKL(approx, model, 20), approx


def _assert_same_run(got, want, rtol=1e-10):
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert got[name] == want[name], name
    np.testing.assert_allclose(got["opt_param"].numpy(), want["opt_param"].numpy(),
                               rtol=rtol, atol=1e-14)


def test_faso_resume_matches_an_uninterrupted_run(fixed_clocks, tmp_path):
    """3,000 iterations straight against 300, a checkpoint, and a resume to
    3,000: the same parameters and convergence bookkeeping. The resumed
    run is handed an unseeded generator; the checkpoint's generator state
    is what continues the stream."""
    obj, approx = _gaussian_objective()

    def make_opt():
        return vt.FASO(vt.RMSProp(0.05), W_min=200, mcse_threshold=0.05, max_history=600)

    full = make_opt().optimize(3000, obj, approx.init_param(), generator=_gen())
    part = make_opt().optimize(300, obj, approx.init_param(), generator=_gen())
    assert part["k_stopped"] is None and not part["timed_out"]
    path = str(tmp_path / "faso.npz")
    save_pytree(path, part["resume_state"])
    restored = load_pytree(path, like=part["resume_state"])
    resumed = make_opt().optimize(3000, obj, approx.init_param(),
                                  generator=torch.Generator(), resume_state=restored)
    assert full["k_stopped"] is not None
    _assert_same_run(resumed, full)
    assert resumed["value_history"].shape[0] + 300 == full["value_history"].shape[0]


@pytest.mark.parametrize("quantile", [None, 0.9])
def test_faso_resume_with_checks_in_flight(fixed_clocks, tmp_path, quantile):
    """Stopped at k = 800 with check_pipeline = 4, the R-hat verdicts
    dispatched at 400, 600 and 800 are still in flight: they ride the
    resume state as host arrays and replay on the same schedule, in the
    max-gate and the quantile-gate modes."""
    obj, approx = _gaussian_objective()

    def make_opt():
        return vt.FASO(vt.RMSProp(0.05), W_min=200, mcse_threshold=0.05,
                       max_history=600, rhat_quantile=quantile)

    full = make_opt().optimize(3000, obj, approx.init_param(), generator=_gen())
    part = make_opt().optimize(800, obj, approx.init_param(), generator=_gen())
    pending = part["resume_state"]["pending_checks"]
    assert [ck["k"] for ck in pending] == [400, 600, 800]
    assert all(isinstance(ck["r_hats"], np.ndarray) for ck in pending)
    path = str(tmp_path / f"faso_inflight_{quantile}.npz")
    save_pytree(path, part["resume_state"])
    restored = load_pytree(path, like=part["resume_state"])
    resumed = make_opt().optimize(3000, obj, approx.init_param(), generator=_gen(9),
                                  resume_state=restored)
    _assert_same_run(resumed, full)


def test_faso_resume_refuses_a_generator_state_of_another_device_type(fixed_clocks):
    """A CPU generator's state is 5,056 bytes, a CUDA generator's 16 (seed
    and offset); one cannot seed the other, and resuming raises instead
    of reseeding."""
    obj, approx = _gaussian_objective()
    part = vt.FASO(vt.RMSProp(0.05), W_min=200).optimize(
        200, obj, approx.init_param(), generator=_gen())
    rs = dict(part["resume_state"], generator_state=torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="another device type"):
        vt.FASO(vt.RMSProp(0.05), W_min=200).optimize(
            400, obj, approx.init_param(), generator=_gen(), resume_state=rs)


def test_faso_zero_budget_resumes_to_the_full_run(fixed_clocks):
    """max_time = 0 returns before the first segment (k = 0, timed_out,
    resumable); resuming without a budget reproduces the full run."""
    obj, approx = _gaussian_objective()

    def make_opt():
        return vt.FASO(vt.RMSProp(0.05), W_min=200, mcse_threshold=0.05, max_history=600)

    stopped = make_opt().optimize(3000, obj, approx.init_param(), generator=_gen(),
                                  max_time=0.0)
    assert stopped["timed_out"] and stopped["k_stopped"] is None
    assert "value_history" not in stopped  # no segment ran
    assert torch.equal(stopped["opt_param"], approx.init_param())
    full = make_opt().optimize(3000, obj, approx.init_param(), generator=_gen())
    assert not full["timed_out"]
    resumed = make_opt().optimize(3000, obj, approx.init_param(), generator=_gen(5),
                                  resume_state=stopped["resume_state"])
    _assert_same_run(resumed, full)


class DummyApproximationFamily:
    supports_kl = True
    dim = 1

    def kl(self, param1, param2):
        return torch.mean((param1 - param2) ** 2)


class DummyObjective:
    """tests/test_optimizers.py's quadratic with Gaussian gradient noise,
    the noise drawn from the run's generator."""

    def __init__(self, target, noise=1.0):
        self._target = torch.as_tensor(target, dtype=torch.float64)
        self._noise = noise
        self.approx = DummyApproximationFamily()

    def value_and_grad(self, x, generator):
        value = 0.5 * torch.sum((x - self._target) ** 2)
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
        return value, x - self._target + self._noise * noise

    def update(self, x, direction):
        return x - direction


def test_faso_max_time_mid_run_then_resume_completes():
    """A small real-clock budget stops a run that detection would not end
    at a segment boundary; the resumed call gets a fresh allotment and a
    per-run mcse_threshold, and completes. The constructor's max_time is
    each call's default."""
    true_value = np.arange(2, dtype=float)
    objective = DummyObjective(true_value, noise=1.0)
    init = torch.as_tensor(true_value + 0.3)
    opt = vt.FASO(vt.RMSProp(0.01), W_min=100, mcse_threshold=1e-8,
                  max_history=2000, max_time=0.05)
    part = opt.optimize(10_000_000, objective, init, generator=_gen(5))
    assert part["timed_out"] and part["k_stopped"] is None
    k_part = int(part["value_history"].shape[0]) if "value_history" in part else 0
    assert 0 < k_part < 10_000_000
    assert k_part % 100 == 0  # stopped on a segment boundary
    assert part["resume_state"]["k"] == k_part
    done = opt.optimize(k_part + 3000, objective, init, generator=_gen(5),
                        resume_state=part["resume_state"], mcse_threshold=1.0,
                        max_time=600.0)
    assert not done["timed_out"] and done["k_stopped"] is not None
    np.testing.assert_allclose(done["opt_param"].numpy(), true_value, atol=0.3)


def test_faso_max_time_validation():
    with pytest.raises(ValueError, match="max_time"):
        vt.FASO(vt.RMSProp(0.01), max_time=-1.0)


def _fake_regression(self, y, x, s=9.0, a=0.25, n_chains=4, generator=None,
                     device="cpu"):
    """A cheap stand-in for RAABBVI's HMC regression that still draws from
    the regression's generator, so resuming that generator is checked."""
    draw = torch.randn(8, generator=generator, dtype=torch.float64)
    log_c = float(np.mean(y)) + 0.01 * float(draw.mean())
    fit = {"log_c": torch.full((8,), log_c, dtype=torch.float64),
           "sigma": torch.ones(8, dtype=torch.float64)}
    return fit, 1.0, float(np.exp(log_c))


def _make_raabbvi(**kw):
    return vt.RAABBVI(vt.AveragedRMSProp(0.01), rho=0.5, mcse_threshold=0.01,
                      inefficiency_threshold=1.0, accuracy_threshold=0.01,
                      max_history=2000, ESS_min=10, **kw)


def _assert_same_raabbvi(got, want):
    np.testing.assert_allclose(got["opt_param"].numpy(), want["opt_param"].numpy(),
                               rtol=1e-10)
    for name in ("conv_iters_hist", "k_mcse", "k_conv", "k_Rhat", "k_stopped_final"):
        assert list(np.atleast_1d(got[name])) == list(np.atleast_1d(want[name])), name
    for name in ("learning_rate_hist", "SKL_history", "kappa_hist", "c_hist"):
        np.testing.assert_allclose(got.get(name, []), want.get(name, []), rtol=1e-12)


def test_raabbvi_resume_matches_an_uninterrupted_run(ticking_clock, monkeypatch,
                                                        tmp_path):
    """Stop RAABBVI inside round 2 (an R-hat verdict in flight) and exactly
    between rounds 2 and 3; each resume reproduces the uninterrupted run:
    round counter, decayed learning rate, histories, step-rule state and
    both generators. A spent budget returns the standard keys and stays
    resumable."""
    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", _fake_regression)
    true_value = np.arange(2, dtype=float)
    init = torch.as_tensor(true_value + 0.5)

    def run(K, **kw):
        return _make_raabbvi().optimize(K, DummyObjective(true_value, noise=0.2), init,
                                        generator=_gen(3), **kw)

    full = run(6000)
    assert full["k_mcse"][:3] == [0, 1400, 2000]  # rounds of 1,400 and 2,000 steps
    assert len(full["SKL_history"]) == 1

    part = run(2000)
    rs = part["resume_state"]
    assert part["k_stopped_final"] is None and isinstance(rs["flight"], dict)
    assert rs["flight"]["pending_checks"], "expected an in-flight verdict"
    path = str(tmp_path / "raabbvi.npz")
    save_pytree(path, rs)
    restored = load_pytree(path, like=rs)
    prog_ks = []
    resumed = run(6000, resume_state=restored,
                  progress_callback=lambda kk, loss: prog_ks.append(kk))
    assert prog_ks == sorted(prog_ks) and len(set(prog_ks)) == len(prog_ks)
    assert prog_ks[0] > 1400  # resumes inside round 2, after round 1's steps
    _assert_same_raabbvi(resumed, full)

    part2 = run(1401 + 2001)  # both rounds' budgets, so it stops between them
    rs2 = part2["resume_state"]
    assert rs2 is not None and rs2["flight"] == ()
    _assert_same_raabbvi(run(6000, resume_state=rs2), full)

    spent = run(1000, resume_state=rs)
    assert spent["k_stopped_final"] is None
    for name in ("conv_iters_hist", "learning_rate_hist", "k_mcse", "k_conv",
                 "k_Rhat", "iterate_average_curr_hist", "timed_out"):
        assert name in spent, name
    _assert_same_raabbvi(run(6000, resume_state=spent["resume_state"]), full)


def test_raabbvi_budget_covers_the_whole_run(ticking_clock, monkeypatch):
    """RAABBVI's budget covers the whole run: the ticking clock exhausts a
    0.05 s budget before the first round, the run returns timed_out with
    the standard keys and a resumable payload, and the resumed run
    reproduces the unbudgeted one."""
    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", _fake_regression)
    true_value = np.arange(2, dtype=float)
    init = torch.as_tensor(true_value + 0.5)

    def run(**kw):
        return _make_raabbvi().optimize(3002, DummyObjective(true_value, noise=0.2),
                                        init, generator=_gen(3), **kw)

    part = run(max_time=0.05)
    assert part["timed_out"] and part["k_stopped_final"] is None
    assert part["resume_state"] is not None
    full = run()
    assert not full["timed_out"]
    resumed = run(resume_state=part["resume_state"])
    assert not resumed["timed_out"]
    _assert_same_raabbvi(resumed, full)


def test_raabbvi_max_time_inside_a_round_leaves_a_flight(ticking_clock, monkeypatch):
    """A budget that runs out inside the first round stops it through
    FASO's own budget: the payload carries the round's FASO state under
    "flight", and the resumed run reproduces the unbudgeted one."""
    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", _fake_regression)
    true_value = np.arange(2, dtype=float)
    init = torch.as_tensor(true_value + 0.5)

    def run(**kw):
        return _make_raabbvi().optimize(3002, DummyObjective(true_value, noise=0.2),
                                        init, generator=_gen(3), **kw)

    part = run(max_time=6.0)  # the ticking clock: a few segment boundaries
    rs = part["resume_state"]
    assert part["timed_out"] and isinstance(rs["flight"], dict)
    assert 0 < rs["flight"]["k"] < 1400
    _assert_same_raabbvi(run(resume_state=rs), run())


class StreamNormal:
    """Consecutive rows of one numpy table of standard normals; the JAX
    hook hands them out through ``pure_callback`` inside the jitted
    segment scan."""

    def __init__(self, table, pos=0):
        self.table, self.pos = table, pos

    def take(self, n, width):
        rows = self.table[self.pos:self.pos + n, :width]
        assert rows.shape[0] == n, "draw table exhausted"
        self.pos += n
        return rows

    def normal(self, key, n_samples, width, dtype):
        return jax.pure_callback(
            lambda _key: self.take(n_samples, width).astype(dtype),
            jax.ShapeDtypeStruct((n_samples, width), dtype), key)


class TorchStreamNormal(StreamNormal):
    def normal(self, generator, n_samples, width, dtype, device):
        return torch.as_tensor(self.take(n_samples, width), dtype=dtype, device=device)


D = 4


def _stl_objective(pkg, sampler, S=1):
    if pkg is vj:
        model, _ = vj.zoo.logistic_regression(dim=D, n_data=40)
        return vj.ExclusiveKL(vj.FullRankGaussian(D, base_sampler=sampler), model, S,
                              use_path_deriv=True)
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    return vt.ExclusiveKL(vt.FullRankGaussian(D, base_sampler=sampler, **F64), model, S,
                          use_path_deriv=True)


def test_jax_checkpoint_resumes_in_the_port(fixed_clocks, tmp_path):
    """A JAX FASO run stopped at k = 800 (its R-hat gate stalled, one
    escalation done, verdicts in flight), saved by the JAX package's
    save_pytree, read by the port's load_pytree, converted by
    resume_state_from_jax and resumed in the port on the same draw
    stream, ends as JAX's uninterrupted run: the same decisions and
    escalations, opt_param to rtol 1e-8."""
    table = np.random.RandomState(0).randn(60000, D)

    def make(pkg):
        return pkg.FASO(pkg.RMSProp(0.05), W_min=50, k_check=50, rhat_threshold=1.01,
                        max_history=400, mc_escalation=4.0)

    smp_full = StreamNormal(table)
    full = make(vj).optimize(1600, _stl_objective(vj, smp_full), jnp.zeros(D + D * D))
    smp_part = StreamNormal(table)
    obj_part = _stl_objective(vj, smp_part)
    part = make(vj).optimize(800, obj_part, jnp.zeros(D + D * D))
    rs_j = part["resume_state"]
    assert len(rs_j["pending_checks"]) > 0 and int(rs_j["mc_samples"]) > 1
    path = str(tmp_path / "jax_faso.npz")
    jcheckpoint.save_pytree(path, rs_j)

    smp_t = TorchStreamNormal(table, pos=smp_part.pos)
    obj_t = _stl_objective(vt, smp_t)
    sgo = vt.RMSProp(0.05)
    loaded = load_pytree(path, like=rs_j)
    rs_t = resume_state_from_jax(loaded, obj_t.approx, sgo)
    assert "key" not in rs_t and isinstance(rs_t["k"], int)
    resumed = make(vt).optimize(1600, obj_t, obj_t.approx.init_param(),
                                generator=_gen(), resume_state=rs_t)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert resumed[name] == full[name], name
    np.testing.assert_array_equal(resumed["mc_escalation_history"],
                                  full["mc_escalation_history"])
    assert smp_t.pos == smp_full.pos
    assert obj_t.num_mc_samples == int(np.asarray(full["resume_state"]["mc_samples"]))
    np.testing.assert_allclose(resumed["opt_param"].numpy(), np.asarray(full["opt_param"]),
                               rtol=1e-8, atol=1e-12)


def _fixed_regression(self, *args, **kwargs):
    return ({"kappa": np.full(4, 0.6), "log_c": np.full(4, np.log(0.8)),
             "sigma": np.ones(4)}, 0.6, 0.8)


def test_raabbvi_init_rmsprop_matches_jax(fixed_clocks, monkeypatch):
    """bbvi's RAABBVI with init_rmsprop=True on the setup of
    tests/test_torch_faso.py::test_raabbvi_slice_matches_jax: the warm
    round (plain RMSProp under a default FASO) and the rounds after it
    make the same decisions on one draw stream, with the regression's
    (kappa, c) fixed on both sides, and opt_param agrees to rtol 1e-8."""
    for pkg in (vj, vt):
        monkeypatch.setattr(pkg.RAABBVI, "weighted_linear_regression", _fixed_regression)
    table = np.random.RandomState(1).randn(40000, D)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    kw = dict(n_iters=1300, learning_rate=0.1, RMS_kwargs=dict(diagnostics=False),
              RAABBVI_kwargs=dict(W_min=50, k_check=50, init_rmsprop=True))
    res_j = vj.bbvi(D, objective=_stl_objective(vj, smp_j, S=4), **kw)
    res_t = vt.bbvi(D, objective=_stl_objective(vt, smp_t, S=4), **kw)
    for name in ("k_conv", "k_Rhat", "k_mcse"):
        assert res_t[name] == res_j[name], name
    assert res_t["k_mcse"][1] is not None  # the warm round converged
    assert len(res_t["k_mcse"]) >= 3
    assert smp_t.pos == smp_j.pos
    np.testing.assert_array_equal(res_t["learning_rate_hist"], res_j["learning_rate_hist"])
    np.testing.assert_allclose(res_t["iterate_average_curr_hist"].numpy(),
                               np.asarray(res_j["iterate_average_curr_hist"]),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res_t["opt_param"].numpy(), np.asarray(res_j["opt_param"]),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("route", ["faso_max_time", "raabbvi_init_rmsprop"])
def test_bbvi_routes_that_raised_now_run(route, monkeypatch):
    """bbvi's FASO_kwargs=dict(max_time=...) and
    RAABBVI_kwargs=dict(init_rmsprop=True) run instead of raising."""
    model, dim = vt.zoo.funnel()
    if route == "faso_max_time":
        res = vt.bbvi(dim, log_density=model, n_iters=400, fixed_lr=True, device="cpu",
                      dtype=torch.float64, FASO_kwargs=dict(max_time=0.0))
        assert res["timed_out"] and res["resume_state"]["k"] == 0
    else:
        monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", _fixed_regression)
        res = vt.bbvi(dim, log_density=model, n_iters=600, device="cpu",
                      dtype=torch.float64, RAABBVI_kwargs=dict(init_rmsprop=True))
        assert res["value_history"].shape[0] > 0 and not res["timed_out"]
    assert torch.isfinite(res["opt_param"]).all()
