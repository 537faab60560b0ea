"""The port's spans (viabel_torch.tracing): off, a shared null context that
reads no clock; on, one profiler span per layer boundary, nested as the
calls nest, with the results unchanged to the bit.

The MCSE recheck schedule reads the wall clock, and the profiler slows the
host, so the fits here run on stubbed clocks (as tests/test_torch_faso.py
does) for their decisions to be the same with and without the profiler.
"""

import contextlib
import io
import time
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
from viabel_torch import tracing  # noqa: E402

D = 2
K_CHECK = 20


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


@pytest.fixture(scope="module")
def stubbed_clocks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfaso, "Timer", FixedTimer)
        mp.setattr(tfaso, "_now", FakeClock.now)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


def _profiled(fn):
    """``fn()``'s result and its ``viabel.`` spans ``{name: [(start_ns,
    end_ns, thread)]}`` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("viabel."):
            spans[ev.name()].append((ev.start_ns(), ev.end_ns(), ev.start_thread_id()))
    return out, {k: sorted(v) for k, v in spans.items()}


def _inside(inner, outer):
    """Whether every interval of ``inner`` lies in one of ``outer`` on its
    thread."""
    return all(any(o[2] == i[2] and o[0] <= i[0] and i[1] <= o[1] for o in outer)
               for i in inner)


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def _faso_fit():
    """A float64 STL fit on the FASO route whose R-hat gate stalls, so the
    sample count escalates twice, then passes, so an MCSE check stops it."""
    model, _ = vt.zoo.logistic_regression(dim=D, n_data=20, device="cpu",
                                          dtype=torch.float64)
    approx = vt.FullRankGaussian(D, device="cpu", dtype=torch.float64)
    objective = vt.ExclusiveKL(approx, model, 1, use_path_deriv=True)
    return _quiet(lambda: vt.bbvi(
        D, objective=objective, n_iters=600, fixed_lr=True, learning_rate=0.05,
        generator=torch.Generator().manual_seed(0), RMS_kwargs=dict(diagnostics=False),
        FASO_kwargs=dict(W_min=K_CHECK, k_check=K_CHECK, rhat_threshold=1.02,
                         mc_patience=2)))


@pytest.fixture(scope="module")
def faso_runs(stubbed_clocks):
    plain = _faso_fit()
    traced, spans = _profiled(_faso_fit)
    return plain, traced, spans


def test_span_off_is_one_shared_null_context(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    off = tracing.span("viabel.step")
    assert off is tracing.span("viabel.bbvi")
    assert isinstance(off, contextlib.nullcontext)

    def no_clock(*args):
        raise AssertionError("a span read a clock or synchronised")

    for name in ("perf_counter", "perf_counter_ns", "monotonic", "time"):
        monkeypatch.setattr(time, name, no_clock)
    monkeypatch.setattr(torch.cuda, "synchronize", no_clock)
    with tracing.span("viabel.step"):
        pass
    monkeypatch.undo()
    _, spans = _profiled(lambda: None)
    assert spans == {}


def test_faso_fit_records_one_step_span_per_step_inside_segments(faso_runs):
    _, res, spans = faso_runs
    n_steps = int(res["value_history"].shape[0])
    assert len(spans["viabel.step"]) == n_steps
    assert len(spans["viabel.faso.segment"]) == -(-n_steps // K_CHECK)
    assert _inside(spans["viabel.step"], spans["viabel.faso.segment"])
    for phase in ("viabel.step.loss", "viabel.step.grad", "viabel.step.rule"):
        assert len(spans[phase]) == n_steps, phase
        assert _inside(spans[phase], spans["viabel.step"]), phase
    assert len(spans["viabel.bbvi"]) == 1
    for name, found in spans.items():
        assert _inside(found, spans["viabel.bbvi"]), name


def test_faso_fit_records_each_check_and_escalation(faso_runs):
    _, res, spans = faso_runs
    assert len(spans["viabel.faso.rhat_readback"]) == len(res["rhat_verdicts"]) > 0
    assert len(spans["viabel.faso.rhat_dispatch"]) >= len(res["rhat_verdicts"])
    assert len(spans["viabel.faso.escalate"]) == len(res["mc_escalation_history"]) == 2
    assert res["k_stopped"] is not None
    assert len(spans["viabel.faso.mcse_check"]) >= 1
    assert _inside(spans["viabel.faso.escalate"], spans["viabel.faso.rhat_readback"])


def test_faso_fit_is_bit_identical_under_the_profiler(faso_runs):
    plain, traced, _ = faso_runs
    assert torch.equal(plain["value_history"], traced["value_history"])
    assert torch.equal(plain["opt_param"], traced["opt_param"])
    assert plain["rhat_verdicts"] == traced["rhat_verdicts"]
    np.testing.assert_array_equal(plain["mc_escalation_history"],
                                  traced["mc_escalation_history"])
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert plain[name] == traced[name], name


def test_raabbvi_records_its_rounds_and_regressions(stubbed_clocks, monkeypatch):
    """Three rounds, the regression after the second (a stand-in for the
    sampler: the span holds the launch and its read, whatever it draws)."""
    monkeypatch.setattr(tfaso, "wlr_hmc", lambda init, generator, data:
                        init[:, None, :].repeat(1, 10, 1))
    model, _ = vt.zoo.logistic_regression(dim=3, n_data=40, device="cpu",
                                          dtype=torch.float64)
    approx = vt.FullRankGaussian(3, device="cpu", dtype=torch.float64)
    objective = vt.ExclusiveKL(approx, model, 4, use_path_deriv=True)
    res, spans = _profiled(lambda: _quiet(lambda: vt.bbvi(
        3, objective=objective, n_iters=800, learning_rate=0.1,
        generator=torch.Generator().manual_seed(3), RMS_kwargs=dict(diagnostics=False),
        RAABBVI_kwargs=dict(W_min=50, k_check=50, mcse_threshold=0.5))))
    rounds = len(res["k_mcse"]) - 1  # its first entry is the start
    assert rounds == len(spans["viabel.raabbvi.round"]) == 3
    assert len(spans["viabel.raabbvi.regression"]) == len(res["kappa_hist"]) == 1
    assert _inside(spans["viabel.faso.segment"], spans["viabel.raabbvi.round"])
    assert _inside(spans["viabel.raabbvi.regression"], spans["viabel.bbvi"])


def _diagnostics_call(branch):
    """One front-door call: q = p (the bounds branch), or a target three
    times wider than q (heavy weights: the KSD branch)."""
    scale = 1.0 if branch == "bounds" else 3.0
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(D), scale * np.ones(D), device="cpu",
                                        dtype=torch.float64)
    approx = vt.FullRankGaussian(D, device="cpu", dtype=torch.float64)
    return _quiet(lambda: vt.vi_diagnostics(
        approx.init_param(), model=model, approx=approx, n_samples=2000,
        generator=torch.Generator().manual_seed(7), ksd_samples=64, ksd_null=4))


@pytest.mark.parametrize("branch,phases", [
    ("bounds", ("log_weights", "psis", "moments", "bounds", "cov_norm", "cov_norm.eigh")),
    ("ksd", ("log_weights", "psis", "ksd")),
])
def test_vi_diagnostics_records_its_phases_once(branch, phases):
    plain = _diagnostics_call(branch)
    traced, spans = _profiled(lambda: _diagnostics_call(branch))
    assert ("d2" in traced) == (branch == "bounds")
    names = {"viabel.vi_diagnostics"} | {f"viabel.diag.{p}" for p in phases}
    assert set(spans) == names
    assert all(len(found) == 1 for found in spans.values())
    for name in names:
        assert _inside(spans[name], spans["viabel.vi_diagnostics"]), name
    assert set(plain) == set(traced)
    for key, value in plain.items():
        if torch.is_tensor(value):
            assert torch.equal(value, traced[key]), key
        else:
            assert value == traced[key], key
    if branch == "bounds":
        assert _inside(spans["viabel.diag.cov_norm.eigh"], spans["viabel.diag.cov_norm"])


@pytest.mark.parametrize("p_var,eigh", [
    ([[2.0, 0.5], [0.5, 1.0]], True),
    ([[2.0, 1.0], [0.0, 1.0]], False),
])
def test_cov_norm_opens_the_eigensolve_for_a_symmetric_matrix_only(p_var, eigh):
    """A user's p_var: symmetric, the eigensolve inside the norm's span;
    not symmetric, the norm's span alone (the SVD)."""
    log_weights = torch.as_tensor(np.random.RandomState(0).randn(500) * 0.1)

    def bounds():
        return vt.diagnostics.all_diagnostics(
            log_weights, moment_bound_fn=lambda p: 1.0 + p,
            p_var=torch.tensor(p_var, dtype=torch.float64))

    plain = bounds()
    traced, spans = _profiled(bounds)
    names = {"viabel.diag.bounds", "viabel.diag.cov_norm"}
    assert set(spans) == (names | {"viabel.diag.cov_norm.eigh"} if eigh else names)
    assert all(len(found) == 1 for found in spans.values())
    assert _inside(spans.get("viabel.diag.cov_norm.eigh", []), spans["viabel.diag.cov_norm"])
    assert float(plain["cov_error"]) == float(traced["cov_error"])
