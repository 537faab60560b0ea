"""The readers of the program's spans (``perfbench/program_spans.py`` and
the ``viabel.`` metrics) against hand counts on small synthetic traces.

    python -m pytest perfbench/tests -q
"""

import pytest

from perfbench.manifest import HERE, load_module
from perfbench.trace import Trace

MAIN, OTHER = 1, 2
FIT_READERS = ("fit.step_host_us", "fit.idle_outside_step_share", "fit.rhat_check_ms",
               "fit.host_syncs_per_kstep")
DIAG_READERS = ("diag.host_syncs_per_call", "diag.cov_norm_ms")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def ctx(trace, traffic=None, **window):
    return {"trace": trace, "traffic": traffic or {}, "window": window}


def fit_trace():
    """A 10-s window: the card busy over [1, 2] and [5, 6]; steps of the
    main thread over [0.5, 1.5], [4, 7] and [9.5, 10.5] (past the
    window's end), and one on another thread that opened fewer spans."""
    device = [(1.0, 2.0, "stl_solve"), (5.0, 5.5, "gemm"), (5.4, 6.0, "Memcpy DtoD")]
    host = [
        (0.2, 10.0, "viabel.bbvi", MAIN),
        (0.5, 1.5, "viabel.step", MAIN),
        (4.0, 7.0, "viabel.step", MAIN),
        (9.5, 10.5, "viabel.step", MAIN),
        (8.0, 9.0, "viabel.step", OTHER),
        (2.0, 2.001, "viabel.faso.rhat_dispatch", MAIN),
        (3.0, 3.003, "viabel.faso.rhat_readback", MAIN),
        (7.5, 7.501, "viabel.faso.rhat_dispatch", MAIN),
        (8.5, 8.503, "viabel.faso.rhat_readback", MAIN),
        (3.5, 3.51, "viabel.faso.mcse_check", MAIN),
        (7.2, 7.23, "viabel.faso.mcse_check", MAIN),
        # syncs: three inside viabel. spans, one before the fit's span
        # opened (the harness's), and a non-blocking copy
        (3.001, 3.002, "cudaEventSynchronize", OTHER),
        (3.505, 3.506, "cudaStreamSynchronize", OTHER),
        (6.0, 6.1, "cudaMemcpy", MAIN),
        (0.05, 0.1, "cudaDeviceSynchronize", MAIN),
        (5.0, 5.1, "cudaMemcpyAsync", MAIN),
        (4.5, 4.6, "aten::mm", MAIN),
    ]
    return Trace(device, host, 0.0, 10.0)


def test_step_host_us_is_the_mean_step_cut_to_the_window():
    # main thread only: 1 s, 3 s and 0.5 s of the last (cut at 10 s)
    assert reader("fit.step_host_us")(ctx(fit_trace())) == pytest.approx(1e6 * 4.5 / 3)


def test_idle_outside_steps_counts_a_step_over_the_window_edge_to_the_edge():
    # idle: [0, 1], [2, 5], [6, 10] = 8 s; inside steps: [0.5, 1], [4, 5],
    # [6, 7], [9.5, 10] = 3 s; outside 5 s of 10
    assert reader("fit.idle_outside_step_share")(ctx(fit_trace())) == pytest.approx(50.0)


def test_rhat_check_time_is_per_dispatch():
    assert reader("fit.rhat_check_ms")(ctx(fit_trace())) == pytest.approx((2 * 1 + 2 * 3) / 2)


def test_host_syncs_count_only_blocking_calls_inside_viabel_spans():
    # the event and stream syncs and the blocking copy; not the harness's
    # device sync before the fit, nor the asynchronous copy
    assert reader("fit.host_syncs_per_kstep")(ctx(fit_trace(), steps=1500)) == \
        pytest.approx(3 / 1.5)


def diag_trace(with_norm=True):
    """Two front-door calls; in each, the benchmark's wrapper diag.psis
    inside the program's viabel.diag.psis holds a program sync (under an
    operation that started inside the wrapper) and its own device sync
    (under nothing but the profiler's own buffer request)."""
    host = []
    for c in (0.0, 1.0):
        host += [
            (c, c + 0.9, "viabel.vi_diagnostics", MAIN),
            (c + 0.2, c + 0.5, "viabel.diag.psis", MAIN),
            (c + 0.21, c + 0.49, "diag.psis", MAIN),
            (c + 0.25, c + 0.26, "aten::item", MAIN),
            (c + 0.252, c + 0.258, "cudaStreamSynchronize", MAIN),
            (c + 0.47, c + 0.48, "cudaDeviceSynchronize", MAIN),
            (c + 0.46, c + 0.485, "Activity Buffer Request", MAIN),
            (c + 0.8, c + 0.81, "cudaStreamSynchronize", MAIN),
        ]
        if with_norm:
            host += [(c + 0.6, c + 0.6 + 0.04 + 0.01 * c, "viabel.diag.cov_norm", MAIN)]
    # the harness's sync after the last call, outside every viabel. span
    host.append((1.95, 1.96, "cudaDeviceSynchronize", MAIN))
    return Trace([(0.3, 0.4, "svd")], host, 0.0, 2.0)


DIAG_TRAFFIC = {"spans": {"viabel_torch.convenience": {"psislw": "diag.psis"}}}


def test_diag_syncs_leave_out_the_wrappers_own():
    # per call: the stream sync under aten::item and the one after PSIS
    read = reader("diag.host_syncs_per_call")
    assert read(ctx(diag_trace(), DIAG_TRAFFIC, calls=[{}, {}])) == pytest.approx(2.0)
    # without the traffic's wrappers the wrapper's own sync counts too
    assert read(ctx(diag_trace(), None, calls=[{}, {}])) == pytest.approx(3.0)


def test_cov_norm_ms_is_per_call():
    assert reader("diag.cov_norm_ms")(ctx(diag_trace(), DIAG_TRAFFIC, calls=[{}, {}])) == \
        pytest.approx((40 + 50) / 2)


@pytest.mark.parametrize("name", FIT_READERS + DIAG_READERS)
def test_none_without_the_programs_spans(name):
    window = {"steps": 1500, "calls": [{}, {}]}
    read = reader(name)
    assert read(ctx(None, **window)) is None
    bare = Trace([(1.0, 2.0, "k")], [(0.5, 1.5, "aten::mm", MAIN),
                                     (1.6, 1.7, "cudaStreamSynchronize", MAIN)], 0.0, 3.0)
    assert read(ctx(bare, **window)) is None


@pytest.mark.parametrize("name,trace", [
    ("fit.rhat_check_ms", Trace([], [(0.0, 1.0, "viabel.step", MAIN)], 0.0, 1.0)),
    ("diag.cov_norm_ms", diag_trace(with_norm=False)),
])
def test_none_where_the_metrics_own_span_is_absent(name, trace):
    assert reader(name)(ctx(trace, DIAG_TRAFFIC, steps=10, calls=[{}, {}])) is None
