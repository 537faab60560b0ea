"""The flow cell's yardstick and readers (CPU): ``flow_roofline``'s counts
against hand counts at the cell's widths, the four readers it adds on a
small synthetic trace, and the cell's check at a tiny size, sound and
with each planted fault.

    python -m pytest perfbench/tests/test_perfbench_flow.py -q
"""

from collections import Counter
from types import SimpleNamespace

import pytest

from perfbench import flow_roofline, roofline
from perfbench.faults import FAULTS
from perfbench.harness import run_cell
from perfbench.manifest import HERE, load_module
from perfbench.trace import Trace

from .conftest import tiny_cell

FLOW = "fit.logreg1000_realnvp.stl"
HIDDEN = [512, 512]
#: one net's (1000, 512), (512, 512), (512, 1000) products: m n summed
NET_MN = 1000 * 512 + 512 * 512 + 512 * 1000


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def config():
    return {"model": {"dim": 1000, "n_data": 512}, "dtype": "float32",
            "family": {"class": "RealNVP", "n_couplings": 4, "hidden": HIDDEN}}


def test_the_flow_has_the_cells_parameter_count():
    assert NET_MN + 512 + 512 + 1000 == 1_288_168
    assert flow_roofline.var_param_dim(1000, 4, HIDDEN) == 8 * 1_288_168 == 10_305_344


def test_matrix_product_operations_at_the_cells_widths():
    # four passes of 2 S m n over the eight nets' layers (g forward, its weight
    # and input gradients, f's input gradients); g's first coupling's two
    # first layers take no input gradient, and f's forward is g's again
    per_S = 8 * 4 * 2 * NET_MN - 2 * 2 * 1000 * 512
    assert per_S == 80_265_216
    for S in (1, 10, 400):
        assert flow_roofline.matmul_flops(S, 1000, 4, HIDDEN) == S * per_S
    step = flow_roofline.step_flops(10, 1000, 512, 4, HIDDEN)
    assert step == (10 * per_S + roofline.logistic_regression_flops(10, 1000, 512)
                    + 6 * 10_305_344)


def test_matrix_product_bound_takes_bytes_or_operations():
    # at S = 10 each product is bound by its bytes; at S = 4,000 by its operations
    small = flow_roofline.matmul_bound_s(10, 1000, 4, HIDDEN, "float32")
    nbytes = sum((r * k + k * c + r * c) * 4 for r, k, c in
                 flow_roofline.matmuls(10, 1000, 4, HIDDEN))
    assert small == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    large = flow_roofline.matmul_bound_s(4000, 1000, 4, HIDDEN, "float32")
    assert large == pytest.approx(flow_roofline.matmul_flops(4000, 1000, 4, HIDDEN) / 67e12,
                                  rel=1e-12)
    model = flow_roofline.model_matmul_bound_s(400, 1000, 512, "float32")
    assert model == pytest.approx(2 * max(
        (400 * 1000 + 1000 * 512 + 400 * 512) * 4 / 3.35e12, 2 * 400 * 1000 * 512 / 67e12))


def ctx(trace, cfg=None, steps_by_samples=None, seconds=10.0, var_param_dim=10_305_344):
    counts = Counter(steps_by_samples or {10: 600, 400: 400})
    system = SimpleNamespace(approx=SimpleNamespace(var_param_dim=var_param_dim),
                             bbvi_kw={"n_iters": 10000, "RAABBVI_kwargs": {"max_history": 600}})
    return {"trace": trace, "traffic": {}, "config": cfg or config(), "system": system,
            "window": {"steps": sum(counts.values()), "seconds": seconds,
                       "steps_by_samples": counts}}


def trace():
    """A 10-s window: GEMMs for 2 s in all, two ring-statistics launches of
    10 ms, an elementwise kernel; two captures of the main thread's step."""
    device = [(0.0, 1.5, "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8"),
              (1.5, 1.9, "cutlass_80_simt_sgemm_128x64_8x5_nn_align1"),
              (1.9, 2.0, "splitKreduce_kernel"),
              (3.0, 3.01, "void group_stats_vec<float>(float const*, ...)"),
              (4.0, 4.01, "void group_stats_vec<float>(float const*, ...)"),
              (5.0, 5.5, "void at::native::vectorized_elementwise_kernel<4, tanh>")]
    host = [(0.0, 10.0, "viabel.bbvi", 1),
            (0.2, 0.5, "viabel.step.capture", 1),
            (6.0, 6.25, "viabel.step.capture", 1),
            (0.25, 0.3, "viabel.step", 1)]
    return Trace(device, host, 0.0, 10.0)


def test_matmul_roofline_reads_the_gemm_kernels():
    got = reader("flow.matmul_roofline")(ctx(trace()))
    bound = sum(n * (flow_roofline.matmul_bound_s(S, 1000, 4, HIDDEN, "float32")
                     + flow_roofline.model_matmul_bound_s(S, 1000, 512, "float32"))
                for S, n in {10: 600, 400: 400}.items())
    assert got == pytest.approx(100.0 * bound / 2.0)
    assert 0 < got < 100


def test_ring_roofline_reads_the_familys_own_width():
    got = reader("flow.ring_group_stats_roofline")(ctx(trace()))
    bound = roofline.ring_group_stats_bound_s(600, 10_305_344, 50, "float32")
    assert got == pytest.approx(100.0 * bound / 0.01)
    assert bound * 1e3 == pytest.approx(7.69, abs=0.01)  # a 26 GB read


def test_step_mfu_counts_every_step_at_its_sample_count():
    got = reader("step_mfu.flow")(ctx(trace(), seconds=4.0))
    flops = sum(n * flow_roofline.step_flops(S, 1000, 512, 4, HIDDEN)
                for S, n in {10: 600, 400: 400}.items())
    assert got == pytest.approx(100.0 * flops / 4.0 / 67e12)


def test_capture_share_is_the_windows_share_in_captures():
    assert reader("fit.capture_share")(ctx(trace())) == pytest.approx(100.0 * 0.55 / 10.0)


@pytest.mark.parametrize("name", ["flow.matmul_roofline", "flow.ring_group_stats_roofline",
                                  "step_mfu.flow", "fit.capture_share"])
def test_readers_are_silent_without_what_they_read(name):
    assert reader(name)(ctx(None)) is None
    empty = ctx(Trace([], [(0.0, 1.0, "aten::mm", 1)], 0.0, 1.0))
    if name != "step_mfu.flow":  # a count of the window's steps, read whenever traced
        assert reader(name)(empty) is None
    empty["window"]["steps"] = 0
    assert reader(name)(empty) is None


def test_matrix_products_leave_out_fs_forward_pass():
    # each of the 24 layers: g's forward, its weight gradient, f's input
    # gradient, and g's input gradient but at the first coupling's two first
    # layers; f's forward repeats g's and is not counted
    assert len(flow_roofline.matmuls(10, 1000, 4, HIDDEN)) == 24 * 3 + 24 - 2


def tiny_flow():
    cell = tiny_cell(FLOW)
    cell.config["family"]["hidden"] = [16, 16]
    return cell


def test_tiny_flow_run_is_correct():
    result, rows = run_cell(tiny_flow(), 2**31 + 99, 0.5, False, device="cpu")
    assert result["correct"] is True, rows
    assert result["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tiny_flow_run_with_a_fault_is_not_correct(fault):
    result, rows = run_cell(tiny_flow(), 2**31 + 99, 0.5, False, device="cpu",
                            planted=FAULTS[fault]())
    assert result["correct"] is False, rows
