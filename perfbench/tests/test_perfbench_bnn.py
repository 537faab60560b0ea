"""The Bayesian neural network cell's yardstick and readers (CPU):
``bnn_roofline``'s counts against hand counts, the readers it adds on a
small synthetic trace, and the cell's check at a tiny size, sound and
with each planted fault.

    python -m pytest perfbench/tests/test_perfbench_bnn.py -q
"""

from collections import Counter
from types import SimpleNamespace

import pytest

from perfbench import bnn_roofline, roofline
from perfbench.faults import FAULTS
from perfbench.harness import run_cell
from perfbench.manifest import HERE, Cell, load_manifest, load_module
from perfbench.trace import Trace

BNN = "fit.bnn2x400_mf.stl"
HIDDEN = [400, 400]


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def test_small_network_counted_by_hand():
    # 5 -> 4 -> 3 -> 2 over n = 6 rows at S = 7 draws
    S, n = 7, 6
    forward = 2 * S * n * (5 * 4 + 4 * 3 + 3 * 2)
    weight_grads = forward
    input_grads = 2 * S * n * (4 * 3 + 3 * 2)  # not the first layer's
    assert bnn_roofline.matmul_flops(S, n, 5, [4, 3], 2) == forward + weight_grads + input_grads
    assert bnn_roofline.var_param_dim(5, [4, 3], 2) == 2 * (5 * 4 + 4 + 4 * 3 + 3 + 3 * 2 + 2)
    assert bnn_roofline.step_flops(S, n, 5, [4, 3], 2) == (
        forward + weight_grads + input_grads + 6 * 2 * 47)
    # elements: the shared data once; each draw's weights, activations and
    # gradients once a draw
    layer1 = [n * 5 + S * 5 * 4 + S * n * 4] * 2
    layer2 = [S * n * 4 + S * 4 * 3 + S * n * 3] * 3
    layer3 = [S * n * 3 + S * 3 * 2 + S * n * 2] * 3
    assert sorted(e for _, e in bnn_roofline.matmuls(S, n, 5, [4, 3], 2)) == sorted(
        layer1 + layer2 + layer3)


def test_the_cells_network_at_its_widths():
    assert bnn_roofline.var_param_dim(784, HIDDEN, 10) == 2 * 478_410
    per_S = 2 * 512 * (2 * 477_600 + 164_000)
    assert per_S == 1_146_060_800
    for S in (1, 10, 400):
        assert bnn_roofline.matmul_flops(S, 512, 784, HIDDEN, 10) == S * per_S
    # at S = 400 every product but layer 3's is bound by its operations
    big = bnn_roofline.matmul_bound_s(400, 512, 784, HIDDEN, 10, "float32")
    assert 400 * per_S / 67e12 < big < 1.05 * 400 * per_S / 67e12


def ctx(trace, steps_by_samples=None, seconds=10.0):
    counts = Counter(steps_by_samples or {10: 600, 400: 400})
    cfg = {"model": {"zoo": "bnn_classifier", "n_data": 512, "in_dim": 784, "hidden": HIDDEN,
                     "classes": 10}, "dtype": "float32", "family": {"class": "MFGaussian"}}
    return {"trace": trace, "traffic": {}, "config": cfg, "system": SimpleNamespace(),
            "window": {"steps": sum(counts.values()), "seconds": seconds,
                       "steps_by_samples": counts}}


def trace():
    """A 10-s window: GEMMs for 4 s in all, an elementwise kernel for 1 s
    and a copy for 1 s."""
    device = [(0.0, 3.0, "void cutlass::Kernel<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>"),
              (3.0, 3.9, "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8"),
              (3.9, 4.0, "splitKreduce_kernel"),
              (5.0, 6.0, "void at::native::vectorized_elementwise_kernel<4, exp>"),
              (7.0, 8.0, "Memcpy DtoD (Device -> Device)")]
    return Trace(device, [(0.0, 10.0, "viabel.bbvi", 1)], 0.0, 10.0)


def test_matmul_roofline_reads_the_gemm_kernels():
    got = reader("bnn.matmul_roofline")(ctx(trace()))
    bound = sum(n * bnn_roofline.matmul_bound_s(S, 512, 784, HIDDEN, 10, "float32")
                for S, n in {10: 600, 400: 400}.items())
    assert got == pytest.approx(100.0 * bound / 4.0)
    assert 0 < got < 100


def test_gemm_busy_share_is_the_gemms_share_of_busy_time():
    assert reader("bnn.gemm_busy_share")(ctx(trace())) == pytest.approx(100.0 * 4.0 / 6.0)


def test_step_mfu_counts_every_step_at_its_sample_count():
    got = reader("step_mfu.bnn")(ctx(trace(), seconds=4.0))
    flops = sum(n * bnn_roofline.step_flops(S, 512, 784, HIDDEN, 10)
                for S, n in {10: 600, 400: 400}.items())
    assert got == pytest.approx(100.0 * flops / 4.0 / 67e12)
    assert roofline.PEAK_FLOP_PER_S["float32"] == 67e12


@pytest.mark.parametrize("name", ["bnn.matmul_roofline", "bnn.gemm_busy_share", "step_mfu.bnn"])
def test_readers_are_silent_without_what_they_read(name):
    assert reader(name)(ctx(None)) is None
    empty = ctx(Trace([], [(0.0, 1.0, "aten::mm", 1)], 0.0, 1.0))
    if name != "step_mfu.bnn":  # a count of the window's steps, read whenever traced
        assert reader(name)(empty) is None
    empty["window"]["steps"] = 0
    if name != "bnn.gemm_busy_share":
        assert reader(name)(empty) is None


def tiny_bnn():
    cell = Cell(load_manifest(), BNN)
    cell.config["model"].update(n_data=16, in_dim=12, hidden=[8, 8], classes=3)
    return cell


def test_tiny_bnn_run_is_correct():
    result, rows = run_cell(tiny_bnn(), 2**31 + 99, 0.5, False, device="cpu")
    assert result["correct"] is True, rows
    assert result["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tiny_bnn_run_with_a_fault_is_not_correct(fault):
    result, rows = run_cell(tiny_bnn(), 2**31 + 99, 0.5, False, device="cpu",
                            planted=FAULTS[fault]())
    assert result["correct"] is False, rows
