"""The yardstick's counts against hand counts at the cells' shapes."""

import pytest

from perfbench import roofline
from perfbench.readers import ring_rows


def test_ring_bound_reads_the_flagship_ring_once():
    # (600, 1,001,000) float32 read once, 2 x (12, 1,001,000) sums written:
    # (600 + 24) * 1,001,000 + 1,001,000 values of 4 bytes = 2.5025e9 bytes
    nbytes = (600 * 1_001_000 + 1_001_000 + 2 * 12 * 1_001_000) * 4
    assert nbytes == 2_502_500_000
    assert roofline.ring_group_stats_bound_s(600, 1_001_000, 50, "float32") == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)
    assert roofline.ring_group_stats_bound_s(600, 1_001_000, 50, "float32") * 1e3 == \
        pytest.approx(0.7470, abs=1e-4)


def test_triangular_solve_bounds():
    # kernel 2 at (1000, 10): 500,500 + 20,000 values, bytes-bound
    assert roofline.tri_solve_bound_s(1000, 10, "float32") == pytest.approx(
        (500_500 + 20_000) * 4 / 3.35e12, rel=1e-12)
    assert roofline.tri_solve_bound_s(1000, 10, "float32") * 1e3 == pytest.approx(
        0.000621, abs=1e-6)
    # kernel 3 at (1000, 100,000): 1e11 operations over 67 TFLOP/s
    assert roofline.tri_solve_bound_s(1000, 100_000, "float32") == pytest.approx(1e11 / 67e12)
    assert roofline.tri_solve_bound_s(1000, 100_000, "float32") * 1e3 == pytest.approx(
        1.4925, abs=1e-4)


def test_step_operation_counts():
    # full rank, d = 1000, n = 512, S = 10: draws and their L-gradient
    # 4 * 10 * 1e6, STL solve 1e7, model 4 * 10 * 1000 * 512 + 10 * 10 * 512
    # + 4 * 10 * 1000, RMSProp 6 * 1,001,000
    hand = 40_000_000 + 10_000_000 + 20_480_000 + 51_200 + 40_000 + 6_006_000
    assert roofline.step_flops("FullRankGaussian", 10, 1000, 512, stl=True) == hand
    assert roofline.step_flops("FullRankGaussian", 10, 1000, 512, stl=False) == hand - 10_000_000
    with pytest.raises(ValueError):
        roofline.step_flops("NeuralNet", 10, 500, 1000, stl=False)


@pytest.mark.parametrize("bbvi,rows", [
    ({"n_iters": 10000, "RAABBVI_kwargs": {"max_history": 600}}, 600),
    ({"n_iters": 10000, "RAABBVI_kwargs": {}}, 10000),
    ({"n_iters": 130, "RAABBVI_kwargs": {}}, 400),
    ({"n_iters": 10000, "RAABBVI_kwargs": {"max_history": 610}}, 650),
])
def test_ring_rows_follow_faso_sizing(bbvi, rows):
    class System:
        bbvi_kw = bbvi
    assert ring_rows({"system": System()}) == (rows, 50)
