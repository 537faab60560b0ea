"""The reference agrees with the port at a tiny size on the CPU, in
float64 (where only the order of sums differs), stage by stage: the
first steps, the window's last steps and
its R-hat statistic, PSIS and the front door's bounds."""

import numpy as np
import pytest
import torch

from perfbench.harness import run_cell
from perfbench.reference import diagnostics as ref_diag

from .conftest import tiny_cell

F64_GAP = 1e-9


def test_fit_checks_agree_in_float64():
    _, rows = run_cell(tiny_cell("fit.logreg1000_fullrank.stl", "float64"), 2**31 + 7, 0.3, False,
                       device="cpu")
    numbers = {r["name"]: r["value"] for r in rows}
    assert set(numbers) == {"loss_gap", "first_grad_gap", "change_gap", "window_loss_gap",
                            "window_change_gap", "window_nu_gap", "window_rhat_gap"}
    for key, value in numbers.items():
        assert value <= F64_GAP, (key, value)


def test_front_door_checks_agree_in_float64():
    result, rows = run_cell(tiny_cell("diag.logreg1000_fullrank", "float64"), 11, 2.0, False,
                            device="cpu")
    numbers = {r["name"]: r["value"] for r in rows}
    assert numbers["branch_mismatch"] == 0
    for key in ("loss_gap", "first_grad_gap", "change_gap", "log_weights_gap", "khat_gap", "d2_gap",
                "bounds_gap"):
        assert numbers[key] <= F64_GAP, (key, numbers[key])
    assert result["attempted"] >= 2


@pytest.mark.parametrize("scale", [0.5, 1.5, 3.0])
def test_psis_matches_the_port(scale):
    from viabel_torch.psis import psislw
    rng = np.random.default_rng(5)
    lw = rng.standard_normal(20_000) * scale
    smoothed, khat = ref_diag.psis(lw)
    port_smoothed, port_khat = psislw(torch.as_tensor(lw))
    assert khat == pytest.approx(float(port_khat), rel=1e-10, abs=1e-12)
    np.testing.assert_allclose(smoothed, port_smoothed.numpy(), rtol=1e-10, atol=1e-12)
