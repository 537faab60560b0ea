"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (it calls the run on the
CPU at a tiny size), plants one fault under set-up and the window, and
reads ``correct`` against the cell's own limits: once for each fault
that the cell can have. The sound run beside them comes out correct.
"""

import pytest

from perfbench.faults import FAULTS
from perfbench.harness import run_cell

from .conftest import tiny_cell, window_s

CELLS = ["fit.logreg1000_fullrank.stl", "diag.logreg1000_fullrank"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _ = run_cell(tiny_cell(name), 2**31 + 99, window_s(name), False, device="cpu")
    assert result["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    result, rows = run_cell(tiny_cell(name), 2**31 + 99, window_s(name), False, device="cpu",
                            planted=FAULTS[fault]())
    assert result["correct"] is False, rows
