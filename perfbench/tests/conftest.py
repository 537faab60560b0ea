"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests.

The widths here are a test's, not a cell's: d = 12, 60 rows, 3,000 draws
at the front door. The manifest's cells run only on the card.
"""

import pytest

from perfbench.manifest import Cell, load_manifest


#: a step's change is compared by its norm, which at d = 12 averages the
#: float32 iterates' rounding over 156 elements, not a million: it reads
#: about 1e-5 here against 2e-7 at the cells' size
TINY_LIMITS = {"window_change_gap": 1e-4}


def tiny_cell(name, dtype="float32"):
    cell = Cell(load_manifest(), name)
    cell.config["model"].update(dim=12, n_data=60)
    for key, limit in TINY_LIMITS.items():
        if key in cell.limits:
            cell.limits[key] = max(cell.limits[key], limit)
    cell.config["dtype"] = dtype
    if cell.traffic["kind"] == "diagnostics":
        cell.traffic.update(n_samples=3000, fit_iters=400, checked_calls=2, checked_from=2)
    return cell


def window_s(name):
    """A window long enough for the front door's checked calls under a
    loaded test run."""
    return 2.0 if name.startswith("diag.") else 0.3


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return "cuda:0"
