"""The control comes out not correct (on the card).

The control is the reference put in the program's place one precision
below the configuration's: float32 with TF32 matrix products, which only
the card has. At each cell's own size, on one seed, the program's
numbers pass the cell's limits and the control's fail one of them.

    python -m pytest perfbench/tests/test_perfbench_control.py -q -m cuda
"""

import pytest

from perfbench.compare import judge
from perfbench.control import readings
from perfbench.manifest import Cell, load_manifest


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in load_manifest()["workloads"]])
def test_control_fails_and_program_passes(name, cuda_device):
    cell = Cell(load_manifest(), name)
    # the front door checks calls drawn from its first 40, a fit the window's last
    # steps: a window that reaches them
    seconds = 5.0 if cell.traffic["kind"] == "diagnostics" else 3.0
    sides = readings(cell, 2**31 + 515, seconds, cuda_device, with_control=True)
    assert judge(sides["program"], cell.limits)[0] is True
    assert judge(sides["control"], cell.limits)[0] is False
