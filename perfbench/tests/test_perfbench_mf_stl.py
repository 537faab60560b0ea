"""The reader of the mean-field STL kernels' roofline share (CPU): its
byte count against a hand count, its reading on a small synthetic trace,
and its silence where the kernels did not run on every step.

    python -m pytest perfbench/tests/test_perfbench_mf_stl.py -q
"""

from collections import Counter
from types import SimpleNamespace

import pytest

from perfbench.manifest import HERE, load_module
from perfbench.trace import Trace

MF_STL = load_module(HERE / "metrics" / "mf_stl_roofline.py")
D = 478_410


def ctx(trace, counts=Counter({10: 6, 400: 4})):
    return {"trace": trace, "config": {"dtype": "float32"},
            "system": SimpleNamespace(dim=D),
            "window": {"steps": sum(counts.values()), "steps_by_samples": counts}}


def trace(launches_a_step=3, steps=10):
    """The kernels as the profiler names them, 1 ms a launch, beside a
    kernel of another name ending in the same letters."""
    names = ["void (anonymous namespace)::mf_stl_draw<float, 2>(float const*)",
             "void (anonymous namespace)::mf_stl_rows<float>(double const*)",
             "void (anonymous namespace)::mf_stl_grad<float, 2>(float const*)"]
    device = [(i * 1e-3, (i + 1) * 1e-3, names[i % 3])
              for i in range(launches_a_step * steps)]
    device.append((1.0, 2.0, "void (anonymous namespace)::stl_solve<float>(float const*)"))
    return Trace(device, [(0.0, 2.0, "viabel.bbvi", 1)], 0.0, 2.0)


def test_bound_is_four_passes_over_the_draws():
    # S = 400: z read, x written, g_x and z read: 4 x 400 x 478,410 floats;
    # mu, log_sigma, log_sigma again, the 2 d gradient; log q and its gradient
    nbytes = (4 * 400 * D + 5 * D + 2 * 400) * 4
    assert nbytes == 3_071_395_400
    assert MF_STL.bound_s(400, D, "float32") == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert MF_STL.bound_s(400, D, "float32") * 1e3 == pytest.approx(0.91683, abs=1e-5)
    assert MF_STL.bound_s(10, 5, "float64") == pytest.approx((200 + 25 + 20) * 8 / 3.35e12)


def test_reads_the_kernels_over_every_steps_bound():
    got = MF_STL.read(ctx(trace()))
    bound = 6 * MF_STL.bound_s(10, D, "float32") + 4 * MF_STL.bound_s(400, D, "float32")
    assert got == pytest.approx(100.0 * bound / 30e-3)


def test_silent_without_a_launch_on_every_step():
    assert MF_STL.read(ctx(None)) is None
    assert MF_STL.read(ctx(Trace([], [(0.0, 1.0, "aten::mul", 1)], 0.0, 1.0))) is None
    assert MF_STL.read(ctx(_ragged())) is None
    empty = ctx(trace())
    empty["window"]["steps"] = 0
    assert MF_STL.read(empty) is None


def _ragged():
    """31 launches over 10 steps: a window whose kernels are not its steps'."""
    tr = trace()
    tr.device.append((1.5, 1.6, "void (anonymous namespace)::mf_stl_rows<float>(double const*)"))
    return tr
