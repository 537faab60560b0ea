"""The reader of ``fit.graph_step_share`` against hand counts on small
synthetic traces.

    python -m pytest perfbench/tests -q
"""

import pytest

from perfbench.manifest import HERE, load_module
from perfbench.trace import Trace

MAIN, OTHER = 1, 2


def read(trace):
    ctx = {"trace": trace, "traffic": {}, "window": {"steps": 4}}
    return load_module(HERE / "metrics" / "fit.graph_step_share.py").read(ctx)


def step_trace(replayed_in=(1, 2), extra=()):
    """A 10-s window with four steps of the main thread over [1, 2],
    [3, 4], [5, 6] and [9.5, 10.5] (cut at the window's end); a replay
    inside each step named by ``replayed_in``."""
    steps = [(1.0, 2.0), (3.0, 4.0), (5.0, 6.0), (9.5, 10.5)]
    host = [(0.5, 10.0, "viabel.bbvi", MAIN)]
    host += [(s, e, "viabel.step", MAIN) for s, e in steps]
    host += [(steps[i][0] + 0.1, steps[i][0] + 0.2, "viabel.step.replay", MAIN)
             for i in replayed_in]
    host += list(extra)
    return Trace([(1.0, 1.5, "stl_solve")], host, 0.0, 10.0)


@pytest.mark.parametrize("replayed_in,share", [((1, 2), 50.0), ((0, 1, 2, 3), 100.0),
                                               ((3,), 25.0)])
def test_share_of_steps_holding_a_replay(replayed_in, share):
    assert read(step_trace(replayed_in)) == pytest.approx(share)


def test_a_replay_outside_every_step_or_on_another_thread_counts_for_none():
    extra = [(7.0, 7.1, "viabel.step.replay", MAIN), (3.2, 3.3, "viabel.step.replay", OTHER)]
    assert read(step_trace((0,), extra)) == pytest.approx(25.0)


def test_none_against_a_program_without_replay_spans():
    assert read(None) is None
    assert read(step_trace(())) is None
    assert read(Trace([], [(0.0, 1.0, "aten::mm", MAIN)], 0.0, 1.0)) is None
