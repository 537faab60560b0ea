"""Unit tests of viabel_torch.detection's two policies, which FASO's three
engines drive: the ``mc_escalation`` ladder (:class:`_MCLadder`) and the
``rhat_backoff`` check cadence (:class:`_CheckCadence`).

The engines' parity tests against the JAX package (tests/test_torch_faso.py,
tests/test_torch_multistart.py, tests/test_torch_async_raabbvi.py and the
resume tests) hold the whole loops; these pin each rule on its own.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from viabel_torch.detection import _CheckCadence, _MCLadder  # noqa: E402


class Knob:
    """An objective's settable sample count; ``axis`` > 1 rounds a count up
    to a multiple of it, as an MC-sharded objective does."""

    def __init__(self, S, axis=1):
        self.axis = axis
        self.num_mc_samples = S

    @property
    def num_mc_samples(self):
        return self._S

    @num_mc_samples.setter
    def num_mc_samples(self, S):
        self._S = -(-int(S) // self.axis) * self.axis


def ladder(S=10, B=1, escalation=4.0, max_samples=None, patience=3, rtol=0.05, **kw):
    return _MCLadder(Knob(S), B, escalation, max_samples, patience, rtol, **kw)


@pytest.mark.parametrize("stats,patience,rtol,plateaued", [
    ([2.0, 1.95], 3, 0.05, False),           # fewer entries than the patience
    ([2.0, 1.95, 1.91], 3, 0.05, True),      # improved 4.5% < 5% of the first
    ([2.0, 1.95, 1.90], 3, 0.05, False),     # improved exactly 5%: not below
    ([2.0, 1.2, 1.19], 2, 0.05, True),       # only the last two count
    ([2.0, 1.2, 1.19], 3, 0.5, True),        # 40.5% < 50%
    ([1.0, 1.5, 2.0], 3, 0.05, True),        # a growing statistic has stalled
    ([1e300, 1e300, 1e300], 3, 0.05, True),  # clamped overflow reads as a plateau
])
def test_plateau_rule(stats, patience, rtol, plateaued):
    assert ladder(patience=patience, rtol=rtol).plateaued(stats) is plateaued


@pytest.mark.parametrize("S,escalation,max_samples,ceiling,cap,cap_held", [
    (10, 4.0, None, 400, 4, 5),    # 40 S; 10 -> 40 -> 160 -> 400: 3 climbs + 1
    (10, 2.0, None, 400, 7, 8),    # log2(40) = 5.3 -> 6 climbs + 1
    (4, 4.0, 256, 256, 5, 6),      # log4(64) = 3 exactly, and the 1e-9 slack
    (500, 4.0, 100, 100, 2, 4),    # lifts a whole count by one, also at 0
    (0, 4.0, 64, 64, 5, 6),        # S = 0 sizes the log as S = 1
])
def test_ceiling_and_event_cap(S, escalation, max_samples, ceiling, cap, cap_held):
    lad = ladder(S=S, escalation=escalation, max_samples=max_samples)
    assert lad.ceiling == ceiling
    assert lad.event_cap == cap
    # sized again after a climb with two events held (the async schedule
    # after its warm prelude and its resume): the held events plus every
    # climb still possible from the current S
    lad.objective.num_mc_samples = max(S, 1) * escalation
    lad.size_log(held=2)
    assert lad.ceiling == ceiling
    assert lad.event_cap == cap_held


def test_no_ladder_tracks_nothing_and_writes_a_fresh_state():
    lad = ladder(escalation=None, patience=1, rtol=-1.0)  # unchecked without a ladder
    assert lad.ceiling is None and lad.event_cap == 1
    lad.track_rhat(0, 100, 5.0)
    lad.track_mcse(0, True, 1.0, 0.1, 1.0, 25)
    assert lad.rhat == [[]] and lad.mcse == [[]]
    assert lad.stalled([0], [False]) is None
    state = lad.state()
    assert state["mc_samples"] == -1 and state["mc_escalated_at"] == -1
    np.testing.assert_array_equal(state["mc_events"], [[-1, -1]])


@pytest.mark.parametrize("args,message", [
    ((1.0, None, 3, 0.05), '"mc_escalation" must be greater than one'),
    ((4.0, None, 1, 0.05), '"mc_patience" must be at least two'),
    ((4.0, None, 3, 0.0), '"mc_plateau_rtol" must be greater than zero'),
    ((4.0, 0, 3, 0.05), '"mc_max_samples" must be positive'),
])
def test_argument_checks(args, message):
    with pytest.raises(ValueError, match=message):
        _MCLadder.check_args(*args)
    with pytest.raises(ValueError, match=message):
        _MCLadder(Knob(10), 2, *args)


def test_an_objective_without_a_sample_count_raises():
    class NoKnob:
        pass

    with pytest.raises(ValueError, match="num_mc_samples"):
        _MCLadder(NoKnob(), 1, 4.0, None, 3, 0.05)
    with pytest.raises(ValueError, match="num_mc_samples"):
        _MCLadder.pinned_ceiling(NoKnob(), 64)
    # without a ladder the objective needs no sample count
    _MCLadder(NoKnob(), 1, None, None, 3, 0.05)


def test_verdicts_dispatched_before_the_last_climb_never_track():
    lad = ladder(patience=2)
    lad.track_rhat(0, 100, 3.0)
    lad.track_rhat(0, 200, 3.0)
    assert lad.stalled([0], [False]) == [3.0]
    assert lad.climb(250) == 40
    assert lad.rhat == [[]] and lad.escalated_at == 250
    lad.track_rhat(0, 200, 3.0)  # dispatched at 200, read after the climb
    lad.track_rhat(0, 250, 3.0)  # dispatched at the climb's own iteration
    assert lad.rhat == [[]]
    lad.track_rhat(0, 300, 3.0)
    assert lad.rhat == [[3.0]]


def test_mcse_tracks_only_a_ring_capped_window():
    lad = ladder()
    lad.track_mcse(0, False, 0.5, 0.1, 100.0, 25)
    assert lad.mcse == [[]]
    # the binding ratio: MCSE over its threshold, or the ESS floor over ESS
    lad.track_mcse(0, True, 0.5, 0.1, 100.0, 25)
    lad.track_mcse(0, True, 0.05, 0.1, 5.0, 25)
    lad.track_mcse(0, True, 0.05, 0.1, 0.0, 25)
    assert lad.mcse == [[5.0, 5.0, 1e300]]


def test_nothing_tracks_at_the_ceiling():
    lad = ladder(S=10, max_samples=40, patience=2)
    lad.track_rhat(0, 1, 2.0)
    lad.track_rhat(0, 2, 2.0)
    assert lad.climb(3) == 40
    lad.track_rhat(0, 4, 2.0)
    lad.track_mcse(0, True, 1.0, 0.1, 1.0, 25)
    assert lad.rhat == [[]] and lad.mcse == [[]]
    assert lad.stalled([0], [False]) is None


def test_the_ladder_climbs_only_when_every_live_restart_has_plateaued():
    lad = ladder(B=2, patience=2)
    flat, falling = [2.0, 2.0], [2.0, 1.0]
    lad.rhat[0][:] = flat
    lad.rhat[1][:] = falling
    converged = np.array([False, False])
    assert lad.stalled([0, 1], converged) is None
    # a restart that has stopped no longer holds the ladder back
    assert lad.stalled([0], converged) == [2.0]
    # a converged restart is bound by its MCSE tracker, not its R-hat one
    lad.mcse[1][:] = [4.0, 3.9]
    assert lad.stalled([0, 1], np.array([False, True])) == [2.0, 3.9]
    assert lad.stalled([], converged) is None
    assert lad.climb(500) == 40
    assert lad.rhat == [[], []] and lad.mcse == [[], []]


def test_a_climb_reads_back_the_rounded_sample_count():
    lad = _MCLadder(Knob(9, axis=3), 1, 1.5, 100, 3, 0.05)
    assert lad.climb(7, at=1007) == 15           # ceil(9 * 1.5) = 14 -> 15
    assert lad.climb(9) == 24                    # ceil(22.5) = 23 -> 24
    assert lad.events == [(1007, 15), (9, 24)]   # logged at `at`, else k
    assert lad.escalated_at == 9
    lad.objective.num_mc_samples = 99
    assert lad.climb(11) == 102                  # the ceiling, rounded up by the axis


@pytest.mark.parametrize("flat,B", [(True, 1), (False, 1), (False, 2)])
def test_resume_fields_round_trip(flat, B):
    lad = ladder(S=10, B=B, patience=3, flat=flat)
    lad.climb(400)
    lad.rhat[0][:] = [1.5, 1.4, 1.3, 1.2]
    lad.mcse[B - 1][:] = [6.0]
    state = lad.state()

    keys = ("mc_plateau", "mc_plateau_mcse") if flat else ("mc_plateau_r", "mc_plateau_m")
    assert set(state) == {"mc_samples", "mc_escalated_at", *keys, "mc_events"}
    assert state["mc_samples"] == 40 and state["mc_escalated_at"] == 400
    shape = (3,) if flat else (B, 3)
    for key in keys:
        assert np.shape(state[key]) == shape
    # the trackers keep their last mc_patience entries, NaN-padded in front
    rhat_0 = state[keys[0]] if flat else state[keys[0]][0]
    mcse_last = state[keys[1]] if flat else state[keys[1]][B - 1]
    np.testing.assert_array_equal(rhat_0, [1.4, 1.3, 1.2])
    np.testing.assert_array_equal(mcse_last, [np.nan, np.nan, 6.0])
    assert state["mc_events"].shape == (lad.event_cap, 2) == (4, 2)
    np.testing.assert_array_equal(state["mc_events"][0], [400, 40])
    assert (state["mc_events"][1:] == -1).all()

    fresh = ladder(S=10, B=B, patience=3, flat=flat)
    fresh.restore(state)
    assert fresh.objective.num_mc_samples == 40
    assert fresh.escalated_at == 400 and fresh.events == [(400, 40)]
    assert fresh.rhat == [tr[-3:] for tr in lad.rhat]
    assert fresh.mcse == lad.mcse
    for key, value in fresh.state().items():
        np.testing.assert_array_equal(value, state[key])


def test_a_state_without_ladder_fields_restores_a_fresh_ladder():
    lad = ladder(flat=True)
    lad.restore({})
    assert lad.objective.num_mc_samples == 10
    assert lad.escalated_at == -1 and lad.events == []
    assert lad.rhat == [[]] and lad.mcse == [[]]


def cadence(backoff=2.0, threshold=1.1, allowed=None, max_interval=8):
    return _CheckCadence(backoff, threshold, allowed, max_interval)


def test_cadence_backs_off_far_from_the_gate_up_to_one_ring():
    cad = cadence(max_interval=4)
    assert cad.due(0)
    cad.dispatched(100, 100)
    assert cad.next_check_at == 200 and not cad.due(150) and cad.due(200)
    intervals = []
    for ck_k in (100, 200, 300, 400):
        cad.adjust(5.0, ck_k, ck_k)   # far: 5.0 > 2.0 * 1.1
        intervals.append(cad.check_interval)
    assert intervals == [2, 4, 4, 4]
    cad.dispatched(1200, 100)
    assert cad.next_check_at == 1600


def test_cadence_adjusts_once_per_verdict_dispatched_under_the_schedule():
    cad = cadence()
    cad.adjust(5.0, 100, 300)
    assert (cad.check_interval, cad.interval_adjusted_at) == (2, 300)
    cad.adjust(5.0, 200, 400)   # dispatched before the last adjustment
    assert (cad.check_interval, cad.interval_adjusted_at) == (2, 300)
    cad.adjust(5.0, 301, 500)
    assert (cad.check_interval, cad.interval_adjusted_at) == (4, 500)


@pytest.mark.parametrize("allowed,near,far", [(None, 2.2, 2.21), (10, 20, 21), (0, 2, 3)])
def test_cadence_pulls_the_next_check_in_near_the_gate(allowed, near, far):
    """The margin is backoff times the gate: the R-hat threshold in max
    mode, the allowed exceedance count (at least one) in quantile mode."""
    cad = cadence(allowed=allowed)
    cad.adjust(far, 100, 100)
    cad.dispatched(100, 100)
    assert cad.check_interval == 2 and cad.next_check_at == 300
    cad.adjust(near, 200, 200)
    assert cad.check_interval == 1 and cad.next_check_at == 0 and cad.due(200)


def test_cadence_without_backoff_checks_every_boundary_and_resets_and_resumes():
    cad = cadence(backoff=None)
    cad.adjust(50.0, 100, 200)
    assert (cad.check_interval, cad.interval_adjusted_at) == (1, -1)

    cad = cadence()
    cad.adjust(50.0, 100, 200)
    cad.dispatched(300, 100)
    state = cad.state()
    assert state == {"check_interval": 2, "next_check_at": 500, "interval_adjusted_at": 200}
    resumed = cadence()
    resumed.restore(state)
    assert resumed.state() == state
    # a climb (or a restart's new round) brings full cadence back at once
    cad.reset(350)
    assert cad.state() == {"check_interval": 1, "next_check_at": 0,
                           "interval_adjusted_at": 350}
    cad.adjust(50.0, 300, 400)  # dispatched before the reset: no doubling
    assert cad.check_interval == 1
    fresh = cadence()
    fresh.restore({})
    assert fresh.state() == {"check_interval": 1, "next_check_at": 0,
                             "interval_adjusted_at": -1}
