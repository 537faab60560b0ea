"""FASO's detection library, shared by the three engines that run FASO's
loop: single-run :class:`viabel_torch.FASO`,
:func:`viabel_torch.parallel.multistart_faso`, and the async schedule of
:func:`viabel_torch.parallel.multistart_raabbvi`. Beside the detection
geometry, the windowed MCSE check and the host read-back of verdicts, it
holds two policies the engines drive: the ``mc_escalation`` ladder
(:class:`_MCLadder`) and the ``rhat_backoff`` check cadence
(:class:`_CheckCadence`), each with its resume fields.
"""

import math

import numpy as np
import torch

from .mc_diagnostics import ess_and_mcse_windowed
from .ops.ringstats import colsum


def _largest_divisor_leq(n, cap):
    for g in range(min(cap, n), 0, -1):
        if n % g == 0:
            return g
    return 1


def _detection_geometry(D, W_min, k_check, ESS_min, rhat_group,
                        rhat_quantile, rhat_backoff, R_base):
    """Validate the detection knobs and derive the geometry: check cadence
    ``k_check``, the ESS floor, the R-hat group granularity ``G`` (a
    divisor of ``k_check``), the group-quantized ring length ``R`` grown
    from ``R_base``, and the quantile gate's allowed exceedance count.
    Returns ``(k_check, ESS_min, G, R, rhat_allowed)``."""
    k_check = int(W_min if k_check is None else k_check)
    ESS_min = W_min // 8 if ESS_min is None else ESS_min
    if rhat_group is not None and (int(rhat_group) <= 0
                                   or k_check % int(rhat_group) != 0):
        raise ValueError('"rhat_group" must be a positive divisor of '
                         'k_check (checks happen at k_check multiples)')
    G = (int(rhat_group) if rhat_group
         else _largest_divisor_leq(k_check, max(1, min(64, W_min // 4))))
    if rhat_quantile is not None and not 0.0 < float(rhat_quantile) < 1.0:
        raise ValueError('"rhat_quantile" must be in (0, 1)')
    if rhat_backoff is not None and float(rhat_backoff) <= 1.0:
        raise ValueError('"rhat_backoff" must be greater than one')
    R = max(int(R_base), 2 * int(W_min))
    R = -(-R // G) * G  # round up to whole groups
    rhat_allowed = (None if rhat_quantile is None
                    else int((1.0 - float(rhat_quantile)) * D))
    return k_check, ESS_min, G, R, rhat_allowed


def _backoff_adjust(best_stat, check_interval, max_interval,
                    rhat_backoff, rhat_threshold, rhat_allowed):
    """The R-hat backoff cadence rule: far from the gate -> double the
    check interval (capped at one ring length); within the margin -> full
    cadence. Returns ``(check_interval, pull_next_check_forward)``."""
    far_gate = float(rhat_backoff) * (
        rhat_threshold if rhat_allowed is None else max(rhat_allowed, 1))
    if best_stat > far_gate:
        return min(check_interval * 2, max_interval), False
    return 1, True


def _candidate_windows(W_min, W_upper, G):
    """Reference candidates linspace(W_min, 0.95k, 5), quantized to even
    multiples of ``2 * G`` so every half-chain boundary lands on a group."""
    cand = np.linspace(W_min, W_upper, num=5)
    half = np.ceil(cand / (2 * G)).astype(int) * G
    half = np.clip(half, G, (W_upper // (2 * G)) * G)
    return np.unique(2 * half)


def _recheck_scale(relative_opt_time, relative_mcse_time):
    """Cost-aware MCSE recheck growth factor (reference 601-605)."""
    ratio = relative_opt_time / max(relative_mcse_time, 1e-12)
    return max(1.05, 1.0 + 1.0 / math.sqrt(1.0 + ratio))


def _mcse_check(ring, t, w, mf_dim, chunk=8192, c0=0, gather=None):
    """Windowed per-coordinate (ESS, MCSE) with the reference's MFGaussian
    scaling and constant-coordinate handling (optimization.py:575-592).

    For MFGaussian, ``mcse_mean = mcse_mu / exp(mean log_sigma)``;
    constant coordinates (zero last-step difference) get ``ess = +inf,
    mcse = 0``. The ring's columns are streamed ``chunk`` at a time, each
    chunk gathered oldest-first over the window only, so the peak extra
    memory is one ``(w, chunk)`` slab and its FFT, not a reordered copy of
    the whole ring.

    A column shard of the ring (``FASO(mesh=...)``) starts at global
    column ``c0``; ``gather`` assembles the whole window mean from every
    rank's, since a ``mu`` column's ``log_sigma`` column may lie on
    another rank.
    """
    R, D = ring.shape
    t, w = int(t), int(w)
    idx = torch.as_tensor([(t - w + j) % R for j in range(w)],
                          device=ring.device)
    # a shard with no column (D == 0) has empty statistics
    effs, mcses, means, diffs = ([ring.new_zeros(0)] for _ in range(4))
    for j in range(0, D, chunk):
        ordered = ring[idx, j:j + chunk]
        eff_c, mcse_c = ess_and_mcse_windowed(ordered, w, chunk_size=chunk)
        effs.append(eff_c)
        mcses.append(mcse_c)
        means.append(colsum(ordered) / w)
        diffs.append(ordered[w - 2] - ordered[w - 1])
    eff, mcse, mean_w, diff = (torch.cat(x) for x in (effs, mcses, means, diffs))
    if mf_dim is not None:
        # log_sigma coordinates occupy [dim, 2*dim); this shard's mu
        # columns are its first n_mu
        full_mean = mean_w if gather is None else gather(mean_w)
        n_mu = max(0, min(mf_dim - c0, D))
        mcse = torch.cat([mcse[:n_mu] / torch.exp(full_mean[c0 + mf_dim:c0 + mf_dim + n_mu]),
                          mcse[n_mu:]])
    const = diff == 0.0
    eff = torch.where(const, torch.inf, eff)
    mcse = torch.where(const, 0.0, mcse)
    return eff, mcse


def _to_host_async(x):
    """Start a device-to-host copy of a small tensor; returns a handle for
    :func:`_read_host`."""
    if x.is_cuda:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event
    return x, None


def _read_host(handle):
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


def _host_handle(array):
    """A :func:`_read_host` handle of a verdict already on the host (one
    carried in a resume state)."""
    return torch.from_numpy(np.array(array)), None


def _clamp_stat(value):
    """Plateau-tracker entries clamped to a large finite value (an
    overflowing gate statistic reads as a plateau, as in the JAX package)."""
    v = float(value)
    return min(v, 1e300) if math.isfinite(v) else 1e300


def _pad_tail(values, size):
    """The last ``size`` entries, NaN-padded at the front to a fixed shape
    (the JAX package's checkpoint layout)."""
    out = np.full(max(size, 1), np.nan)
    tail = list(values)[-size:]
    if tail:
        out[-len(tail):] = tail
    return out


def _pad_events(events, cap):
    """``(iteration, new_S)`` rows padded to a fixed ``cap`` with -1 rows."""
    out = np.full((max(cap, 1), 2), -1, dtype=np.int64)
    if events:
        rows = np.asarray(events, dtype=np.int64).reshape(-1, 2)[:cap]
        out[:len(rows)] = rows
    return out


def _events_of(rows):
    """The ``(iteration, new_S)`` pairs of a padded event log."""
    return [(int(a), int(b)) for a, b in np.asarray(rows).reshape(-1, 2) if a >= 0]


def _events_array(events):
    return np.asarray(events, dtype=np.int64).reshape(-1, 2)


def _restore_mc_samples(rs, objective):
    S = int(rs.get("mc_samples", -1))  # -1 or absent: no ladder ran
    if S > 0:
        objective.num_mc_samples = S


def _rounds_ladder_state(objective, escalation, events):
    """The ladder's fields of a RAABBVI run between rounds."""
    return {"mc_samples": (int(objective.num_mc_samples)
                           if escalation is not None else -1),
            "mc_events_outer": _pad_events(events, max(len(events), 1))}


def _restore_rounds_ladder(rs, objective):
    """Sets a RAABBVI run's S back from :func:`_rounds_ladder_state`;
    returns its events."""
    _restore_mc_samples(rs, objective)
    return _events_of(rs.get("mc_events_outer", np.zeros((0, 2))))


class _MCLadder:
    """The gradient-SNR escalation ladder (``mc_escalation``) of B restarts
    that share one objective, so one sample count S (B = 1 in FASO).

    Each restart tracks its failing R-hat statistics and, at a ring-capped
    window, its MCSE/ESS gate ratios. S climbs by ``escalation``, up to
    ``max_samples`` or else 40 times the S the ladder starts from, once the
    binding tracker of every live restart (R-hat before its convergence,
    MCSE after) has plateaued: its last ``mc_patience`` entries improved by
    less than ``mc_plateau_rtol`` of the first. ``escalation=None``: no
    ladder. ``flat``: FASO's resume layout (``mc_plateau`` and
    ``mc_plateau_mcse``, shape ``(mc_patience,)``), not the batched one
    (``mc_plateau_r`` and ``mc_plateau_m``, shape ``(B, mc_patience)``).
    """

    def __init__(self, objective, n_restarts, escalation, max_samples, mc_patience,
                 mc_plateau_rtol, *, flat=False):
        self.objective = objective
        self.escalation = None if escalation is None else float(escalation)
        self.mc_patience, self.mc_plateau_rtol = int(mc_patience), float(mc_plateau_rtol)
        self.flat = flat
        self.ceiling = None
        if self.escalation is not None:
            self.check_args(escalation, max_samples, mc_patience, mc_plateau_rtol)
            self.ceiling = self.pinned_ceiling(objective, max_samples)
        self.rhat = [[] for _ in range(n_restarts)]
        self.mcse = [[] for _ in range(n_restarts)]
        self.events = []
        self.escalated_at = -1
        self.size_log()

    @staticmethod
    def check_args(escalation, max_samples, mc_patience, mc_plateau_rtol):
        if escalation is not None and float(escalation) <= 1.0:
            raise ValueError('"mc_escalation" must be greater than one')
        if int(mc_patience) < 2:
            raise ValueError('"mc_patience" must be at least two')
        if float(mc_plateau_rtol) <= 0.0:
            raise ValueError('"mc_plateau_rtol" must be greater than zero')
        if max_samples is not None and int(max_samples) <= 0:
            raise ValueError('"mc_max_samples" must be positive')

    @staticmethod
    def pinned_ceiling(objective, max_samples):
        """The ceiling for ``objective`` at its current S."""
        S = getattr(objective, "num_mc_samples", None)
        if S is None:
            raise ValueError(
                "mc_escalation needs an objective exposing a settable "
                "num_mc_samples (got {})".format(type(objective).__name__))
        return int(max_samples) if max_samples is not None else 40 * int(S)

    def size_log(self, held=0):
        """Size the resume state's event log: ``held`` events plus every
        climb still possible from the current S."""
        self.event_cap = 1
        if self.escalation is not None:
            S = max(int(self.objective.num_mc_samples), 1)
            self.event_cap = held + 1 + max(0, int(math.ceil(
                math.log(max(self.ceiling / S, 1.0)) / math.log(self.escalation) + 1e-9)))

    def can_climb(self):
        return (self.escalation is not None
                and int(self.objective.num_mc_samples) < self.ceiling)

    def track_rhat(self, b, k_dispatch, stat):
        # a verdict dispatched before the last climb never tracks
        if k_dispatch > self.escalated_at and self.can_climb():
            self.rhat[b].append(_clamp_stat(stat))

    def track_mcse(self, b, ring_capped, mcse_stat, mcse_threshold, ess_stat, ESS_min):
        # only a ring-capped window's stalled gate is a gradient-SNR wall
        if ring_capped and self.can_climb():
            self.mcse[b].append(_clamp_stat(
                max(mcse_stat / mcse_threshold, ESS_min / max(ess_stat, 1e-300))))

    def plateaued(self, stats):
        if len(stats) < self.mc_patience:
            return False
        w = stats[-self.mc_patience:]
        return w[0] - w[-1] < self.mc_plateau_rtol * abs(w[0])

    def stalled(self, live, converged):
        """The binding statistics of the ``live`` restarts if all have
        plateaued and S can climb, else None."""
        if not live or not self.can_climb():
            return None
        stats = []
        for b in live:
            tracker = self.mcse[b] if converged[b] else self.rhat[b]
            if not self.plateaued(tracker):
                return None
            stats.append(tracker[-1])
        return stats

    def climb(self, k, at=None):
        """One rung at iteration ``k``, logged at ``at`` (default ``k``).
        Returns the S in use, which a sharded objective rounds up to a
        multiple of its axis size."""
        self.objective.num_mc_samples = min(
            int(math.ceil(self.objective.num_mc_samples * self.escalation)), self.ceiling)
        new_S = int(self.objective.num_mc_samples)
        self.escalated_at = k
        self.events.append((k if at is None else at, new_S))
        for tracker in self.rhat + self.mcse:
            tracker.clear()
        return new_S

    def clear(self, b):
        self.rhat[b].clear()
        self.mcse[b].clear()

    def state(self):
        """The resume fields at fixed sizes, as the JAX package writes them."""
        rhat = [_pad_tail(tr, self.mc_patience) for tr in self.rhat]
        mcse = [_pad_tail(tr, self.mc_patience) for tr in self.mcse]
        trackers = ({"mc_plateau": rhat[0], "mc_plateau_mcse": mcse[0]} if self.flat
                    else {"mc_plateau_r": np.stack(rhat), "mc_plateau_m": np.stack(mcse)})
        return {"mc_samples": (int(self.objective.num_mc_samples)
                               if self.escalation is not None else -1),
                "mc_escalated_at": self.escalated_at,
                **trackers,
                "mc_events": _pad_events(self.events, self.event_cap)}

    def restore(self, rs):
        """Continue from :meth:`state`'s fields; those ``rs`` lacks read as
        a fresh ladder's. Sets S into the objective."""
        if self.escalation is None:
            return
        _restore_mc_samples(rs, self.objective)
        self.escalated_at = int(rs.get("mc_escalated_at", -1))
        keys = ("mc_plateau", "mc_plateau_mcse") if self.flat else ("mc_plateau_r",
                                                                     "mc_plateau_m")
        self.rhat, self.mcse = (
            [[float(v) for v in row if np.isfinite(v)]
             for row in np.asarray(rs.get(key, ()), dtype=float).reshape(len(self.rhat), -1)]
            for key in keys)
        self.events = _events_of(rs.get("mc_events", np.zeros((0, 2))))


class _CheckCadence:
    """The R-hat check cadence (``rhat_backoff``), in ``k_check`` units;
    :func:`_backoff_adjust` is its rule. Without ``backoff`` every
    ``k_check`` boundary is due."""

    def __init__(self, backoff, rhat_threshold, rhat_allowed, max_interval):
        self.backoff = backoff
        self.rhat_threshold, self.rhat_allowed = rhat_threshold, rhat_allowed
        self.max_interval = max_interval
        self.reset(-1)

    def due(self, k):
        return k >= self.next_check_at

    def dispatched(self, k, k_check):
        self.next_check_at = k + k_check * self.check_interval

    def adjust(self, best_stat, ck_k, k):
        """A verdict dispatched at ``ck_k``, read at ``k``: at most one
        change per verdict dispatched under the current schedule."""
        if self.backoff is not None and ck_k > self.interval_adjusted_at:
            self.check_interval, pull = _backoff_adjust(
                best_stat, self.check_interval, self.max_interval, self.backoff,
                self.rhat_threshold, self.rhat_allowed)
            if pull:
                self.next_check_at = 0
            self.interval_adjusted_at = k

    def reset(self, k):
        """Full cadence from iteration ``k`` on."""
        self.check_interval, self.next_check_at, self.interval_adjusted_at = 1, 0, k

    def state(self):
        return {"check_interval": self.check_interval,
                "next_check_at": self.next_check_at,
                "interval_adjusted_at": self.interval_adjusted_at}

    def restore(self, rs):
        self.check_interval = int(rs.get("check_interval", 1))
        self.next_check_at = int(rs.get("next_check_at", 0))
        self.interval_adjusted_at = int(rs.get("interval_adjusted_at", -1))
