"""The traced window: ``torch.profiler`` over the whole window, reduced to
device intervals, kernel times by name and the host operations open in
the device's idle gaps.

Device time is the union of the card's kernel, copy and set intervals,
so overlapping work counts once. An idle gap is charged to the innermost
host operation open at its middle (on any thread; the latest started
wins), so the breakdown says what the host was doing while the card
waited.
"""

from collections import defaultdict
from contextlib import contextmanager

import torch

#: idle gaps shorter than this are not attributed (the launch latency)
MIN_GAP_S = 20e-6
_NAME_CHARS = 96


class Trace:
    """What a traced window left: ``device`` intervals ``(start_s, end_s,
    name)``, ``host`` operations ``(start_s, end_s, name, thread)``, and
    the window's own bounds on the same clock."""

    def __init__(self, device, host, start_s, end_s):
        self.device = sorted(device)
        self.host = host
        self.start_s, self.end_s = start_s, end_s

    @property
    def window_s(self):
        return self.end_s - self.start_s

    def kernels(self):
        """Kernel intervals (copies and sets left out)."""
        return [ev for ev in self.device if not _is_copy(ev[2])]

    def busy_intervals(self):
        merged = []
        for start, end, _ in self.device:
            start, end = max(start, self.start_s), min(end, self.end_s)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self):
        return sum(end - start for start, end in self.busy_intervals())

    def kernel_totals(self, pattern=None):
        """``{name: (seconds, count)}`` of device operations, or of those
        whose name matches the compiled regex ``pattern``."""
        out = defaultdict(lambda: [0.0, 0])
        for start, end, name in self.device:
            if pattern is None or pattern.search(name):
                out[name][0] += end - start
                out[name][1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def idle_gaps(self):
        """``{host operation: idle seconds}`` over the window."""
        busy = self.busy_intervals()
        edges = [self.start_s] + [x for iv in busy for x in iv] + [self.end_s]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] - edges[i] >= MIN_GAP_S]
        by_thread = defaultdict(list)
        for ev in self.host:
            by_thread[ev[3]].append(ev)
        out = defaultdict(float)
        finders = [_OpenAt(sorted(evs)) for evs in by_thread.values()]
        for start, end in gaps:
            mid = 0.5 * (start + end)
            best = None
            for finder in finders:
                ev = finder.innermost(mid)
                if ev is not None and (best is None or ev[0] > best[0]):
                    best = ev
            out[best[2] if best else "(no host operation)"] += end - start
        return dict(out)


class _OpenAt:
    """The innermost of one thread's nested intervals open at a time,
    for times asked in increasing order."""

    def __init__(self, events):
        self.events, self.i, self.stack = events, 0, []

    def innermost(self, t):
        while self.i < len(self.events) and self.events[self.i][0] <= t:
            ev = self.events[self.i]
            while self.stack and self.stack[-1][1] < ev[0]:
                self.stack.pop()
            self.stack.append(ev)
            self.i += 1
        while self.stack and self.stack[-1][1] < t:
            self.stack.pop()
        return self.stack[-1] if self.stack else None


def _is_copy(name):
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def short(name):
    return name if len(name) <= _NAME_CHARS else name[:_NAME_CHARS - 3] + "..."


WINDOW_SPAN = "perfbench.window"


@contextmanager
def traced(enabled, out):
    """Profile the body when ``enabled`` and put its :class:`Trace` into
    ``out["trace"]``. The body runs inside a span whose host interval,
    synchronised at its end, is the traced window on the profiler's
    clock."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    out["trace"] = _reduce(prof)


def _reduce(prof):
    """Seconds from the window's start (integer nanoseconds subtracted
    first: an absolute time in seconds would keep only 0.2 us). A span's
    mirror on the card's timeline (a user annotation) is no device work
    and is left out."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    window = next((ev for ev in events if ev.name() == WINDOW_SPAN
                   and ev.device_type() != DeviceType.CUDA), None)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_SPAN!r} span")
    base = window.start_ns()
    annotations = {ev.name() for ev in events
                   if ev.is_user_annotation() and ev.device_type() != DeviceType.CUDA}
    device, host = [], []
    for ev in events:
        s, e = (ev.start_ns() - base) * 1e-9, (ev.end_ns() - base) * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and ev.name() not in annotations:
                device.append((s, e, ev.name()))
        elif e > s and ev is not window:
            host.append((s, e, ev.name(), ev.start_thread_id()))
    return Trace(device, host, 0.0, (window.end_ns() - base) * 1e-9)


def top(items, n=10):
    """The ``n`` largest ``[name, seconds]`` of a ``{name: seconds}``."""
    rows = sorted(items.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[short(k), v] for k, v in rows]

