"""What the readers of the program's own spans share: the ``viabel.``
spans of a traced window and the host syncs inside them.

The program opens a span at each of its layer boundaries
(``viabel_torch.tracing``): a profiler ``record_function`` on the main
thread, recorded on the same clock as the card's work, only while a
profiler records. The main thread is the one that opened the most
``viabel.`` spans. A host sync is a CUDA runtime call that blocks the
host (``SYNC_CALLS``) whose middle lies inside a ``viabel.`` span;
implicit ones (``.item()``, ``.cpu()``, ``torch.nonzero``, a library's
error check) are counted where they happen. A call made directly inside
one of the benchmark's own wrappers (the traffic file's ``spans``: no
other operation of the window encloses it there) is the benchmark's, and
is not counted. Against a program without spans every answer is None.
"""

from bisect import bisect_right
from collections import Counter, defaultdict

PREFIX = "viabel."
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize",
                        "cudaDeviceSynchronize", "cudaMemcpy"})
#: the profiler's own host events, which are no operation of the program
PROFILER_EVENTS = frozenset({"Activity Buffer Request"})


def program_spans(ctx):
    """The window's :class:`ProgramSpans`, built once a trace; None
    without a trace or without a ``viabel.`` span in it."""
    tr = ctx["trace"]
    if tr is None:
        return None
    if not hasattr(tr, "program_spans"):
        wrappers = {name for attrs in ctx["traffic"].get("spans", {}).values()
                    for name in attrs.values()}
        found = ProgramSpans(tr, wrappers)
        tr.program_spans = found if found.spans else None
    return tr.program_spans


class ProgramSpans:
    """A traced window's ``viabel.`` spans by name, as ``(start_s, end_s)``
    on the main thread, cut to the window, and its host syncs."""

    def __init__(self, trace, wrappers=()):
        self.trace = trace
        lo, hi = trace.start_s, trace.end_s
        by_thread = defaultdict(list)
        syncs, wrapped = [], []
        for ev in trace.host:
            start, end, name, thread = ev
            if name.startswith(PREFIX):
                by_thread[thread].append(ev)
            elif name in SYNC_CALLS and lo <= 0.5 * (start + end) <= hi:
                syncs.append(ev)
            elif name in wrappers:
                wrapped.append((start, end))
        main = max(by_thread, key=lambda t: len(by_thread[t])) if by_thread else None
        self.spans = defaultdict(list)
        for start, end, name, _ in by_thread.get(main, []):
            if end > lo and start < hi:
                self.spans[name].append((max(start, lo), min(end, hi)))
        for found in self.spans.values():
            found.sort()
        inside = _union(iv for found in self.spans.values() for iv in found)
        syncs = [ev for ev in syncs if _covers(inside, 0.5 * (ev[0] + ev[1]))]
        if wrapped and syncs:
            wrapped.sort()
            skip = SYNC_CALLS | PROFILER_EVENTS | set(wrappers)
            others = sorted((s, e) for s, e, name, _ in trace.host if name not in skip)
            syncs = [ev for ev in syncs if not _benchmarks(ev, wrapped, others)]
        self.syncs = Counter(ev[2] for ev in syncs)

    def intervals(self, name):
        return self.spans.get(name, [])

    def count(self, name):
        return len(self.intervals(name))

    def seconds(self, name):
        return sum(end - start for start, end in self.intervals(name))

    def host_syncs(self):
        return sum(self.syncs.values())

    def idle_outside_s(self, name):
        """Seconds of the window in which the card is idle and no span
        ``name`` is open."""
        tr = self.trace
        busy = _union([(s, e) for s, e in tr.busy_intervals()] + self.intervals(name))
        return tr.window_s - sum(e - s for s, e in busy)


def _union(intervals):
    """The sorted, merged union of ``(start, end)`` intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _covers(merged, t):
    i = bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def _benchmarks(sync, wrapped, others):
    """Whether ``sync`` was made directly inside a benchmark wrapper: the
    wrapper (``wrapped``, sorted; they do not nest) that holds its middle,
    with no other operation (``others``, sorted) that started inside that
    wrapper holding it too."""
    mid = 0.5 * (sync[0] + sync[1])
    i = bisect_right(wrapped, (mid, float("inf"))) - 1
    if i < 0 or wrapped[i][1] < mid:
        return False
    first = bisect_right(others, (wrapped[i][0], float("inf")))
    last = bisect_right(others, (mid, float("inf")))
    return not any(e >= mid for _, e in others[first:last])
