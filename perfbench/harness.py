"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

The order is fixed: the library load, the data and the set-up of the
traffic's kind (which drives the program's first steps for the check
and warms the window's shapes) count as set-up; then the window, with
the program's printing sent nowhere; then the peak memory is read; then
the reference judges what the window produced; then the metrics' readers
run. Only the kinds and ``program.py`` import ``viabel_torch``.
"""

import importlib
import io
import sys
import time
import warnings
from contextlib import ExitStack, contextmanager, nullcontext, redirect_stdout

import torch

from . import compare, trace
from .program import System, generator_seed
from .spans import Spans

FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "viabel_tpu"})


def forbidden_modules(modules=None):
    """Top-level names (whole, before the first dot) of loaded modules
    that a run may not hold."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN_MODULES)


class Run:
    """What one run carries between its phases."""

    def __init__(self, cell, seed, device):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.kind = importlib.import_module(f"perfbench.kinds.{self.traffic['kind']}")
        self.check, self.window = {}, {}
        self.excluded_s = 0.0
        self.system = self.generator = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def log(message):
        print(message, file=sys.stderr, flush=True)

    @contextmanager
    def excluded(self):
        """Work inside set-up that serves only the check, kept out of
        ``setup_s``."""
        self.sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.excluded_s += time.perf_counter() - start


@contextmanager
def _quiet():
    """The program's printing and warnings go nowhere."""
    with redirect_stdout(io.StringIO()), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _span_targets(traffic):
    """``[(module, {attribute: span name})]`` named by the traffic file."""
    return [(importlib.import_module(mod), names)
            for mod, names in traffic.get("spans", {}).items()]


def run_cell(cell, seed, seconds, trace_on, device="cuda", started=None, planted=None):
    """Run ``cell`` once; returns ``(result, rows)``: the result's dict
    and the compared numbers beside their limits. ``planted`` is a
    context manager put around set-up and the window (a fault planted
    under the timed path, for tests)."""
    started = time.perf_counter() if started is None else started
    run = Run(cell, seed, device)
    on_card = run.device.type == "cuda"
    planted = planted or nullcontext()
    marks = [("start", started), ("harness", time.perf_counter())]
    with planted:
        with _quiet():
            if on_card:
                from viabel_torch import ops
                ops.load_library()
            marks.append(("library", time.perf_counter()))
            run.generator = torch.Generator(run.device).manual_seed(generator_seed(seed))
            run.system = System(run.config, run.traffic, seed, run.device)
            run.sync()
            marks.append(("model", time.perf_counter()))
            run.kind.setup(run)
        run.sync()
        marks.append(("traffic", time.perf_counter()))
        setup_s = time.perf_counter() - started - run.excluded_s
        run.log("set-up seconds: " + ", ".join(
            f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:]))
            + f"; kept out for the check {run.excluded_s:.3f}")

        if on_card:
            from viabel_torch import ops
            ops.reset_launch_counts()
        spans = Spans(run.device)
        out = {}
        with _quiet(), trace.traced(trace_on, out), ExitStack() as stack:
            if trace_on:
                for module, names in _span_targets(run.traffic):
                    stack.enter_context(spans.around(module, names))
            run.kind.window(run, seconds)
    if "summary" in run.window:
        print(run.window["summary"], flush=True)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    launches = ops.launch_counts() if on_card else {}

    checked = time.perf_counter()
    numbers = run.kind.verify(run)
    run.log(f"the reference's check took {time.perf_counter() - checked:.3f} s")
    correct, rows = compare.judge(numbers, cell.limits)
    if int(run.window.get("failed", 0)):
        correct = False

    ctx = {"window": run.window, "setup_s": setup_s, "trace": out.get("trace"),
           "spans": spans, "launches": launches, "config": run.config,
           "traffic": run.traffic, "system": run.system}
    metrics = {}
    for entry in cell.metrics(trace_on):
        value = cell.reader(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.window.get("attempted", 0)),
              "failed": int(run.window.get("failed", 0)), "metrics": metrics, "device": dev}
    tr = out.get("trace")
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": trace.top({k: v[0] for k, v in tr.kernel_totals().items()}),
            "idle_gaps": trace.top(tr.idle_gaps())}
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return result, rows

