"""Time the error bounds' spectral norm of q's covariance on one CUDA card.

    python tools/time_cov_norm.py [--seed N]

Fits q as the benchmark's front-door cell does (``logreg1000_fullrank``
under the ``diag_front_door`` traffic: 2,000 STL steps in float32, built by
``perfbench.program.System``), forms its (1000, 1000) covariance
``L @ L.T`` and prints for two routes, the SVD (``torch.linalg.matrix_norm(
var, ord=2)``) and the symmetric one (``diagnostics._spectral_norm``):
the median and range of 20 CUDA-event-timed calls, the device time a call
under ``torch.profiler`` with its costliest kernels, the relative error
against the float64 SVD norm, and whether the eigensolve ran. Then the
wall time of whole ``vi_diagnostics`` calls (100,000 draws) with the norm
taken each way, alternating, and the count of each ``viabel.`` span that
five calls open.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench.program import System, generator_seed  # noqa: E402
from viabel_torch import diagnostics  # noqa: E402


def svd_norm(var):
    return torch.linalg.matrix_norm(var, ord=2)


ROUTES = {"svd": svd_norm, "eigh": diagnostics._spectral_norm}


def cuda_ms(fn, reps=20):
    """Milliseconds of ``reps`` calls timed with CUDA events, after three
    warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(fn, reps=10, top=4):
    """Device time a call under ``torch.profiler``, and the costliest
    kernels' names with their ms a call (the program's spans, which the
    profiler also puts on the device's timeline, left out)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((k.self_device_time_total / 1e3 / reps, k.key)
                      for k in prof.key_averages()
                      if k.device_type == DeviceType.CUDA and not k.key.startswith("viabel.")),
                     reverse=True)
    return sum(ms for ms, _ in kernels), kernels[:top]


def fitted(seed):
    """The cell's system and q, fitted as the cell's set-up fits it."""
    with open(os.path.join(ROOT, "perfbench", "configs", "logreg1000_fullrank.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "traffic", "diag_front_door.json")) as f:
        traffic = json.load(f)
    system = System(config, traffic, seed, "cuda")
    generator = torch.Generator("cuda").manual_seed(generator_seed(seed))
    with contextlib.redirect_stdout(io.StringIO()):
        res = system.fit(generator, n_iters=int(traffic["fit_iters"]))
    return system, res["opt_param"].detach().clone(), int(traffic["n_samples"])


def call_walls(system, q, n_samples, seed, calls=10):
    """Seconds of whole ``vi_diagnostics`` calls, the routes alternating,
    each call on the same fresh generator."""
    walls = {name: [] for name in ROUTES}
    try:
        for i in range(calls + 1):
            for name, route in ROUTES.items():
                diagnostics._spectral_norm = route
                generator = torch.Generator("cuda").manual_seed(generator_seed(seed, 2 + i))
                torch.cuda.synchronize()
                start = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    res = system.vt.vi_diagnostics(q, model=system.model, approx=system.approx,
                                                   n_samples=n_samples, generator=generator)
                float(res["khat"])
                torch.cuda.synchronize()
                if i:  # the first pair warms the shapes
                    walls[name].append(time.perf_counter() - start)
    finally:
        diagnostics._spectral_norm = ROUTES["eigh"]
    return walls, res


def span_counts(system, q, n_samples, seed, calls=5):
    """How many of each ``viabel.`` span ``calls`` front-door calls
    open under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(calls):
            generator = torch.Generator("cuda").manual_seed(generator_seed(seed, 2 + i))
            with contextlib.redirect_stdout(io.StringIO()):
                system.vt.vi_diagnostics(q, model=system.model, approx=system.approx,
                                         n_samples=n_samples, generator=generator)
    return {k.key: k.count for k in prof.key_averages()
            if k.key.startswith("viabel.") and k.device_type != DeviceType.CUDA}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2**31 + 12345)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_cov_norm: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    system, q, n_samples = fitted(args.seed)
    var = system.approx.mean_and_cov(q)[1]
    exact = float(svd_norm(var.double()))
    skew = float(torch.linalg.matrix_norm(var - var.mT)) / 2
    print(f"[cov] seed {args.seed} {tuple(var.shape)} {var.dtype}: ||skew||_F {skew!r}, "
          f"||var||_F {float(torch.linalg.matrix_norm(var))!r}, float64 SVD norm {exact!r}",
          flush=True)
    for name, route in ROUTES.items():
        solves = []
        eigvalsh = torch.linalg.eigvalsh
        torch.linalg.eigvalsh = lambda a, *rest, **kw: solves.append(1) or eigvalsh(a, *rest, **kw)
        try:
            rel = abs(float(route(var)) - exact) / exact
        finally:
            torch.linalg.eigvalsh = eigvalsh
        times = cuda_ms(lambda: route(var))
        dev, kernels = device_ms(lambda: route(var))
        print(f"[route] {name}: events ms median {statistics.median(times)!r} "
              f"min {min(times)!r} max {max(times)!r}; device ms a call {dev!r}; "
              f"rel err vs float64 SVD {rel!r}; eigensolves {len(solves)}", flush=True)
        for ms, key in kernels:
            print(f"[route]   {name} {key}: {ms!r} ms a call", flush=True)
    walls, res = call_walls(system, q, n_samples, args.seed)
    for name, values in walls.items():
        print(f"[call] {name}: vi_diagnostics s median {statistics.median(values)!r} "
              f"min {min(values)!r} max {max(values)!r} over {len(values)}", flush=True)
    print(f"[call] khat {float(res['khat'])!r}, branch {'bounds' if 'd2' in res else 'ksd'}")
    print(f"[spans] over 5 calls: {span_counts(system, q, n_samples, args.seed)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
