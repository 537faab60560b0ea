"""Time viabel_torch's flagship step and FASO checks on one CUDA card.

    python tools/profile_torch_step.py

At the d=1000 full-rank flagship (``logistic_regression(n_data=512)``,
``ExclusiveKL`` with S=10, RMSProp at lr 0.001, float32), for the STL and
the entropy estimator in turn, and then for ``DISInclusiveKL`` (S=100,
ESS target 50, an MFGaussian temper prior at zero parameters) with and
without resampling, it prints:

- ``[step]``: host milliseconds per optimizer step (ring write included),
  over 500 steps after 100 warm-up steps;
- ``[elbo_grad]``: one value-and-gradient evaluation, median of 50
  CUDA-event-timed calls, and the same per 1k draws.

The step's device time, busy share and phases come from the benchmark's
traced run instead (``python3 perfbench/run.py --workload <cell> --seed
<n> --seconds 51 --trace 1``), on one window, with the program's own
spans.

For DIS it also times the 50-step bisection on ``eps`` alone
(``[dis_bisection]``, CUDA events). Then it times the FASO checks on a
full (600, D) ring (R-hat over five windows, window mean, MCSE check)
with CUDA events, and prints the peak device memory. Nothing is written
to disk. It needs one CUDA card.
"""

import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import viabel_torch as vt  # noqa: E402
from viabel_torch.detection import _mcse_check  # noqa: E402
from viabel_torch.mc_diagnostics import (ring_window_mean,  # noqa: E402
                                         split_rhat_ring_windows)

DIM = 1000
N_DATA = 512
S = 10
DIS_S, DIS_ESS = 100, 50
LR = 0.001
RING_ROWS = 600
GROUP = 50


def cuda_ms(fn, reps):
    """Median milliseconds of ``reps`` calls timed with CUDA events, after
    one warm-up call."""
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
    return statistics.median(times)


def time_estimator(tag, objective, approx, generator, draws):
    sgo = vt.RMSProp(LR)
    state = {"param": approx.init_param()}
    state["opt"] = sgo.init_state(state["param"])
    state["obj"] = objective.init_obj_state(state["param"])
    ring = torch.zeros((RING_ROWS, state["param"].shape[0]), device="cuda")

    def step(i):
        param, opt, obj, *_ = sgo.step(objective, state["param"], state["opt"],
                                       state["obj"], generator, LR)
        state["param"], state["opt"], state["obj"] = param, opt, obj
        ring[i % RING_ROWS] = param

    for i in range(100):
        step(i)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for i in range(500):
        step(i)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - start) / 500
    print(f"[step] {tag} host_ms_per_step={per_step * 1e3:.4f} "
          f"steps_per_s={1 / per_step:.2f}", flush=True)

    ms = cuda_ms(lambda: objective.value_and_grad(state["param"], generator), 50)
    print(f"[elbo_grad] {tag} ms={ms:.4f} ms_per_1k_draws={ms / draws * 1000:.4f}",
          flush=True)


def time_bisection(dis, approx, model, generator):
    """The 50-step bisection on eps alone, on one refresh's draws."""
    param = approx.init_param()
    with torch.no_grad():
        samples = approx.sample(param, DIS_S, generator)
        log_p, log_q = model(samples), approx.log_density(param, samples)
    eps = torch.tensor(1.0, device="cuda")
    ms = cuda_ms(lambda: dis._eps_and_weights(eps, samples, log_p, log_q), 50)
    print(f"[dis_bisection] S={DIS_S} ms={ms:.4f}", flush=True)


def time_checks(generator):
    D = DIM + DIM * DIM
    ring = torch.randn((RING_ROWS, D), device="cuda", generator=generator)
    k = 2 * RING_ROWS  # a wrapped ring
    windows = [200, 300, 400, 500, 600]
    rhat_ms = cuda_ms(lambda: split_rhat_ring_windows(ring, k, windows, GROUP), 10)
    mean_ms = cuda_ms(lambda: ring_window_mean(ring, k, RING_ROWS, GROUP), 10)
    start = time.perf_counter()
    eff, _ = _mcse_check(ring, k, RING_ROWS, None)
    eff.cpu()
    first_mcse_s = time.perf_counter() - start
    mcse_ms = cuda_ms(lambda: _mcse_check(ring, k, RING_ROWS, None), 3)
    print(f"[check] ring=({RING_ROWS}, {D}) rhat_ms={rhat_ms:.4f} "
          f"window_mean_ms={mean_ms:.4f} mcse_ms={mcse_ms:.2f} "
          f"first_mcse_s={first_mcse_s:.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _ = vt.zoo.logistic_regression(dim=DIM, n_data=N_DATA, device="cuda",
                                          dtype=torch.float32)
    approx = vt.FullRankGaussian(DIM, device="cuda", dtype=torch.float32)
    generator = torch.Generator("cuda").manual_seed(0)
    for stl in (True, False):
        time_estimator(f"stl={stl}", vt.ExclusiveKL(approx, model, S, use_path_deriv=stl),
                          approx, generator, S)
    prior = vt.MFGaussian(DIM, device="cuda", dtype=torch.float32)
    for resampling in (True, False):
        dis = vt.DISInclusiveKL(approx, model, DIS_S, ess_target=DIS_ESS, temper_prior=prior,
                                temper_prior_params=torch.zeros(2 * DIM, device="cuda"),
                                use_resampling=resampling)
        time_estimator(f"dis_resampling={resampling}", dis, approx, generator, DIS_S)
    time_bisection(dis, approx, model, generator)
    time_checks(generator)
    print(f"[mem] max_memory_allocated_bytes={torch.cuda.max_memory_allocated()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
