"""Time the STL solve kernel (``csrc/stl_solve.cu``) on one CUDA card.

    python tools/time_stl_solve.py

At the shapes the STL caller sends (d=1000 with S=10 and its escalations
to 40, 160 and 400), the kernel's range edge (1536, 16), and S=1 (the
chain of panels with the least arithmetic), it prints for float32 (float64
at S=10) the median of 50 CUDA-event-timed calls of the kernel beside
cuBLAS's solve on the formed factor, each as "events/device". B has the
layout the STL caller passes: the transposed view of contiguous (S, d)
draws. Each result is held against the plain version first. A CUDA-event
time of one call includes any wait of the card for the host's launch, so
each is also timed on the card alone: its kernels' device time under
``torch.profiler``, over 50 calls. Last come the compiler's register and
spill lines for the kernel (when this process built it). Nothing is
written to disk.
"""

import os
import statistics
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from viabel_torch import ops  # noqa: E402
from viabel_torch.ops.trsm import cholesky_factor  # noqa: E402

CASES = [(1000, 10, torch.float32), (1000, 40, torch.float32),
         (1000, 160, torch.float32), (1000, 400, torch.float32),
         (1536, 16, torch.float32), (1000, 1, torch.float32),
         (1000, 10, torch.float64)]


def cuda_ms(fn, reps=50):
    """Median milliseconds of ``reps`` calls timed with CUDA events, after
    three warm-up calls."""
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
    return statistics.median(times)


def device_ms(fn, reps=50):
    """Device time of ``fn``'s kernels per call under ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA) / 1e3 / reps


def main():
    if not torch.cuda.is_available():
        print("time_stl_solve: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.load_library()
    gen = torch.Generator("cuda").manual_seed(11)
    for d, S, dtype in CASES:
        theta = 0.1 * torch.randn((d, d), generator=gen, device="cuda", dtype=dtype)
        B = torch.randn((S, d), generator=gen, device="cuda", dtype=dtype).T
        P = ops.stl_transpose_solve_plain(theta, B)
        rel = float((ops.stl_transpose_solve(theta, B) - P).abs().max()) / float(P.abs().max())
        if not rel <= (1e-4 if dtype == torch.float32 else 1e-10):
            raise AssertionError(f"({d}, {S}) {dtype}: max-norm rel err {rel}")
        LT = cholesky_factor(theta).T

        def kernel():
            return ops.stl_transpose_solve(theta, B)

        def library():
            return torch.linalg.solve_triangular(LT, B, upper=True)

        print(f"[time] ({d}, {S}) {dtype} ms (events/device): "
              f"kernel={cuda_ms(kernel):.4f}/{device_ms(kernel):.4f} "
              f"library={cuda_ms(library):.4f}/{device_ms(library):.4f}", flush=True)
    lines = ops.build_info()["log"].splitlines()
    for i, line in enumerate(lines):
        if "stl_solve" in line and "Compiling entry" in line:
            print("[ptxas] " + line.strip())
            for follow in lines[i + 1:i + 4]:
                if "registers" in follow or "spill" in follow:
                    print("[ptxas]   " + follow.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
