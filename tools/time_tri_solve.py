"""Time the generic triangular solve (``csrc/tri_solve.cu``) on one CUDA card.

    python tools/time_tri_solve.py

At the shapes its callers send in float32 (d=1000 with S=10, the RAABBVI
round's KL at S=1000, the KSD null scores' S=4096 forward and adjoint, and
the front door's S=100,000), it prints the median of 20 CUDA-event-timed
calls and the device time per call under ``torch.profiler`` of
``torch.linalg.solve_triangular`` and of three builds of the kernel's
source: as it stands (the wide tile of 16 columns above 512 columns, one
512-thread block an SM with up to 128 registers a thread and 16 loads in
flight), with the wide tile held to two blocks an SM (64 registers, 8
loads in flight; it spills), and with the narrow tiles only.
Each build is made from a copy of ``csrc/tri_solve.cu`` with its text
replaced as ``VARIANTS`` says, compiled alone under
``build/viabel_torch/variants/`` and called through ctypes as the wrapper
calls it; each result is held against the plain version first.
Last come the compiler's register and spill lines of each build's float32
kernels.
"""

import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from viabel_torch.ops import _build, vmem_solve_triangular_plain  # noqa: E402

SOURCE = _build._PACKAGE / "csrc" / "tri_solve.cu"
VARIANT_DIR = _build.BUILD_DIR / "variants"
#: build name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "as_is": [],
    "two_blocks": [("__launch_bounds__(kThreads, 1)",
                    "__launch_bounds__(kThreads, (C >= kWideCols ? 2 : 1))"),
                   ("C >= kWideCols ? 16 :", "C >= kWideCols ? 8 :")],
    "narrow": [("constexpr int64_t kWideFrom = 512;",
                "constexpr int64_t kWideFrom = INT64_MAX;")],
}
CASES = [(1000, 10, True), (1000, 1000, True), (1000, 4096, True),
         (1000, 4096, False), (1000, 100000, True)]


def build(name):
    """Compile one variant of the source alone; return (name, library, log)."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {SOURCE}")
        text = text.replace(old, new)
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = VARIANT_DIR / f"tri_solve_{name}.cu"
    src.write_text(text)
    out = VARIANT_DIR / f"libtri_solve_{name}.so"
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn_name in ("viabel_tri_solve_f32", "viabel_tri_solve_f64"):
        fn = getattr(lib, fn_name)
        fn.argtypes = _build._SIGNATURES[fn_name]
        fn.restype = ctypes.c_int
    return name, lib, proc.stdout + proc.stderr


def solve(lib, T, B, lower):
    """What ``ops.vmem_solve_triangular`` does on a CUDA float32 T."""
    X = torch.empty_like(B)
    T_cm = T.mT.contiguous()
    stream = torch.cuda.current_stream(T.device).cuda_stream
    _build.check(lib.viabel_tri_solve_f32(
        T_cm.data_ptr(), B.data_ptr(), X.data_ptr(), B.shape[0], B.shape[1],
        B.stride(0), B.stride(1), X.stride(0), X.stride(1), int(lower), stream),
        "tri_solve")
    return X


def cuda_ms(fn, reps=20):
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


def device_ms(fn, reps=20):
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
        print("time_tri_solve: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        builds = {name: (lib, log) for name, lib, log in pool.map(build, VARIANTS)}
    gen = torch.Generator("cuda").manual_seed(12)
    for d, S, lower in CASES:
        # tests/test_ops.py's recipe: tril(randn) + d I, transposed for upper
        T = torch.tril(torch.randn((d, d), generator=gen, device="cuda"))
        T += d * torch.eye(d, device="cuda")
        T = T if lower else T.T.contiguous()
        B = torch.randn((d, S), generator=gen, device="cuda")
        P = vmem_solve_triangular_plain(T, B, lower)
        fns = {"library": lambda: torch.linalg.solve_triangular(T, B, upper=not lower)}
        for name, (lib, _) in builds.items():
            rel = float((solve(lib, T, B, lower) - P).abs().max()) / float(P.abs().max())
            if not rel <= 1e-4:
                raise AssertionError(f"{name} ({d}, {S}) lower={lower}: max-norm rel err {rel}")
            fns[name] = lambda lib=lib: solve(lib, T, B, lower)
        times = " ".join(f"{name}={cuda_ms(fn):.4f}/{device_ms(fn):.4f}"
                         for name, fn in fns.items())
        print(f"[time] ({d}, {S}) {'lower' if lower else 'upper'} float32 ms "
              f"(events/device): {times}", flush=True)
        del T, B, P, fns
        torch.cuda.empty_cache()
    for name, (_, log) in builds.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "tri_solveIf" in line:  # float32
                print(f"[ptxas] {name} " + line.strip())
                for follow in lines[i + 1:i + 4]:
                    if "registers" in follow or "spill" in follow:
                        print(f"[ptxas] {name}   " + follow.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
