"""Drive viabel_torch on one CUDA card: build the kernels, hold each against
its plain PyTorch version, run bbvi's adaptive path at the flagship width,
and run the README quickstart.

    python3 chip_smoke.py

Every phase raises on failure, so the process exits non-zero. Without a
CUDA device it exits non-zero at once and prints no result. The last line
of standard output is one JSON object; the line before it lists each
kernel's launches on the main path, its error against the plain version
and both times.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch

KERNEL_SOURCES = {
    "ring_group_stats": ("viabel_torch/csrc/ringstats.cu",
                         "viabel_tpu/ops/ringstats.py:34"),
    "stl_transpose_solve": ("viabel_torch/csrc/stl_solve.cu",
                            "viabel_tpu/ops/trsm.py:185"),
}
DEVICE = "cuda"
FLAGSHIP_DIM = 1000
N_DATA = 512
MAIN_PATH_ITERS = 2000
FLAGSHIP_LR = 0.001


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``reps`` calls, each timed with CUDA events."""
    for _ in range(warmup):
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


def phase_build():
    from viabel_torch import ops
    start = time.perf_counter()
    ops.load_library()
    info = ops.build_info()
    log(f"[build] library {info['path']} built={info['built']} "
        f"nvcc_seconds={info['seconds']:.3f} "
        f"load_seconds={time.perf_counter() - start:.3f}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("[build] " + line.strip())


def phase_ring_stats(results):
    from viabel_torch.ops import ring_group_stats, ring_group_stats_plain
    gen = torch.Generator("cuda").manual_seed(1)
    cases = [(600, FLAGSHIP_DIM + FLAGSHIP_DIM ** 2, 50, torch.float32),
             (64, 1000, 8, torch.float64), (40, 7, 8, torch.float32),
             (40, 7, 8, torch.float64)]
    for R, D, group, dtype in cases:
        ring = torch.randn((R, D), generator=gen, device="cuda", dtype=dtype)
        ring += 10.0
        center = ring[R - 1]
        GS, GQ = ring_group_stats(ring, center, group)
        PS, PQ = ring_group_stats_plain(ring, center, group)
        torch.cuda.synchronize()
        scale = float((ring - center).abs().max())
        err_s = float((GS - PS).abs().max())
        err_q = float((GQ - PQ).abs().max())
        if dtype == torch.float64:
            # rtol 1e-12, with a floor scaled to the summands for near-zero sums
            torch.testing.assert_close(GS, PS, rtol=1e-12, atol=1e-12 * group * scale)
            torch.testing.assert_close(GQ, PQ, rtol=1e-12, atol=1e-12 * group * scale ** 2)
        else:
            # float32 sums of `group` terms in another order
            if err_s > 1e-5 * group * scale or err_q > 1e-5 * group * scale ** 2:
                raise AssertionError(f"ring_group_stats f32 ({R},{D}) g={group}: "
                                     f"err GS {err_s} GQ {err_q} scale {scale}")
        line = (f"[ring_group_stats] ({R}, {D}) group={group} {dtype}: "
                f"max_abs_err GS={err_s:.3e} GQ={err_q:.3e}")
        if R == 600:
            ms = cuda_ms(lambda: ring_group_stats(ring, center, group))
            plain_ms = cuda_ms(lambda: ring_group_stats_plain(ring, center, group))
            gbps = R * D * ring.element_size() / (ms * 1e-3) / 1e9
            line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} kernel_GB/s={gbps:.1f}"
            results["ring_group_stats"] = {"max_abs_err": max(err_s, err_q),
                                           "ms": ms, "plain_ms": plain_ms}
        log(line)
        del ring, GS, GQ, PS, PQ
    torch.cuda.empty_cache()


def check_stl(theta, B, label):
    """Hold the kernel against the plain version; return (max_abs_err, rel)."""
    from viabel_torch.ops import stl_transpose_solve, stl_transpose_solve_plain
    X = stl_transpose_solve(theta, B)
    P = stl_transpose_solve_plain(theta, B)
    torch.cuda.synchronize()
    err = float((X - P).abs().max())
    rel = err / float(P.abs().max())
    if theta.dtype == torch.float64:
        torch.testing.assert_close(X, P, rtol=1e-8, atol=1e-12)
    elif not rel <= 1e-4:  # also catches NaN
        raise AssertionError(f"stl_transpose_solve f32 {label}: max-norm rel err {rel}")
    log(f"[stl_transpose_solve] {label} {theta.dtype}: max_abs_err={err:.3e} "
        f"maxnorm_rel_err={rel:.3e}")
    return err, rel


def phase_stl(results):
    from viabel_torch.ops import stl_transpose_solve, stl_transpose_solve_plain
    gen = torch.Generator("cuda").manual_seed(2)
    shapes = [(8, 3), (130, 5), (1000, 10), (1000, 400), (1536, 16)]
    for d, S in shapes:
        # tests/test_ops.py:59-72 recipe in float64
        theta = torch.randn((d, d), generator=gen, device="cuda", dtype=torch.float64)
        B = torch.randn((d, S), generator=gen, device="cuda", dtype=torch.float64)
        check_stl(theta, B, f"({d}, {S})")
        theta32 = 0.1 * torch.randn((d, d), generator=gen, device="cuda")
        B32 = torch.randn((d, S), generator=gen, device="cuda")
        err, _ = check_stl(theta32, B32, f"({d}, {S})")
        if d == FLAGSHIP_DIM:
            ms = cuda_ms(lambda: stl_transpose_solve(theta32, B32))
            plain_ms = cuda_ms(lambda: stl_transpose_solve_plain(theta32, B32))
            log(f"[stl_transpose_solve] ({d}, {S}) float32 kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f}")
            if S == 10:
                results["stl_transpose_solve"] = {"max_abs_err": err, "ms": ms,
                                                  "plain_ms": plain_ms}


def phase_main_path(counts):
    import viabel_torch as vt
    from viabel_torch import ExclusiveKL, FullRankGaussian, ops
    from viabel_torch.models import zoo
    d = FLAGSHIP_DIM
    model, _ = zoo.logistic_regression(dim=d, n_data=N_DATA, device=DEVICE,
                                       dtype=torch.float32)
    approx = FullRankGaussian(d, device=DEVICE, dtype=torch.float32)
    objective = ExclusiveKL(approx, model, 10, use_path_deriv=True)
    gen = torch.Generator(DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    # bench.py's flagship learning rate: at bbvi's default 0.01 the JAX
    # package's own d=1000 full-rank STL run diverges as well (its loss
    # rises over the first 1,000 steps), so a falling loss needs 0.001
    res = vt.bbvi(d, objective=objective, n_iters=MAIN_PATH_ITERS,
                  learning_rate=FLAGSHIP_LR, RMS_kwargs=dict(diagnostics=False),
                  RAABBVI_kwargs=dict(max_history=600), generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts.update(ops.launch_counts())
    values = res["value_history"]
    steps = int(values.shape[0])
    log(f"[main] steps={steps} rounds={len(res['k_mcse']) - 1} wall_s={wall:.3f} "
        f"steps_per_s={steps / wall:.2f} "
        f"max_memory_allocated_bytes={torch.cuda.max_memory_allocated()}")
    for rnd, verdicts in enumerate(res["rhat_verdicts"]):
        for k, window, stat, passed in verdicts:
            log(f"[main] round {rnd} R-hat verdict k={k} window={window} "
                f"max_rhat={stat:.4f} passed={passed}")
    log(f"[main] k_conv per round={res['k_conv']} k_Rhat={res['k_Rhat']} "
        f"k_mcse={res['k_mcse']}")
    log(f"[main] num_mc_samples={objective.num_mc_samples} "
        f"escalations={res['mc_escalation_history'].tolist()}")
    log(f"[main] launches={counts}")
    k_check = 200
    first = float(values[:k_check].mean())
    last = float(values[-k_check:].mean())
    log(f"[main] first_segment_avg_loss={first:.6f} last_segment_avg_loss={last:.6f}")
    if not torch.isfinite(values).all():
        raise AssertionError("non-finite loss on the main path")
    opt_param = res["opt_param"]
    if opt_param.shape != (d + d * d,) or not torch.isfinite(opt_param).all():
        raise AssertionError("opt_param is not finite of shape (d + d^2,)")
    if not last < first:
        raise AssertionError(f"loss did not fall: first {first} last {last}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    # the final iterate's factor block, for phase 3's float32 check
    return opt_param[d:].reshape(d, d).contiguous()


def phase_hmc_placement():
    """Time one RAABBVI weighted regression (4 chains x 1000 HMC
    iterations x 24 leapfrog steps) on the card and on the host."""
    from viabel_torch import RAABBVI, RMSProp
    raabbvi = RAABBVI(RMSProp(0.01), rho=0.5)
    rng = torch.Generator().manual_seed(3)
    x = torch.log(torch.tensor([0.1, 0.05, 0.025, 0.0125], dtype=torch.float64))
    y = 1.5 + 0.9 * x + 0.1 * torch.randn(4, generator=rng, dtype=torch.float64)
    for device in (DEVICE, "cpu"):
        gen = torch.Generator(device).manual_seed(4)
        start = time.perf_counter()
        _, kappa, c = raabbvi.weighted_linear_regression(
            y.numpy(), x.numpy(), generator=gen, device=device)
        if device == DEVICE:
            torch.cuda.synchronize()
        log(f"[hmc] device={device} seconds={time.perf_counter() - start:.3f} "
            f"kappa={kappa:.4f} c={c:.4f}")


def phase_quickstart():
    import viabel_torch as vt
    from viabel_torch import ops
    from viabel_torch.models import zoo
    model, dim = zoo.funnel()
    ops.reset_launch_counts()
    res = vt.bbvi(dim, log_density=model, learning_rate=0.5, n_iters=3000,
                  device=DEVICE, dtype=torch.float32,
                  generator=torch.Generator(DEVICE).manual_seed(0))
    mu, log_sigma = res["objective"].approx.unpack(res["opt_param"])
    log(f"[quickstart] steps={int(res['value_history'].shape[0])} "
        f"mu={mu.tolist()} sigma={torch.exp(log_sigma).tolist()} "
        f"k_stopped_final={res['k_stopped_final']} launches={ops.launch_counts()}")
    if not torch.isfinite(res["opt_param"]).all():
        raise AssertionError("quickstart opt_param is not finite")
    if ops.launch_counts()["ring_group_stats"] <= 0:
        raise AssertionError("quickstart never reached ring_group_stats")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    results, counts = {}, {}
    phase_build()
    phase_ring_stats(results)
    phase_stl(results)
    theta = phase_main_path(counts)
    B = torch.randn((FLAGSHIP_DIM, 10), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    check_stl(theta, B, "(1000, 10) main-path theta")
    phase_hmc_placement()
    phase_quickstart()
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": counts[name]}
        entry.update(results[name])
        kernels.append(entry)
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel was not timed")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
