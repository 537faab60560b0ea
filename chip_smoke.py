"""Drive viabel_torch on one CUDA card: build the kernels, hold each against
its plain PyTorch version, run bbvi's adaptive path at the flagship width,
then vi_diagnostics on its result (the front door), the error-bounds branch
at width, and the README quickstart.

    python3 chip_smoke.py

Every phase raises on failure, so the process exits non-zero. Without a
CUDA device it exits non-zero at once and prints no result. The last line
of standard output is one JSON object; the line before it lists each
kernel's launches on the path that runs it, its error against the plain
version, its time, the plain version's, the library call's, and the least
time the card could take for the same work.
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
    "vmem_solve_triangular": ("viabel_torch/csrc/tri_solve.cu",
                              "viabel_tpu/ops/trsm.py:149"),
}
DEVICE = "cuda"
FLAGSHIP_DIM = 1000
N_DATA = 512
MAIN_PATH_ITERS = 2000
FLAGSHIP_LR = 0.001
N_DIAG_SAMPLES = 100000  # vi_diagnostics' default n_samples
#: NVIDIA H100 SXM data-sheet peaks: HBM bytes/s, and FLOP/s outside the
#: tensor cores by element type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


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


def bound(nbytes, flops, dtype):
    """Least milliseconds for ``nbytes`` of traffic and ``flops`` operations
    of ``dtype``, and which of the two sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def tri_solve_bound(d, S, dtype):
    """T's triangle and B read once, X written once; d^2 S FLOP (d(d-1)/2
    multiply-adds and d scalings per column)."""
    size = torch.finfo(dtype).bits // 8
    return bound((d * (d + 1) // 2 + 2 * d * S) * size, d * d * S, dtype)


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
            # the ring and center read once, GS and GQ written once; a
            # subtract, a square and two adds per element; no single
            # PyTorch call computes both sums
            size = ring.element_size()
            results["ring_group_stats"] = {
                "max_abs_err": max(err_s, err_q), "ms": ms, "plain_ms": plain_ms,
                **bound((R * D + D + 2 * (R // group) * D) * size, 4 * R * D, dtype),
                "library_ms": None}
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
    from viabel_torch.ops.trsm import cholesky_factor
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
            # the library call: cuBLAS's solve on the factor formed outside
            LT = cholesky_factor(theta32).T
            library_ms = cuda_ms(lambda: torch.linalg.solve_triangular(LT, B32, upper=True))
            log(f"[stl_transpose_solve] ({d}, {S}) float32 kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f}")
            if S == 10:
                results["stl_transpose_solve"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **tri_solve_bound(d, S, torch.float32), "library_ms": library_ms}


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
    for name in ("ring_group_stats", "stl_transpose_solve"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return res, objective


def triangle(d, lower, gen, dtype):
    """tests/test_ops.py's recipe: tril(randn) + d I, transposed for upper."""
    A = torch.tril(torch.randn((d, d), generator=gen, device=DEVICE, dtype=dtype))
    A += d * torch.eye(d, device=DEVICE, dtype=dtype)
    return A if lower else A.T.contiguous()


def check_solve(X, P, label):
    """Hold a solve against the plain version; return max_abs_err."""
    torch.cuda.synchronize()
    err = float((X - P).abs().max())
    rel = err / float(P.abs().max())
    if X.dtype == torch.float64:
        torch.testing.assert_close(X, P, rtol=1e-8, atol=1e-12)
    elif not rel <= 1e-4:  # also catches NaN
        raise AssertionError(f"vmem_solve_triangular f32 {label}: max-norm rel err {rel}")
    log(f"[tri_solve] {label} {X.dtype}: max_abs_err={err:.3e} maxnorm_rel_err={rel:.3e}")
    return err


def phase_tri_solve(results):
    """Kernel 3 against its plain version at the front door's shapes: the
    log weights' (d, n_samples), the KSD null scores' (d, 4096), bbvi-sized
    and vector right-hand sides; then the autograd adjoint."""
    from viabel_torch.families import _tri_solve
    from viabel_torch.ops import vmem_solve_triangular, vmem_solve_triangular_plain
    gen = torch.Generator(DEVICE).manual_seed(8)
    d0 = FLAGSHIP_DIM
    shapes = [(8, 3), (130, 5), (300, 7), (d0, 10), (d0, 1), (d0, 4096),
              (d0, N_DIAG_SAMPLES), (1536, 16)]
    for dtype in (torch.float64, torch.float32):
        for d, S in shapes:
            for lower in (True, False):
                T = triangle(d, lower, gen, dtype)
                B = torch.randn((d, S), generator=gen, device=DEVICE, dtype=dtype)
                X = vmem_solve_triangular(T, B, lower)
                P = vmem_solve_triangular_plain(T, B, lower)
                label = f"({d}, {S}) {'lower' if lower else 'upper'}"
                err = check_solve(X, P, label)
                if dtype == torch.float32 and lower and d == d0 and S in (10, 4096,
                                                                          N_DIAG_SAMPLES):
                    ms = cuda_ms(lambda: vmem_solve_triangular(T, B, True))
                    plain_ms = cuda_ms(lambda: vmem_solve_triangular_plain(T, B, True))
                    library_ms = cuda_ms(
                        lambda: torch.linalg.solve_triangular(T, B, upper=False))
                    b = tri_solve_bound(d, S, dtype)
                    log(f"[tri_solve] {label} float32 kernel_ms={ms:.4f} "
                        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                        f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']})")
                    if S == N_DIAG_SAMPLES:
                        results["vmem_solve_triangular"] = {
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                            "library_ms": library_ms}
                del T, B, X, P
    # the adjoint: dB (and dT where asked for) against autograd through
    # the plain version, at the KSD null scores' width
    for dtype in (torch.float64, torch.float32):
        for lower in (True, False):
            for needs_T in (False, True):
                T = triangle(d0, lower, gen, dtype).requires_grad_(needs_T)
                B = torch.randn((d0, 4096), generator=gen, device=DEVICE, dtype=dtype,
                                requires_grad=True)
                W = torch.randn((d0, 4096), generator=gen, device=DEVICE, dtype=dtype)
                inputs = (T, B) if needs_T else (B,)
                got = torch.autograd.grad(torch.sum(W * _tri_solve(T, B, lower)), inputs)
                want = torch.autograd.grad(
                    torch.sum(W * vmem_solve_triangular_plain(T, B, lower)), inputs)
                for name, g, w in zip(("dT", "dB") if needs_T else ("dB",), got, want):
                    check_solve(g, w, f"adjoint {name} ({d0}, 4096) "
                                f"{'lower' if lower else 'upper'}")
    torch.cuda.empty_cache()


def phase_front_door(res, objective, counts):
    """vi_diagnostics on the main path's result, as a user calls it."""
    import viabel_torch as vt
    from viabel_torch import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    diag = vt.vi_diagnostics(res["opt_param"], objective=objective,
                             generator=torch.Generator(DEVICE).manual_seed(6))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = ops.launch_counts()
    counts["vmem_solve_triangular"] = launches["vmem_solve_triangular"]
    khat = float(diag["khat"])
    ksd_branch = not math.isfinite(khat) or khat > 0.7
    log(f"[front_door] khat={khat:.4f} branch={'ksd' if ksd_branch else 'error_bounds'} "
        f"wall_s={wall:.3f} launches={launches} "
        f"max_memory_allocated_bytes={torch.cuda.max_memory_allocated()}")
    d = objective.approx.dim
    if diag["samples"].shape != (d, N_DIAG_SAMPLES):
        raise AssertionError(f"samples of shape {tuple(diag['samples'].shape)}")
    if not torch.isfinite(diag["smoothed_log_weights"]).all():
        raise AssertionError("non-finite smoothed log weights")
    if ksd_branch:
        if "d2" in diag or "ksd" not in diag:
            raise AssertionError("khat tripped the gate but the KSD test did not run")
        log(f"[front_door] ksd={float(diag['ksd']):.6g} p_value={diag['ksd_p_value']} "
            f"reject={diag['ksd_reject']} valid={diag['ksd_valid']}")
        if diag["ksd_valid"] and not math.isfinite(float(diag["ksd"])):
            raise AssertionError("a valid KSD test with a non-finite statistic")
    else:
        check_bounds(diag, "front_door")
    if counts["vmem_solve_triangular"] <= 0:
        raise AssertionError("vi_diagnostics never launched vmem_solve_triangular")


def check_bounds(diag, tag):
    if "ksd" in diag or "d2" not in diag:
        raise AssertionError(f"{tag}: khat passed the gate but the bounds did not run")
    names = ("d2", "W1", "W2", "mean_error", "std_error", "cov_error", "log_norm_bound")
    log(f"[{tag}] " + " ".join(f"{k}={float(diag[k]):.6g}" for k in names))
    if not all(math.isfinite(float(diag[k])) for k in names):
        raise AssertionError(f"{tag}: a non-finite bound")


def correlated_fit(s, rho=0.8):
    """The target N(0, Sigma) (AR(1) correlation ``rho``, d=1000, float32 on
    the card) and the FullRankGaussian q = N(0, s^2 Sigma) as a flat
    parameter, in float32 on the card and float64 on the CPU."""
    import numpy as np

    import viabel_torch as vt
    from viabel_torch.models import zoo
    d = FLAGSHIP_DIM
    model, _, _ = zoo.correlated_gaussian(dim=d, rho=rho, device=DEVICE,
                                          dtype=torch.float32)
    idx = np.arange(d)
    L = s * np.linalg.cholesky(rho ** np.abs(idx[:, None] - idx[None, :]))
    theta = np.tril(L, -1) + np.diag(np.log(np.diag(L)))
    vp64 = torch.as_tensor(np.concatenate([np.zeros(d), theta.reshape(-1)]))
    approx = vt.FullRankGaussian(d, device=DEVICE, dtype=torch.float32)
    return model, approx, vp64.to(device=DEVICE, dtype=torch.float32), vp64


def phase_error_bounds():
    """The well-fit branch at width: q = N(0, s^2 Sigma) against the target
    N(0, Sigma), s = 1.01."""
    import viabel_torch as vt
    from viabel_torch import ops
    from viabel_torch.models import zoo
    d, s, rho = FLAGSHIP_DIM, 1.01, 0.8
    model, approx, vp, vp64 = correlated_fit(s, rho)
    ops.reset_launch_counts()
    start = time.perf_counter()
    diag = vt.vi_diagnostics(vp, model=model, approx=approx,
                             generator=torch.Generator(DEVICE).manual_seed(7))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    khat, d2 = float(diag["khat"]), float(diag["d2"]) if "d2" in diag else math.nan
    # d2 = 2 (CUBO - ELBO) in closed form for q = N(0, s^2 Sigma), p = N(0, Sigma)
    analytic = d * math.log(s / math.sqrt(2.0 - 1.0 / s**2)) + d * (s**2 - 1.0
                                                                   - 2.0 * math.log(s))
    log(f"[error_bounds] khat={khat:.4f} d2={d2:.6f} analytic_d2={analytic:.6f} "
        f"wall_s={wall:.3f} launches={ops.launch_counts()}")
    check_bounds(diag, "error_bounds")
    # the weights are bounded (q is wider), so the true shape is <= 0; over
    # 40 seeds of this configuration in float64 on the CPU, khat ranged over
    # [-0.060, 0.106] and d2 over [0.3873, 0.3979] (sd 0.0019)
    if not khat < 0.3 or not abs(d2 - analytic) < 0.02:
        raise AssertionError(f"khat {khat} or d2 {d2} far from the analytic values")
    # the card's float32 log weights (kernel 3) against float64 on the CPU
    # (plain solve) for the first 20,000 of the same samples; float32 on the
    # CPU differs from float64 by 3.5e-4 at most over 2,000 samples
    x = diag["samples"].T[:20000].contiguous()
    lw = (model(x) - approx.log_density(vp, x)).double().cpu()
    model64, _, _ = zoo.correlated_gaussian(dim=d, rho=rho, device="cpu",
                                            dtype=torch.float64)
    approx64 = vt.FullRankGaussian(d, device="cpu", dtype=torch.float64)
    x64 = x.double().cpu()
    lw64 = model64(x64) - approx64.log_density(vp64, x64)
    err = float((lw - lw64).abs().max())
    log(f"[error_bounds] log weights, card float32 vs CPU float64: max_abs_err={err:.3e}")
    if not err <= 5e-3:
        raise AssertionError(f"card log weights off by {err}")


def phase_ksd_branch():
    """The gated branch at width: q = N(0, 0.9^2 Sigma) is narrower than the
    target, so the weights are heavy-tailed, khat trips and the KSD test
    scores 19 null replicates with q's own score, through kernel 3's
    adjoint: 1 + 2 x 19 launches."""
    import viabel_torch as vt
    from viabel_torch import ops
    model, approx, vp, _ = correlated_fit(0.9)
    ops.reset_launch_counts()
    start = time.perf_counter()
    diag = vt.vi_diagnostics(vp, model=model, approx=approx,
                             generator=torch.Generator(DEVICE).manual_seed(9))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = ops.launch_counts()["vmem_solve_triangular"]
    khat = float(diag["khat"])
    log(f"[ksd_branch] khat={khat:.4f} wall_s={wall:.3f} launches={launches}")
    if "ksd" not in diag or "d2" in diag:
        raise AssertionError("khat did not trip the gate at s = 0.9")
    log(f"[ksd_branch] ksd={float(diag['ksd']):.6g} p_value={diag['ksd_p_value']} "
        f"reject={diag['ksd_reject']} valid={diag['ksd_valid']}")
    if not diag["ksd_valid"] or not math.isfinite(float(diag["ksd"])):
        raise AssertionError("the KSD test is invalid at s = 0.9")
    if launches != 1 + 2 * 19:
        raise AssertionError(f"{launches} launches of kernel 3, expected 39")


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
    gen = torch.Generator(DEVICE).manual_seed(0)
    res = vt.bbvi(dim, log_density=model, learning_rate=0.5, n_iters=3000,
                  device=DEVICE, dtype=torch.float32, generator=gen)
    mu, log_sigma = res["objective"].approx.unpack(res["opt_param"])
    log(f"[quickstart] steps={int(res['value_history'].shape[0])} "
        f"mu={mu.tolist()} sigma={torch.exp(log_sigma).tolist()} "
        f"k_stopped_final={res['k_stopped_final']} launches={ops.launch_counts()}")
    if not torch.isfinite(res["opt_param"]).all():
        raise AssertionError("quickstart opt_param is not finite")
    if ops.launch_counts()["ring_group_stats"] <= 0:
        raise AssertionError("quickstart never reached ring_group_stats")
    # the README workflow: diagnose the fit
    diag = vt.vi_diagnostics(res["opt_param"], objective=res["objective"], generator=gen)
    log(f"[quickstart] khat={float(diag['khat']):.4f} "
        f"branch={'ksd' if 'ksd' in diag else 'error_bounds'}")
    if not torch.isfinite(diag["smoothed_log_weights"]).all():
        raise AssertionError("quickstart diagnostics: non-finite smoothed log weights")


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
    phase_tri_solve(results)
    res, objective = phase_main_path(counts)
    # the final iterate's factor block, for a float32 check of kernel 2
    d = FLAGSHIP_DIM
    theta = res["opt_param"][d:].reshape(d, d).contiguous()
    B = torch.randn((FLAGSHIP_DIM, 10), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    check_stl(theta, B, "(1000, 10) main-path theta")
    phase_front_door(res, objective, counts)
    del res, objective
    phase_error_bounds()
    phase_ksd_branch()
    phase_hmc_placement()
    phase_quickstart()
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": counts[name]}
        entry.update(results[name])
        kernels.append(entry)
    if not all(math.isfinite(k["ms"]) and math.isfinite(k["bound_ms"]) for k in kernels):
        raise AssertionError("a kernel was not timed")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
