"""FSDPFullRankELBO over the cards of one host, one rank a card under
``torchrun`` (NCCL).

    torchrun --nproc_per_node=4 tools/time_fsdp.py [OUT.json]

1. Parity at the flagship width (logistic regression d = 1000, n = 512,
   S = 10, f32, lr 0.001): ``CHECK_STEPS`` steps of the trainer on a
   (fsdp=P,) mesh against the unsharded ``ExclusiveKL(FullRankGaussian)``
   + ``RMSProp`` steps on rank 0, on one table of draws; the largest
   parameter difference and the last value's.
2. Time at d = 30,000 (S = 10, lr 2e-5, init_log_diag -2): the trainer
   on (fsdp=P,), plain and ``gather_pipeline=2`` in alternating runs of
   ``TIME_STEPS`` steps after ``WARMUP`` steps, then the one-rank trainer
   on rank 0 alone (a one-rank subgroup) the same way: device ms a step
   by CUDA events (rank 0's), steps/s by the host clock, peak memory.

Prints the card's name and power limit and one line a measurement, and
writes the numbers as JSON to ``OUT.json`` when a path is given.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import viabel_torch as vt  # noqa: E402
from viabel_torch.parallel import FSDPFullRankELBO, distributed_init, make_mesh  # noqa: E402

CHECK_DIM, CHECK_STEPS, CHECK_LR = 1000, 500, 0.001
BIG_DIM, BIG_LR, BIG_LOG_DIAG = 30000, 2e-5, -2.0
S, N_DATA, WARMUP, TIME_STEPS, PAIRS = 10, 512, 3, 30, 2


class Solo:
    """A one-rank ``fsdp`` mesh over a one-rank subgroup."""

    mesh_dim_names = ("fsdp",)
    device_type = "cuda"

    def __init__(self, group):
        self.group = group

    def size(self, dim=None):
        return 1

    def get_local_rank(self, name=None):
        return 0

    def get_group(self, name=None):
        return self.group


class StepTable:
    """Base sampler handing out block ``k`` of a ``(steps, S, d)`` table at
    its ``k``-th call."""

    def __init__(self, table):
        self.table, self.pos = table, 0

    def normal(self, generator, n_samples, width, dtype, device):
        self.pos += 1
        return self.table[self.pos - 1, :n_samples, :width].to(device=device, dtype=dtype)


def log(*args):
    if dist.get_rank() == 0:
        print(*args, flush=True)


def parity(mesh, P):
    d = CHECK_DIM
    model = vt.zoo.logistic_regression(dim=d, n_data=N_DATA, device="cuda",
                                       dtype=torch.float32)[0]
    table = torch.randn((CHECK_STEPS, S, d), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(98))
    trainer = FSDPFullRankELBO(d, model, S, mesh, learning_rate=CHECK_LR)
    params = trainer.init_params()
    state = trainer.init_opt_state(params)
    for k in range(CHECK_STEPS):
        params, state, value = trainer.step(params, state, draws=table[k])
    mu, theta = trainer.gather_params(params)
    out = None
    if dist.get_rank() == 0:
        family = vt.FullRankGaussian(d, base_sampler=StepTable(table), device="cuda",
                                     dtype=torch.float32)
        objective, sgo = vt.ExclusiveKL(family, model, S), vt.RMSProp(CHECK_LR)
        x = family.init_param()
        st = sgo.init_state(x)
        for _ in range(CHECK_STEPS):
            x, st, _, v, _, _ = sgo.step(objective, x, st, {}, None, CHECK_LR)
        out = {"mu": float((mu - x[:d]).abs().max()),
               "theta": float((theta - x[d:].view(d, d)).abs().max()),
               "value": abs(float(value) - float(v)), "final_value": float(value)}
        log(f"[parity] d={d} P={P} steps={CHECK_STEPS}: against the unsharded step "
            f"max_abs_diff mu={out['mu']:.3e} theta={out['theta']:.3e} "
            f"last_value={out['value']:.3e} (value {out['final_value']:.4f})")
    dist.barrier()
    return out


def timed(trainer, gen, steps):
    """``steps`` steps; rank 0's device ms a step (median), wall s."""
    params = trainer.init_params()
    state = trainer.init_opt_state(params)
    for _ in range(WARMUP):
        params, state, _ = trainer.step(params, state, gen)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(steps)]
    values = torch.empty(steps, device="cuda")
    torch.cuda.synchronize()
    start = time.perf_counter()
    for k in range(steps):
        events[k][0].record()
        params, state, values[k] = trainer.step(params, state, gen)
        events[k][1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if not torch.isfinite(values).all():
        raise AssertionError("non-finite value")
    return statistics.median(a.elapsed_time(b) for a, b in events), wall


def main():
    distributed_init()
    P, rank = dist.get_world_size(), dist.get_rank()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} ranks={P}")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((P,), ("fsdp",))
    report = {"card": smi, "ranks": P, "parity": parity(mesh, P), "runs": []}
    model = vt.zoo.logistic_regression(dim=BIG_DIM, n_data=N_DATA, device="cuda",
                                       dtype=torch.float32)[0]
    solo = dist.new_group([0])

    def run(name, mesh, pipeline):
        trainer = FSDPFullRankELBO(BIG_DIM, model, S, mesh, learning_rate=BIG_LR,
                                   init_log_diag=BIG_LOG_DIAG, gather_pipeline=pipeline)
        torch.cuda.reset_peak_memory_stats()
        ms, wall = timed(trainer, torch.Generator("cuda").manual_seed(99), TIME_STEPS)
        row = {"run": name, "device_ms_per_step": ms, "steps_per_s": TIME_STEPS / wall,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        log(f"[time] d={BIG_DIM} {name}: device_ms_per_step={ms:.3f} "
            f"steps_per_s={row['steps_per_s']:.3f} max_memory_allocated_bytes="
            f"{row['max_memory_allocated_bytes']} (rank 0) card={smi!r}")
        report["runs"].append(row)
        del trainer
        torch.cuda.empty_cache()

    for _ in range(PAIRS):
        run(f"fsdp={P} plain", mesh, None)
        run(f"fsdp={P} gather_pipeline=2", mesh, 2)
    if rank == 0:
        for _ in range(PAIRS):
            run("fsdp=1 (rank 0 alone)", Solo(solo), None)
    dist.barrier()
    if rank == 0 and len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(report, f, indent=1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
