"""Readings that set a cell's limits: the program's compared numbers, the
control's and each planted fault's, seed by seed, at the cell's own size.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]
        [--seconds <s>] [--faults state_unchanged half_batch answer_altered]

The control is the reference put in the program's place one precision
below the configuration's (float32 with TF32 matrix products where the
configuration states float32), held against the float64 reference as
the program is. Each reading runs ``--seconds`` of the cell's traffic,
so that the reference has the window's last steps or calls to
recompute. One JSON line a reading. The
benchmark's own runs never run this; it needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time


def readings(cell, seed, seconds, device, planted=None, with_control=False):
    """``{"program": numbers[, "control": numbers]}`` of one seed."""
    from contextlib import nullcontext

    import torch

    from perfbench.harness import Run, _quiet
    from perfbench.program import System, generator_seed

    run = Run(cell, seed, device)
    with planted or nullcontext(), _quiet():
        run.generator = torch.Generator(run.device).manual_seed(generator_seed(seed))
        run.system = System(run.config, run.traffic, seed, run.device)
        run.kind.setup(run)
        run.kind.window(run, seconds)
    with _quiet():
        out = {"program": run.kind.verify(run)}
        if with_control:
            out["control"] = run.kind.control(run)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--faults", nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from perfbench.faults import FAULTS
    from perfbench.manifest import Cell, load_manifest

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(load_manifest(), args.workload)
    for seed in args.seeds:
        start = time.perf_counter()
        sides = readings(cell, seed, args.seconds, "cuda:0", with_control=True)
        for fault in args.faults:
            sides[fault] = readings(cell, seed, args.seconds, "cuda:0",
                                    planted=FAULTS[fault]())["program"]
        for side, numbers in sides.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "numbers": numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - start:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
