"""Run one cell of the benchmark once on this machine's CUDA cards.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` the ``breakdown``), then the compared numbers beside their
limits under ``checks``; the same numbers are the last lines of standard
error. Exits non-zero, with no result, where there is no CUDA card or
fewer than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or
``viabel_tpu`` was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from perfbench.harness import forbidden_modules, run_cell
    from perfbench.manifest import Cell, load_manifest

    cell = Cell(load_manifest(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards; {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        return 2
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device="cuda:0", started=STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for row in rows:
        print(f"check {row['name']}: {row['value']!r} limit {row['limit']!r} "
              f"{'ok' if row['ok'] else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
