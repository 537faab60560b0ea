"""How a number the program produced is held against the reference's.

Each comparison gives one number per name; ``judge`` sets each beside
its limit (``limits/<workload>.json``) and decides ``correct``.
"""

import math
import statistics

import torch


def rel_gap(prog, ref, floor=1.0):
    """``|prog - ref| / max(|ref|, floor)``; not finite where either is."""
    prog, ref = float(prog), float(ref)
    if not (math.isfinite(prog) and math.isfinite(ref)):
        return math.inf
    return abs(prog - ref) / max(abs(ref), floor)


def leaf_norms(vec, leaves):
    """``{leaf: norm}`` of a flat vector, in float64."""
    return {n: float(torch.linalg.vector_norm(vec[s].double())) for n, s in leaves.items()}


def norms_gap(prog, ref, skip=()):
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's. ``prog`` and ``ref`` map a leaf to its norm; leaves
    named in ``skip`` are left out."""
    median = statistics.median(ref.values())
    gaps = []
    for name, r in ref.items():
        if name in skip:
            continue
        if not math.isfinite(prog[name]):
            return math.inf
        gaps.append(abs(prog[name] - r) / max(r, median, 1e-300))
    return max(gaps)


def leaf_norm_gap(prog, ref, leaves, skip=()):
    """:func:`norms_gap` of two flat vectors; ``leaves`` maps a name to
    its slice."""
    return norms_gap(leaf_norms(prog, leaves), leaf_norms(ref, leaves), skip)


def quiet_leaves(grad, leaves, share=1e-3):
    """Leaves whose reference gradient norm is under ``share`` of the
    median leaf's: they move by round-off alone and are left out of the
    change."""
    norms = {n: float(torch.linalg.vector_norm(grad[s].double())) for n, s in leaves.items()}
    median = statistics.median(norms.values())
    return {n for n, v in norms.items() if v < share * median}


def judge(numbers, limits):
    """``(correct, rows)``: every number at or under its limit. A number
    without a limit, or a limit without a number, is not correct."""
    rows, correct = [], True
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name)
        limit = limits.get(name)
        ok = (value is not None and limit is not None and math.isfinite(value)
              and value <= limit)
        correct = correct and ok
        rows.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return correct, rows
