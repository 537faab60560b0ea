"""The check of a fit's first steps, shared by the kinds that fit.

Set-up drives the window's own call, ``bbvi`` as the configuration states
it, from the run's generator through one step and, from the same
generator state again, through three. The first run's RMSProp state is
the first gradient squared; the second gives each step's loss and the
parameters that step 4 would start from. The reference follows the same
three steps in float64 on the same base normals, which it draws itself
from a generator set to the same state.
"""

import torch

from .. import compare, reference
from ..program import data_seed
from ..reference import fit as ref_fit


def drive(run):
    """The program's side, in set-up: readings kept in ``run.check``."""
    system, gen = run.system, run.generator
    start = gen.get_state()
    one = system.fit(gen, n_iters=1)
    first_grad_sq = one["resume_state"]["flight"]["opt_state"]["avg_grad_sq"].detach().clone()
    del one
    gen.set_state(start)
    three = system.fit(gen, n_iters=3)
    run.check.update(
        start_state=start,
        first_grad_sq=first_grad_sq,
        losses=[float(v) for v in three["value_history"][:3]],
        third=three["resume_state"]["flight"]["var_param"].detach().clone())
    del three
    return start


def base_draws(system, generator_state, samples, first=0):
    """The base normals of steps drawing ``samples[i]`` each, from a
    generator in ``generator_state``: one ``(S, d)`` block a step, yielded
    from step ``first`` on."""
    gen = torch.Generator(system.device)
    gen.set_state(generator_state)
    for i, S in enumerate(samples):
        z = torch.randn((int(S), system.dim), generator=gen, dtype=system.dtype,
                        device=system.device)
        if i >= first:
            yield z


def reference_steps(run, dtype):
    """The reference's three steps in ``dtype``."""
    cfg, system = run.config, run.system
    log_p = reference.model(cfg, data_seed(run.seed), dtype, system.device)
    family = reference.family(cfg, system.dim)
    rms = dict(system.bbvi_kw.get("RMS_kwargs", {}))
    out = ref_fit.first_steps(
        family, log_p, base_draws(system, run.check["start_state"], [system.num_mc_samples] * 3),
        stl=system.stl,
        lr=float(system.bbvi_kw["learning_rate"]), beta=float(rms.get("beta", 0.9)),
        jitter=float(rms.get("jitter", 1e-8)), dtype=dtype, device=system.device)
    out["leaves"] = family.leaves()
    return out


def numbers(run, side, ref):
    """The gaps between ``side`` (the program's readings, or the
    control's) and the float64 reference ``ref``."""
    leaves = ref["leaves"]
    quiet = compare.quiet_leaves(ref["first_grad"], leaves)
    return {
        "loss_gap": max(compare.rel_gap(p, r) for p, r in zip(side["losses"], ref["losses"])),
        "first_grad_gap": compare.leaf_norm_gap(side["first_grad"], ref["first_grad"], leaves),
        "change_gap": compare.leaf_norm_gap(side["end"] - ref["start"],
                                            ref["end"] - ref["start"], leaves, skip=quiet),
    }


def verify(run):
    ref = reference_steps(run, torch.float64)
    program = {"losses": run.check["losses"],
               "first_grad": torch.sqrt(run.check["first_grad_sq"]),
               "end": run.check["third"]}
    return numbers(run, program, ref), ref


def control(run, ref):
    """The control: the reference in the program's place, one precision
    below the configuration's (float32 with TF32 matrix products for a
    float32 configuration), held against the float64 reference."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = reference_steps(run, run.system.dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return numbers(run, low, ref)
