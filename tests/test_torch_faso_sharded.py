"""``FASO(mesh=..., shard_axis="mc")``: the history ring's columns split
over two gloo ranks on the CPU, in float64, against the port's FASO
without a mesh on the same ranks (to the bit) and the JAX package's
``FASO(mesh=...)`` over two of its virtual CPU devices (decisions equal,
``opt_param`` to rtol 1e-8); and a sharded run saved at a segment boundary
with ``save_pytree_orbax``, loaded and resumed, against the uninterrupted
run.

Each multi-rank test starts its own ranks as ``python -c`` children built
from this module's helpers (JAX blocked in them), one process group a test
on a file store under ``tmp_path``, joined with a timeout
(tests/test_torch_mc_sharded.py's pattern). Rank ``r`` draws its slice of
each ``S``-row block of one numpy table through the family's
``base_sampler``; the JAX run draws whole blocks of the same table.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import viabel_tpu as vj  # noqa: E402
from test_torch_faso import StreamNormal, fixed_clocks  # noqa: E402,F401
from test_torch_mc_sharded import SliceNormal  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the parent's join on the ranks; a deadlocked collective fails here
JOIN_TIMEOUT_S = 120
DIM, S, N_ITERS = 5, 10, 1500
#: (family, rhat_quantile): the max gate and the quantile gate on a
#: full-rank family, and a mean-field family whose 10 columns split
#: [0, 4) | [4, 10), so mu column 0 and its log_sigma column 5 lie on
#: different ranks and the MCSE check's scaling crosses them
CASES = {"full_rank_max": ("full_rank", None), "full_rank_quantile": ("full_rank", 0.9),
         "mean_field_mcse": ("mean_field", None)}
FASO_KW = dict(W_min=100, k_check=50, mcse_threshold=0.05)


def run_ranks(tmp_path, source, spec, world=2):
    """``world`` ranks of one process group running ``source`` on
    ``spec``, joined with a timeout; returns each rank's saved results."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
    procs = []
    for rank in range(world):
        args = dict(spec, rank=rank, world=world, store=str(tmp_path / "store"),
                    tmp=str(tmp_path), out=str(tmp_path / f"rank{rank}.pt"))
        procs.append(subprocess.Popen([sys.executable, "-c", source, json.dumps(args)],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=JOIN_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errors, "\n".join(errors)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def child_source(*helpers):
    """A rank program: JAX blocked, the stubbed MCSE clock of the port's
    FASO, ``helpers``' source, then ``child_main`` on the spec."""
    return "\n".join([
        "import sys",
        "sys.modules['jax'] = None  # a rank never imports JAX",
        "import json",
        "import numpy as np",
        "import torch",
        "torch.set_num_threads(1)",
        "import viabel_torch as vt",
        "import viabel_torch.faso as tfaso",
        *(inspect.getsource(h) for h in (FixedTimer, FakeClock, stub_clocks) + helpers),
        "stub_clocks()",
        "child_main(json.loads(sys.argv[1]))",
        "assert not any(m == 'viabel_tpu' or m.startswith('viabel_tpu.') for m in sys.modules)",
    ])


class FixedTimer:
    """A negligible MCSE cost: the recheck growth sits at its 1.05 floor."""

    interval = 1e-9

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FakeClock:
    t = 0.0

    @classmethod
    def now(cls):
        cls.t += 1.0
        return cls.t


def stub_clocks(*modules):
    import viabel_torch.faso as tfaso
    import viabel_torch.parallel.multistart as tms
    import viabel_torch.parallel.raabbvi as trb
    for mod in (tfaso, tms, trb) + modules:
        mod.Timer = FixedTimer
        mod._now = FakeClock.now


def faso_case(case, table, rank, world, mesh, faso_mesh):
    """One case's objective (MC samples sharded over ``mesh``'s ``mc``
    axis, rank ``rank`` drawing its slice of the table) and its FASO run,
    with the ring split over ``faso_mesh`` (None: unsharded)."""
    import viabel_torch as vt
    from viabel_torch.parallel import ShardedExclusiveKL
    f64 = dict(device="cpu", dtype=torch.float64)
    family_name, quantile = CASES[case]
    sampler = SliceNormal(table, rank, world)
    family = (vt.FullRankGaussian if family_name == "full_rank" else vt.MFGaussian)(
        DIM, base_sampler=sampler, **f64)
    model = vt.zoo.logistic_regression(dim=DIM, n_data=40, **f64)[0]
    objective = ShardedExclusiveKL(family, model, S, mesh)
    x0 = torch.zeros(family.var_param_dim, **f64)
    FakeClock.t = 0.0
    res = vt.FASO(vt.RMSProp(0.05), mesh=faso_mesh, rhat_quantile=quantile,
                  **FASO_KW).optimize(N_ITERS, objective, x0,
                                      generator=torch.Generator().manual_seed(0))
    return {"opt_param": res["opt_param"].numpy(), "k_conv": res["k_conv"],
            "k_Rhat": res["k_Rhat"], "k_stopped": res["k_stopped"],
            "rhat_verdicts": res["rhat_verdicts"], "draws": sampler.pos,
            "ring_columns": res["resume_state"].get("ring_columns")}


class NoisyQuadratic:
    """``0.5 |x - 1|^2`` with a standard normal gradient noise drawn from
    the generator: an objective of any width ``D``."""

    def value_and_grad(self, x, generator):
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype)
        return 0.5 * torch.sum((x - 1.0) ** 2), x - 1.0 + noise

    def update(self, x, step):
        return x - step


def narrow_run(mesh):
    """FASO on a 3- and a 1-column objective, max and quantile gate, with
    the ring split over ``mesh`` (the even split; at D = 1 rank 0's shard
    has no column) and without; kernel 1's wrapper counted."""
    import viabel_torch as vt
    import viabel_torch.mc_diagnostics as md
    calls = []
    plain = md.ring_group_stats

    def counted(ring, center, group):
        calls.append(ring.shape[1])
        return plain(ring, center, group)

    md.ring_group_stats = counted
    out = {}
    for D in (3, 1):
        for quantile in (None, 0.9):
            runs = {}
            for name, faso_mesh in (("sharded", mesh), ("plain", None)):
                FakeClock.t = 0.0
                calls.clear()
                res = vt.FASO(vt.RMSProp(0.05), mesh=faso_mesh, rhat_quantile=quantile,
                              **FASO_KW).optimize(
                    1500, NoisyQuadratic(), torch.zeros(D, dtype=torch.float64),
                    generator=torch.Generator().manual_seed(2))
                runs[name] = {"opt_param": res["opt_param"].numpy(),
                              "k_conv": res["k_conv"], "k_stopped": res["k_stopped"],
                              "rhat_verdicts": res["rhat_verdicts"],
                              "ring_columns": res["resume_state"].get("ring_columns"),
                              "kernel_widths": list(calls)}
            out[(D, quantile)] = runs
    md.ring_group_stats = plain
    return out


def child_main(spec):
    """One rank: the spec's FASO cases with and without the ring split,
    the narrow objectives, or the checkpointed resume."""
    import torch.distributed as dist
    from viabel_torch.parallel import distributed_init, make_mesh
    rank, world = spec["rank"], spec["world"]
    distributed_init("file://" + spec["store"], world_size=world, rank=rank,
                     backend="gloo", device_type="cpu")
    mesh = make_mesh(device_type="cpu")
    out = {}
    if spec.get("narrow"):
        out = narrow_run(mesh)
    elif "case" in spec:
        table = np.load(spec["table"])
        out["sharded"] = faso_case(spec["case"], table, rank, world, mesh, mesh)
        out["plain"] = faso_case(spec["case"], table, rank, world, mesh, None)
    else:
        out = resume_run(spec, mesh)
    torch.save(out, spec["out"])
    dist.destroy_process_group()


def resume_run(spec, mesh):
    """A sharded FASO run (real draws, MC samples and ring split over the
    mesh) stopped at ``k_stop``, saved with ``save_pytree_orbax``, loaded
    with its own state as the template and resumed, beside the
    uninterrupted run."""
    import time

    import viabel_torch as vt
    from viabel_torch.checkpoint import load_pytree_orbax, save_pytree_orbax
    from viabel_torch.parallel import ShardedExclusiveKL
    f64 = dict(device="cpu", dtype=torch.float64)
    family = vt.FullRankGaussian(DIM, **f64)
    model = vt.zoo.logistic_regression(dim=DIM, n_data=40, **f64)[0]
    objective = ShardedExclusiveKL(family, model, S, mesh)
    x0 = torch.zeros(family.var_param_dim, **f64)
    kw = dict(max_history=600, mesh=mesh, **FASO_KW)

    def run(n_iters, resume_state=None):
        FakeClock.t = 0.0
        return vt.FASO(vt.RMSProp(0.05), **kw).optimize(
            n_iters, objective, x0, generator=torch.Generator().manual_seed(4),
            resume_state=resume_state)

    full = run(spec["n_iters"])
    first = run(spec["k_stop"])
    # the ring split alone (every rank steps the whole objective), for a
    # load by one process
    FakeClock.t = 0.0
    split = vt.FASO(vt.RMSProp(0.05), **kw).optimize(
        spec["k_stop"], vt.ExclusiveKL(family, model, S), x0,
        generator=torch.Generator().manual_seed(4))
    save_pytree_orbax(spec["tmp"] + "/ckpt_split", split["resume_state"])
    path = spec["tmp"] + "/ckpt"
    t0 = time.perf_counter()
    save_pytree_orbax(path, first["resume_state"])
    saved_s = time.perf_counter() - t0
    state = load_pytree_orbax(path, like=first["resume_state"])
    resumed = run(spec["n_iters"], resume_state=state)
    return {"full": {k: full[k] for k in ("opt_param", "k_conv", "k_stopped", "rhat_verdicts")},
            "resumed": {k: resumed[k] for k in ("opt_param", "k_conv", "k_stopped",
                                                "rhat_verdicts")},
            "ring_width": int(first["resume_state"]["ring"].shape[1]),
            "ring_equal": bool(torch.equal(state["ring"], first["resume_state"]["ring"])),
            "files": sorted(os.listdir(path)), "saved_s": saved_s}


CHILD_SOURCE = child_source(SliceNormal, faso_case, NoisyQuadratic, narrow_run, resume_run,
                            child_main).replace(
    "import viabel_torch as vt\n",
    "import os\nimport viabel_torch as vt\n"
    f"DIM, S, N_ITERS = {DIM}, {S}, {N_ITERS}\nCASES = {CASES!r}\nFASO_KW = {FASO_KW!r}\n", 1)


def jax_faso(case, table):
    """The JAX package's FASO(mesh=...) over two virtual CPU devices on
    the whole blocks of the table."""
    family_name, quantile = CASES[case]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("mc",))
    sampler = StreamNormal(table)
    family = (vj.FullRankGaussian if family_name == "full_rank" else vj.MFGaussian)(
        DIM, base_sampler=sampler)
    model = vj.zoo.logistic_regression(dim=DIM, n_data=40)[0]
    objective = vj.ExclusiveKL(family, model, S)
    res = vj.FASO(vj.RMSProp(0.05), mesh=mesh, shard_axis="mc", rhat_quantile=quantile,
                  **FASO_KW).optimize(N_ITERS, objective,
                                      jax.numpy.zeros(family.var_param_dim))
    return res, sampler


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_faso_matches_unsharded_and_jax(tmp_path, fixed_clocks, case):  # noqa: F811
    """Over two ranks the ring split changes nothing: opt_param, k_conv,
    k_stopped and every R-hat verdict equal the unsharded FASO's on the
    same ranks to the bit, on both ranks; the decisions equal the JAX
    package's FASO(mesh=...) and opt_param agrees to rtol 1e-8."""
    table = np.random.RandomState(7).randn(S * N_ITERS, 2 * DIM)
    np.save(tmp_path / "table.npy", table)
    ranks = run_ranks(tmp_path, CHILD_SOURCE, dict(case=case, table=str(tmp_path / "table.npy")))
    for r in ranks:
        sharded, plain = r["sharded"], r["plain"]
        np.testing.assert_array_equal(sharded["opt_param"], plain["opt_param"])
        for name in ("k_conv", "k_Rhat", "k_stopped", "rhat_verdicts", "draws"):
            assert sharded[name] == plain[name], name
        np.testing.assert_array_equal(sharded["opt_param"], ranks[0]["sharded"]["opt_param"])
    width = 2 * DIM if CASES[case][0] == "mean_field" else DIM + DIM * DIM
    columns = [list(r["sharded"]["ring_columns"]) for r in ranks]
    assert columns[0][0] == 0 and columns[0][1] == columns[1][0] and columns[1][1] == width
    assert columns[0][1] % 2 == 0  # 16 bytes of float64
    got = ranks[0]["sharded"]
    assert got["k_stopped"] is not None
    res_j, smp_j = jax_faso(case, table)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert got[name] == res_j[name], name
    assert got["draws"] == smp_j.pos
    np.testing.assert_allclose(got["opt_param"], np.asarray(res_j["opt_param"]),
                               rtol=1e-8, atol=1e-12)
    if case == "mean_field_mcse":
        assert columns[0][1] <= DIM < columns[1][1]  # mu 0 and log_sigma 0 split
        assert got["k_stopped"] > got["k_Rhat"]  # the MCSE check decided the stop


def test_sharded_faso_checkpoint_resume(tmp_path, fixed_clocks):  # noqa: F811
    """A sharded FASO run stopped at k = 400 (verdicts in flight), saved
    with save_pytree_orbax (each rank its own ring shard, one file a
    rank), loaded with its state as the template and resumed: equal to the
    uninterrupted 1,200-step run to the bit, on both ranks. A FASO run
    with only its ring split over the two ranks, saved there at k = 400,
    is loaded by this one process (rank="all", no template), joined by
    merge_resume_states and resumed without a mesh: equal to the
    uninterrupted unsharded run to the bit."""
    ranks = run_ranks(tmp_path, CHILD_SOURCE, dict(n_iters=1200, k_stop=400))
    for r in ranks:
        full, resumed = r["full"], r["resumed"]
        np.testing.assert_array_equal(resumed["opt_param"].numpy(), full["opt_param"].numpy())
        for name in ("k_conv", "k_stopped"):
            assert resumed[name] == full[name], name
        # the resumed run reads the verdicts that were in flight and later
        assert resumed["rhat_verdicts"] == full["rhat_verdicts"][-len(resumed["rhat_verdicts"]):]
        assert r["ring_equal"]
        assert r["files"] == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    assert ranks[0]["ring_width"] + ranks[1]["ring_width"] == DIM + DIM * DIM
    assert ranks[0]["full"]["k_conv"] is not None
    import viabel_torch as vt
    from viabel_torch.checkpoint import load_pytree_orbax
    from viabel_torch.faso import merge_resume_states
    shares = load_pytree_orbax(str(tmp_path / "ckpt_split"), device="cpu", rank="all")
    assert [list(sh["ring_columns"]) for sh in shares] == [[0, 14, 30], [14, 30, 30]]
    with pytest.raises(ValueError, match="merge_resume_states"):
        vt.FASO(vt.RMSProp(0.05)).optimize(10, None, torch.zeros(30, dtype=torch.float64),
                                           resume_state=shares[1])
    f64 = dict(device="cpu", dtype=torch.float64)
    objective = vt.ExclusiveKL(vt.FullRankGaussian(DIM, **f64),
                               vt.zoo.logistic_regression(dim=DIM, n_data=40, **f64)[0], S)

    def run(resume_state=None):
        return vt.FASO(vt.RMSProp(0.05), max_history=600, **FASO_KW).optimize(
            1200, objective, torch.zeros(DIM + DIM * DIM, **f64),
            generator=torch.Generator().manual_seed(4), resume_state=resume_state)

    full, resumed = run(), run(merge_resume_states(shares))
    assert torch.equal(resumed["opt_param"], full["opt_param"])
    assert resumed["k_stopped"] == full["k_stopped"] is not None
    assert load_pytree_orbax(str(tmp_path / "ckpt"), device="cpu", rank=1)["t"] == 400


def test_sharded_faso_on_fewer_columns_than_blocks(tmp_path):
    """A ring too narrow for a 16-byte block a rank takes the even split:
    at D = 3 columns [0, 1) | [1, 3), at D = 1 [0, 0) | [0, 1), where rank
    0's shard has no column and runs no statistic (kernel 1's wrapper is
    never called there). With the max and the quantile gate, FASO over two
    ranks equals FASO without a mesh to the bit, on both ranks."""
    ranks = run_ranks(tmp_path, CHILD_SOURCE, dict(narrow=True))
    for rank, got in enumerate(ranks):
        for (D, quantile), runs in got.items():
            sharded, plain = runs["sharded"], runs["plain"]
            np.testing.assert_array_equal(sharded["opt_param"], plain["opt_param"])
            for name in ("k_conv", "k_stopped", "rhat_verdicts"):
                assert sharded[name] == plain[name], (D, quantile, name)
            assert plain["k_stopped"] is not None
            bounds = [0, 1, 3] if D == 3 else [0, 0, 1]
            assert list(sharded["ring_columns"]) == [bounds[rank], bounds[rank + 1], D]
            width = bounds[rank + 1] - bounds[rank]
            assert set(sharded["kernel_widths"]) == ({width} if width else set())
            assert plain["kernel_widths"] and set(plain["kernel_widths"]) == {D}
