"""The engines with their restarts (or paths) split over ranks:
``multistart_faso``, ``multistart_raabbvi`` on both schedules,
``multistart_optimize`` on a restart x mc mesh and
``multipath_pathfinder``, on gloo ranks on the CPU in float64, against the
port's unsharded runs, to the bit (tests/test_parallel.py's
``test_multistart_faso_sharded_matches_unsharded`` and its stateful twin,
tests/test_optimizers.py's async sharded test).

The ranks are ``python -c`` children built from this module's helpers
(tests/test_torch_faso_sharded.py's launcher, JAX blocked in them); the
parent computes the unsharded runs with the same helpers and the same
stubbed clocks. The regression stub draws from the HMC generator it is
given, so a rank that regressed a restart it does not own, or lost a
generator's state, would change the decisions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_faso_sharded import (FakeClock, FixedTimer, child_source,  # noqa: E402
                                     run_ranks)

F64 = dict(device="cpu", dtype=torch.float64)
MS_KW = dict(W_min=100, k_check=50, mcse_threshold=0.1, ESS_min=10, max_history=600)
MS_KW_FASO = dict(W_min=100, k_check=50, mcse_threshold=0.05)
RB_KW = dict(W_min=50, k_check=50, iters0=10, max_history=600, verbose=False,
             learning_rate=np.array([0.1, 0.05, 0.1, 0.05]))


def stub_regression():
    """RAABBVI's weighted regression replaced by a draw from the HMC
    generator it is handed: kappa in [0.5, 0.7)."""
    import viabel_torch as vt

    def fit(self, y, x, generator=None, **kw):
        u = float(torch.rand((), generator=generator, dtype=torch.float64))
        return None, 0.5 + 0.2 * u, 0.8

    vt.RAABBVI.weighted_linear_regression = fit


def multistart_case(case, mesh=None):
    """One engine run of ``case`` with the restarts split over ``mesh``'s
    ``restart`` axis (None: unsharded); its results as host values."""
    import viabel_torch as vt
    from viabel_torch.parallel import multistart_faso, multistart_raabbvi
    f64 = dict(device="cpu", dtype=torch.float64)
    FakeClock.t = 0.0
    model = vt.zoo.logistic_regression(dim=3, n_data=40, **f64)[0]
    gen = torch.Generator().manual_seed(3)
    if case in ("faso", "faso_dis"):
        family = vt.MFGaussian(3, **f64)
        objective = (vt.ExclusiveKL(family, model, 10) if case == "faso" else
                     vt.DISInclusiveKL(family, model, 20, ess_target=10,
                                       temper_prior=vt.MFGaussian(3, **f64),
                                       temper_prior_params=np.zeros(6)))
        x0 = torch.as_tensor(0.1 * np.random.RandomState(1).randn(4, 6))
        res = multistart_faso(vt.RMSProp(0.05), 1500, objective, x0, gen, mesh=mesh,
                              **MS_KW)
        keys = ("k_conv", "k_Rhat", "k_stopped")
    else:
        objective = vt.ExclusiveKL(vt.FullRankGaussian(3, **f64), model, 4,
                                   use_path_deriv=True)
        x0 = torch.as_tensor(0.1 * np.random.RandomState(1).randn(4, 12))
        res = multistart_raabbvi(vt.RMSProp(0.1), 3000, objective, x0, gen, mesh=mesh,
                                 schedule=case.split("_")[1], **RB_KW)
        keys = ("k_stopped_final", "k_total", "k_global_steps", "n_rounds",
                "conv_iters_hist", "learning_rate_hist", "SKL_history", "kappa_hist",
                "stopping_crt")
    rs = res["resume_state"]
    out = {name: res[name] for name in keys}
    out["opt_param"] = res["opt_param"].numpy()
    for name in ("generator_states", "hmc_generator_states", "var_params"):
        if name in rs:
            out[name] = rs[name].numpy()
    if case == "faso_dis":
        out["obj_state_steps"] = [int(st["step"]) for st in rs["obj_states"]]
    if "value_history" in res:
        out["value_history"] = res["value_history"].numpy()
    out["rings"] = len(rs.get("rings", ()))
    return out


def reshard_case(mc_mesh, restart_mesh):
    """Each engine resumed across mesh shapes, beside its uninterrupted
    unsharded run: FASO with its ring's columns split over ``mc_mesh``,
    multistart_faso and the async multistart_raabbvi with their restarts
    split over ``restart_mesh``. Whole to split: the unsharded run's state
    at the stop, resumed split. Split to whole: every rank's state of the
    split run at the stop, joined by merge_resume_states and resumed
    unsharded. (The async run stops at a round boundary through its
    round_callback snapshots.)"""
    import torch.distributed as dist
    import viabel_torch as vt
    from viabel_torch.faso import merge_resume_states
    from viabel_torch.parallel import multistart_faso, multistart_raabbvi
    f64 = dict(device="cpu", dtype=torch.float64)
    model = vt.zoo.logistic_regression(dim=3, n_data=40, **f64)[0]

    def every_rank(state):
        states = [None] * dist.get_world_size()
        dist.all_gather_object(states, state)
        return states

    def faso(n, mesh=None, rs=None):
        FakeClock.t = 0.0
        objective = vt.ExclusiveKL(vt.FullRankGaussian(3, **f64), model, 10)
        return vt.FASO(vt.RMSProp(0.05), mesh=mesh, max_history=600, **MS_KW_FASO).optimize(
            n, objective, torch.zeros(12, **f64), generator=torch.Generator().manual_seed(5),
            resume_state=rs)

    def ms_faso(n, mesh=None, rs=None):
        FakeClock.t = 0.0
        objective = vt.ExclusiveKL(vt.MFGaussian(3, **f64), model, 10)
        x0 = torch.as_tensor(0.1 * np.random.RandomState(1).randn(4, 6))
        return multistart_faso(vt.RMSProp(0.05), n, objective, x0,
                               torch.Generator().manual_seed(3), mesh=mesh, resume_state=rs,
                               **MS_KW)

    def ms_async(n, mesh=None, rs=None, snaps=None):
        FakeClock.t = 0.0
        objective = vt.ExclusiveKL(vt.FullRankGaussian(3, **f64), model, 4,
                                   use_path_deriv=True)
        x0 = torch.as_tensor(0.1 * np.random.RandomState(1).randn(4, 12))
        return multistart_raabbvi(
            vt.RMSProp(0.1), n, objective, x0, torch.Generator().manual_seed(3), mesh=mesh,
            schedule="async", resume_state=rs, round_callback=(
                None if snaps is None else lambda k, snap: snaps.append(snap)), **RB_KW)

    out = {}
    for name, run, mesh, n, stop in (("faso", faso, mc_mesh, 1200, 400),
                                     ("multistart_faso", ms_faso, restart_mesh, 1500, 400)):
        whole_state = run(stop)["resume_state"]
        shares = every_rank(run(stop, mesh)["resume_state"])
        out[name] = {"full": run(n), "split_from_whole": run(n, mesh, whole_state),
                     "whole_from_split": run(n, None, merge_resume_states(shares)),
                     "spans": [list(np.asarray(sh.get("ring_columns", sh.get("ring_restarts"))))
                               for sh in shares]}
    snaps_whole, snaps_split = [], []
    full = ms_async(3000, snaps=snaps_whole)
    ms_async(3000, restart_mesh, snaps=snaps_split)
    i = len(snaps_whole) // 2
    out["multistart_raabbvi"] = {
        "full": full, "split_from_whole": ms_async(3000, restart_mesh, snaps_whole[i]),
        "whole_from_split": ms_async(3000, None,
                                     merge_resume_states(every_rank(snaps_split[i]))),
        "spans": [list(np.asarray(sh["ring_restarts"])) for sh in every_rank(snaps_split[i])]}
    for runs in out.values():
        for key in ("full", "split_from_whole", "whole_from_split"):
            res = runs[key]
            runs[key] = {name: (res[name].numpy() if isinstance(res[name], torch.Tensor)
                                else res[name])
                         for name in ("opt_param", "k_conv", "k_stopped", "k_stopped_final",
                                      "k_total", "k_global_steps", "kappa_hist")
                         if name in res}
    return out


def optimize_rows(mesh):
    """``multistart_optimize`` on the restart x mc mesh, and each of this
    rank's restarts run alone (B = 1) under ``shard_mc_objective`` on the
    mc axis with that restart's generator."""
    import viabel_torch as vt
    from viabel_torch.parallel import multistart_optimize, shard_mc_objective
    from viabel_torch.parallel.multistart import restart_generators
    f64 = dict(device="cpu", dtype=torch.float64)
    model = vt.zoo.logistic_regression(dim=3, n_data=40, **f64)[0]
    objective = vt.ExclusiveKL(vt.FullRankGaussian(3, **f64), model, 8, use_path_deriv=True)
    x0 = torch.as_tensor(0.1 * np.random.RandomState(2).randn(4, 12))
    sgo = vt.RMSProp(0.05)
    res = multistart_optimize(sgo, 200, objective, x0, torch.Generator().manual_seed(6),
                              mesh=mesh, restart_axis="restart", mc_axis="mc")
    gens = restart_generators(torch.Generator().manual_seed(6), 4, "cpu")
    mine = range(2 * mesh.get_local_rank("restart"), 2 * mesh.get_local_rank("restart") + 2)
    alone = {b: multistart_optimize(sgo, 200, shard_mc_objective(objective, mesh, "mc"),
                                    x0[b:b + 1], gens[b]) for b in mine}
    return {"rows": {name: res[name].numpy() for name in res},
            "alone": {b: {name: r[name][0].numpy() for name in r} for b, r in alone.items()}}


def pathfinder_run(mesh=None):
    import viabel_torch as vt
    f64 = dict(device="cpu", dtype=torch.float64)
    model = vt.zoo.logistic_regression(dim=4, n_data=40, **f64)[0]
    x0 = torch.as_tensor(np.random.RandomState(2).randn(4, 4))
    res = vt.multipath_pathfinder(model, x0, torch.Generator().manual_seed(1), max_iters=20,
                                  n_draws_per_path=50, n_draws=100, mesh=mesh)
    return {name: res[name].numpy() for name in ("samples", "log_weights", "pool_samples",
                                                 "elbo", "best_l")}


def child_main(spec):
    import torch.distributed as dist
    from viabel_torch.parallel import distributed_init, make_mesh
    rank, world = spec["rank"], spec["world"]
    distributed_init("file://" + spec["store"], world_size=world, rank=rank,
                     backend="gloo", device_type="cpu")
    stub_regression()
    if spec["case"] == "reshard":
        out = reshard_case(make_mesh((2,), ("mc",), device_type="cpu"),
                           make_mesh((2,), ("restart",), device_type="cpu"))
    elif spec["case"] == "optimize":
        out = optimize_rows(make_mesh((2, 2), ("restart", "mc"), device_type="cpu"))
    elif spec["case"] == "pathfinder":
        out = pathfinder_run(make_mesh((2,), ("paths",), device_type="cpu"))
    else:
        out = multistart_case(spec["case"], make_mesh((2,), ("restart",), device_type="cpu"))
    torch.save(out, spec["out"])
    dist.destroy_process_group()


CHILD_SOURCE = child_source(stub_regression, multistart_case, reshard_case, optimize_rows,
                            pathfinder_run, child_main).replace(
    "import viabel_torch as vt\n",
    f"import viabel_torch as vt\nMS_KW = {MS_KW!r}\nMS_KW_FASO = {MS_KW_FASO!r}\n"
    f"RB_KW = dict({', '.join(f'{k}={v!r}' for k, v in RB_KW.items() if k != 'learning_rate')},"
    " learning_rate=np.array([0.1, 0.05, 0.1, 0.05]))\n", 1)


@pytest.fixture
def parent_stubs(monkeypatch):
    """The children's stubbed clocks and regression, in this process."""
    import viabel_torch as vt
    import viabel_torch.faso as tfaso
    import viabel_torch.parallel.multistart as tms
    import viabel_torch.parallel.raabbvi as trb
    for mod in (tfaso, tms, trb):
        monkeypatch.setattr(mod, "Timer", FixedTimer)
        monkeypatch.setattr(mod, "_now", FakeClock.now)
    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression",
                        vt.RAABBVI.weighted_linear_regression)
    stub_regression()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_equal_runs(got, want):
    for name, value in want.items():
        if name == "rings":
            continue
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        else:
            assert got[name] == value, name


@pytest.mark.parametrize("case", ["faso", "faso_dis", "raabbvi_lockstep", "raabbvi_async"])
def test_restart_sharded_engines_match_unsharded(tmp_path, parent_stubs, case):
    """B = 4 restarts over two ranks: every per-restart result, history,
    decision and generator state equals the unsharded run's, to the bit,
    on both ranks; each rank's resume state holds its two rings. DIS
    threads per-restart state through multistart_faso; multistart_raabbvi
    runs each rank's regressions only (on an lr grid, so restarts end
    their rounds apart)."""
    want = multistart_case(case)
    ranks = run_ranks(tmp_path, CHILD_SOURCE, dict(case=case))
    for got in ranks:
        assert_equal_runs(got, want)
        if case.startswith("faso"):
            assert got["rings"] == 2
    assert want["rings"] == (4 if case != "raabbvi_lockstep" else 0)
    if case.startswith("faso"):
        assert all(k is not None for k in want["k_stopped"])
        assert len(set(want["k_stopped"])) > 1
    else:
        assert all(k is not None for k in want["k_stopped_final"])
        assert len({tuple(h) for h in want["kappa_hist"]}) > 1


def test_resume_across_mesh_shapes(tmp_path, parent_stubs):
    """Over two ranks, FASO (ring columns split) and multistart_faso and
    the async multistart_raabbvi (restarts split) resume across mesh
    shapes: the unsharded run's state resumed split, and the split run's
    two states joined by merge_resume_states and resumed unsharded, each
    equal to the uninterrupted unsharded run to the bit, on both ranks."""
    ranks = run_ranks(tmp_path, CHILD_SOURCE, dict(case="reshard"))
    for got in ranks:
        for engine, runs in got.items():
            want = runs["full"]
            for key in ("split_from_whole", "whole_from_split"):
                assert set(runs[key]) == set(want), (engine, key)
                for name, value in want.items():
                    if isinstance(value, np.ndarray):
                        np.testing.assert_array_equal(runs[key][name], value,
                                                      err_msg=f"{engine} {key} {name}")
                    else:
                        assert runs[key][name] == value, (engine, key, name)
            np.testing.assert_array_equal(want["opt_param"],
                                          ranks[0][engine]["full"]["opt_param"])
    spans = {engine: runs["spans"] for engine, runs in ranks[0].items()}
    assert spans["faso"][0][0] == 0 and spans["faso"][0][1] == spans["faso"][1][0]
    assert spans["faso"][1][1:] == [12, 12]
    for engine in ("multistart_faso", "multistart_raabbvi"):
        assert spans[engine] == [[0, 2, 4], [2, 4, 4]]
    assert ranks[0]["faso"]["full"]["k_stopped"] is not None
    assert all(k is not None for k in ranks[0]["multistart_faso"]["full"]["k_stopped"])


def test_multistart_optimize_on_a_restart_by_mc_mesh(tmp_path):
    """On a (restart 2 x mc 2) mesh of four ranks, each restart row equals
    that restart run alone under shard_mc_objective on an mc axis of 2
    with the same restart generator, and every rank returns all rows."""
    ranks = run_ranks(tmp_path, CHILD_SOURCE, dict(case="optimize"), world=4)
    for r in ranks:
        for name, rows in r["rows"].items():
            np.testing.assert_array_equal(rows, ranks[0]["rows"][name])
            for b, alone in r["alone"].items():
                np.testing.assert_array_equal(rows[b], alone[name], err_msg=f"{name} {b}")
    assert sorted(b for r in ranks for b in r["alone"]) == [0, 0, 1, 1, 2, 2, 3, 3]


def test_multipath_pathfinder_sharded_matches_unsharded(tmp_path):
    """M = 4 paths over two ranks: the samples (rtol 1e-12) and smoothed
    log weights (rtol 1e-10) equal the unsharded run's; a path evaluates
    the model on its own rows, so its numbers do not depend on the paths
    beside it."""
    torch.set_num_threads(1)
    want = pathfinder_run()
    for got in run_ranks(tmp_path, CHILD_SOURCE, dict(case="pathfinder")):
        np.testing.assert_allclose(got["samples"], want["samples"], rtol=1e-12)
        np.testing.assert_allclose(got["log_weights"], want["log_weights"], rtol=1e-10)
        np.testing.assert_array_equal(got["best_l"], want["best_l"])
        np.testing.assert_array_equal(got["pool_samples"], want["pool_samples"])
