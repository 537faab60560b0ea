"""MC-sample-axis data parallelism over ``torch.distributed``: the port's
``ShardedExclusiveKL`` and ``shard_mc_objective`` on two gloo ranks on
the CPU, in float64, against the port's and the JAX package's unsharded
steps on the concatenated draws.

Each multi-rank test starts its own pair of child processes (one
``torch.set_num_threads(1)`` each, JAX blocked in them) that join one
process group through a file store under ``tmp_path``; the parent joins
them with a timeout, so a deadlock fails the test instead of hanging the
suite. Rank ``r`` draws rows ``[r S/2, (r+1) S/2)`` of each ``S``-row block
of one numpy table through the family's ``base_sampler``; the unsharded
steps draw the whole block.
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
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from test_torch_multistart import StreamNormal  # noqa: E402
from viabel_torch.parallel import (ShardedExclusiveKL, distributed_init,  # noqa: E402
                                   make_mesh, shard_mc_objective)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(device="cpu", dtype=torch.float64)
D, S, WORLD = 3, 8, 2
RTOL = 1e-10  # the same float64 formulas; only the summation order differs
#: the parent's join on the two ranks; a deadlocked collective fails here
JOIN_TIMEOUT_S = 120
DIS_STEPS = 3
CASES = ("exclusive_kl", "exclusive_kl_stl", "iwelbo_dreg", "iwelbo", "alpha", "dis")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SliceNormal:
    """Consecutive ``n * world``-row blocks of one table of standard
    normals; rank ``rank`` takes its ``n`` rows of each block (the port's
    ``base_sampler`` hook)."""

    def __init__(self, table, rank=0, world=1):
        self.table, self.rank, self.world, self.pos = table, rank, world, 0

    def normal(self, generator, n_samples, width, dtype, device):
        block = self.table[self.pos:self.pos + n_samples * self.world, :width]
        assert block.shape[0] == n_samples * self.world, "draw table exhausted"
        self.pos += n_samples * self.world
        rows = block[self.rank * n_samples:(self.rank + 1) * n_samples]
        return torch.as_tensor(rows, dtype=dtype, device=device)


def port_objective(case, sampler):
    """The case's objective in the port, drawing through ``sampler``."""
    import viabel_torch as vt
    f64 = dict(device="cpu", dtype=torch.float64)
    model = vt.zoo.logistic_regression(dim=3, n_data=40, **f64)[0]
    family = (vt.MFGaussian if case == "exclusive_kl" else vt.FullRankGaussian)(
        3, base_sampler=sampler, **f64)
    if case.startswith("exclusive_kl"):
        return vt.ExclusiveKL(family, model, 8, use_path_deriv=case.endswith("stl"))
    if case.startswith("iwelbo"):
        return vt.IWELBO(family, model, 8, use_dreg=case.endswith("dreg"))
    if case == "alpha":
        return vt.AlphaDivergence(family, model, 8, alpha=2.0)
    return vt.DISInclusiveKL(family, model, 8, ess_target=4, use_resampling=False,
                             temper_prior=vt.MFGaussian(3, **f64),
                             temper_prior_params=np.zeros(6))


def run_steps(objective, var_param, case, generator):
    """One step of the case (``DIS_STEPS`` from a fresh state for DIS):
    the values, the gradients and, for DIS, each step's eps."""
    if case != "dis":
        value, grad = objective.value_and_grad(var_param, generator)
        return {"values": [float(value)], "grads": [grad.numpy()], "eps": []}
    out = {"values": [], "grads": [], "eps": []}
    state = objective.init_obj_state(var_param)
    for _ in range(DIS_STEPS):
        value, grad, state = objective.value_and_grad_with_state(var_param, generator, state)
        out["values"].append(float(value))
        out["grads"].append(grad.numpy())
        out["eps"].append(float(state["eps"]))
    return out


def var_param(case):
    n = 6 if case == "exclusive_kl" else 12
    return 0.2 * np.random.RandomState(4).randn(n)


def child_main(spec):
    """One rank: join the group, run the spec's cases, save the results."""
    import torch.distributed as dist
    from viabel_torch.parallel import (ShardedExclusiveKL, distributed_init, make_mesh,
                                       shard_mc_objective)
    rank, world = spec["rank"], spec["world"]
    distributed_init("file://" + spec["store"], world_size=world, rank=rank,
                     backend="gloo", device_type="cpu")
    mesh = make_mesh(device_type="cpu")
    table = np.load(spec["table"])
    out = {}
    for case in spec["cases"]:
        sampler = SliceNormal(table, rank, world)
        inner = port_objective(case, sampler)
        if case == "exclusive_kl_stl":
            objective = ShardedExclusiveKL(inner.approx, inner.model, 8, mesh,
                                           use_path_deriv=True)
        else:
            objective = shard_mc_objective(inner, mesh)
        x = torch.as_tensor(var_param(case))
        out[case] = run_steps(objective, x, case, torch.Generator().manual_seed(0))
    if spec.get("own_draws"):
        # real generators: each rank's draws of one step
        obj = ShardedExclusiveKL(vt.MFGaussian(3, device="cpu", dtype=torch.float64),
                                 vt.zoo.logistic_regression(dim=3, n_data=40, device="cpu",
                                                            dtype=torch.float64)[0],
                                 8, mesh)
        gen = torch.Generator().manual_seed(0)
        local = obj._axis.generator(gen)
        out["own_draws"] = torch.randn(4, 3, generator=local, dtype=torch.float64).numpy()
    if spec.get("faso"):
        # FASO with mc_escalation over a sharded objective, real draws and
        # real clocks; a rung of 1.5 x S is rounded up to even
        model = vt.zoo.logistic_regression(dim=4, n_data=40, device="cpu",
                                           dtype=torch.float64)[0]
        objective = shard_mc_objective(
            vt.ExclusiveKL(vt.FullRankGaussian(4, device="cpu", dtype=torch.float64),
                           model, 2, use_path_deriv=True), mesh)
        x0 = torch.as_tensor(0.1 * np.random.RandomState(1).randn(20))
        res = vt.FASO(vt.RMSProp(0.1), W_min=50, k_check=50, rhat_threshold=1.01,
                      mc_escalation=1.5, mc_patience=2, mcse_threshold=0.1).optimize(
            1000, objective, x0, generator=torch.Generator().manual_seed(7))
        out["faso"] = {"opt_param": res["opt_param"].numpy(),
                       "events": res["mc_escalation_history"],
                       "k_conv": res["k_conv"], "k_stopped": res["k_stopped"],
                       "S": objective.num_mc_samples,
                       "steps": int(res["value_history"].shape[0])}
    torch.save(out, spec["out"])
    dist.destroy_process_group()


CHILD_SOURCE = "\n".join([
    "import sys",
    "sys.modules['jax'] = None  # a rank never imports JAX",
    "import json",
    "import numpy as np",
    "import torch",
    "torch.set_num_threads(1)",
    "import viabel_torch as vt",
    "DIS_STEPS = %d" % DIS_STEPS,
    inspect.getsource(SliceNormal),
    inspect.getsource(port_objective),
    inspect.getsource(run_steps),
    inspect.getsource(var_param),
    inspect.getsource(child_main),
    "child_main(json.loads(sys.argv[1]))",
    "assert not any(m == 'viabel_tpu' or m.startswith('viabel_tpu.') for m in sys.modules)",
])


def run_ranks(tmp_path, table, **spec):
    """Both ranks of one process group, joined with a timeout; returns
    their results."""
    np.save(tmp_path / "table.npy", table)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
    procs = []
    for rank in range(WORLD):
        args = dict(spec, rank=rank, world=WORLD, store=str(tmp_path / "store"),
                    table=str(tmp_path / "table.npy"), out=str(tmp_path / f"rank{rank}.pt"))
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD_SOURCE, json.dumps(args)],
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
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def jax_steps(case, table):
    """The JAX package's unsharded steps on the concatenated draws."""
    smp = StreamNormal(table)
    model = vj.zoo.logistic_regression(dim=D, n_data=40)[0]
    family = (vj.MFGaussian if case == "exclusive_kl" else vj.FullRankGaussian)(
        D, base_sampler=smp)
    x = jnp.asarray(var_param(case))
    key = jax.random.PRNGKey(0)
    if case.startswith("exclusive_kl"):
        obj = vj.ExclusiveKL(family, model, S, use_path_deriv=case.endswith("stl"))
    elif case.startswith("iwelbo"):
        obj = vj.IWELBO(family, model, S, use_dreg=case.endswith("dreg"))
    elif case == "alpha":
        obj = vj.AlphaDivergence(family, model, S, alpha=2.0)
    else:
        obj = vj.DISInclusiveKL(family, model, S, ess_target=4, use_resampling=False,
                                temper_prior=vj.MFGaussian(D),
                                temper_prior_params=np.zeros(2 * D))
        out = {"values": [], "grads": [], "eps": []}
        state = obj.init_obj_state(x)
        for _ in range(DIS_STEPS):
            value, grad, state = obj.value_and_grad_with_state(x, key, state)
            out["values"].append(float(value))
            out["grads"].append(np.asarray(grad))
            out["eps"].append(float(state["eps"]))
        return out
    value, grad = obj.value_and_grad(x, key)
    return {"values": [float(value)], "grads": [np.asarray(grad)], "eps": []}


def assert_steps_close(got, want):
    np.testing.assert_allclose(got["values"], want["values"], rtol=RTOL)
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(got["eps"], want["eps"], rtol=RTOL)
    assert len(got["grads"]) == len(want["grads"])


@pytest.mark.parametrize("case", CASES)
def test_mc_sharded_step_on_two_ranks_matches_unsharded(tmp_path, case):
    """Two gloo ranks, each on its slice of the draws: the sharded value
    and gradient (and DIS's eps sequence, three steps) equal the port's
    unsharded step on the concatenated draws and the JAX package's, to
    rtol 1e-10; both ranks return the same results, to the bit."""
    table = np.random.RandomState(3).randn(S * DIS_STEPS + S, D)
    ranks = run_ranks(tmp_path, table, cases=[case])
    for key in ("values", "eps"):
        assert ranks[0][case][key] == ranks[1][case][key], key
    for g0, g1 in zip(ranks[0][case]["grads"], ranks[1][case]["grads"]):
        np.testing.assert_array_equal(g0, g1)
    plain = run_steps(port_objective(case, SliceNormal(table)),
                      torch.as_tensor(var_param(case)), case, torch.Generator().manual_seed(0))
    assert_steps_close(ranks[0][case], plain)
    assert_steps_close(ranks[0][case], jax_steps(case, table))
    if case == "dis":
        assert len(set(plain["eps"])) > 1  # the bisection moved eps


def test_mc_sharded_faso_escalates_on_two_ranks(tmp_path):
    """FASO with mc_escalation over shard_mc_objective, real draws and real
    clocks, on two ranks: both end with the same results, the ladder
    climbed, and every rung is a multiple of 2 (1.5 x S rounded up). The
    ranks draw apart. The JAX package's wrapper cannot take a rung at all
    (its num_mc_samples has no setter)."""
    table = np.random.RandomState(3).randn(S, D)
    r0, r1 = run_ranks(tmp_path, table, cases=[], faso=True, own_draws=True)
    f0, f1 = r0["faso"], r1["faso"]
    np.testing.assert_array_equal(f0["opt_param"], f1["opt_param"])
    np.testing.assert_array_equal(f0["events"], f1["events"])
    for name in ("k_conv", "k_stopped", "S", "steps"):
        assert f0[name] == f1[name], name
    assert len(f0["events"]) >= 1
    assert all(int(s) % WORLD == 0 for s in f0["events"][:, 1])
    assert f0["S"] == int(f0["events"][-1, 1])
    assert np.isfinite(f0["opt_param"]).all()
    assert not np.allclose(r0["own_draws"], r1["own_draws"])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("mc",))
    model = vj.zoo.logistic_regression(dim=D, n_data=40)[0]
    wrapped = vj.parallel.shard_mc_objective(vj.ExclusiveKL(vj.MFGaussian(D), model, 4), mesh)
    with pytest.raises(AttributeError):
        wrapped.num_mc_samples = 6


class TwoRankMesh:
    """What the wrappers read of a two-rank ``mc`` axis, for the checks
    that raise before any collective."""

    mesh_dim_names = ("mc",)

    def size(self, dim=None):
        return 2

    def get_local_rank(self, dim=None):
        return 0

    def get_group(self, dim=None):
        return None


def _mf_objective(cls, n, **kw):
    model = vt.zoo.logistic_regression(dim=2, n_data=20, **F64)[0]
    return cls(vt.MFGaussian(2, **F64), model, n, **kw)


@pytest.mark.parametrize("what", ["sharded_exclusive_kl", "iwelbo", "alpha", "dis"])
def test_mc_sharded_sample_count_must_divide(what):
    """JAX's ValueError for an S that does not divide the axis size."""
    with pytest.raises(ValueError, match="must be divisible"):
        if what == "sharded_exclusive_kl":
            ShardedExclusiveKL(vt.MFGaussian(2, **F64),
                               vt.zoo.logistic_regression(dim=2, n_data=20, **F64)[0], 3,
                               TwoRankMesh())
        elif what == "dis":
            shard_mc_objective(_mf_objective(
                vt.DISInclusiveKL, 3, ess_target=2, use_resampling=False,
                temper_prior=vt.MFGaussian(2, **F64), temper_prior_params=np.zeros(4)),
                TwoRankMesh())
        else:
            cls, kw = ((vt.IWELBO, {}) if what == "iwelbo"
                       else (vt.AlphaDivergence, dict(alpha=2.0)))
            shard_mc_objective(_mf_objective(cls, 3, **kw), TwoRankMesh())


@pytest.mark.parametrize("what", ["dis_resampling", "hessian", "no_recipe", "no_axis"])
def test_mc_sharded_refusals_match_jax(what):
    """DIS with resampling and the Hessian control variates have no
    per-rank recipe (JAX's messages); an objective without one raises
    JAX's ValueError, and so does a mesh without the axis."""
    match = {"dis_resampling": "use_resampling=False", "hessian": "Hessian",
             "no_recipe": "does not support MC-axis sharding", "no_axis": "no axis"}[what]
    with pytest.raises(ValueError, match=match):
        if what == "dis_resampling":
            shard_mc_objective(_mf_objective(
                vt.DISInclusiveKL, 4, ess_target=2, use_resampling=True,
                temper_prior=vt.MFGaussian(2, **F64), temper_prior_params=np.zeros(4)),
                TwoRankMesh())
        elif what == "hessian":
            shard_mc_objective(_mf_objective(vt.ExclusiveKL, 4,
                                             hessian_approx_method="mean_only"),
                               TwoRankMesh())
        elif what == "no_recipe":
            shard_mc_objective(object(), TwoRankMesh())
        else:
            shard_mc_objective(_mf_objective(vt.ExclusiveKL, 4), TwoRankMesh(), "data")


def test_mc_sharded_sample_count_rounds_up_to_the_axis():
    """The port's settable sharded S: a rung is rounded up to a multiple
    of the axis size, on the wrapper and on ShardedExclusiveKL."""
    wrapped = shard_mc_objective(_mf_objective(vt.IWELBO, 4), TwoRankMesh())
    wrapped.num_mc_samples = 5
    assert wrapped.num_mc_samples == wrapped._inner.num_mc_samples == 6
    sharded = ShardedExclusiveKL(vt.MFGaussian(2, **F64),
                                 vt.zoo.logistic_regression(dim=2, n_data=20, **F64)[0], 4,
                                 TwoRankMesh())
    sharded.set_num_mc_samples(7)
    assert sharded.num_mc_samples == 8


def test_distributed_init_single_process(monkeypatch):
    """With no address given or found, distributed_init returns the local
    devices and starts no group; make_mesh then refuses."""
    import torch.distributed as dist
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert distributed_init(device_type="cpu") == [torch.device("cpu")]
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        make_mesh(device_type="cpu")


def test_world_one_group_runs_the_collectives(tmp_path):
    """A one-rank gloo group in this process: make_mesh refuses a shape
    that needs more ranks (JAX's ValueError); ShardedExclusiveKL and the
    DIS wrapper equal their unsharded steps on the same draws (the
    all-reduces still run); agree returns the reading itself; the plain
    loop and RAABBVI take the wrapper as they take the objective."""
    import torch.distributed as dist
    distributed_init("file://" + str(tmp_path / "store"), world_size=1, rank=0,
                     backend="gloo", device_type="cpu")
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh((2,), device_type="cpu")
        mesh = make_mesh(device_type="cpu")
        assert mesh.size(0) == 1 and mesh.get_local_rank("mc") == 0
        table = np.random.RandomState(9).randn(64, D)
        for case in ("exclusive_kl_stl", "dis"):
            inner = port_objective(case, SliceNormal(table))
            sharded = (ShardedExclusiveKL(inner.approx, inner.model, S, mesh,
                                          use_path_deriv=True)
                       if case == "exclusive_kl_stl" else shard_mc_objective(inner, mesh))
            x = torch.as_tensor(var_param(case))
            got = run_steps(sharded, x, case, torch.Generator().manual_seed(0))
            want = run_steps(port_objective(case, SliceNormal(table)), x, case,
                             torch.Generator().manual_seed(0))
            assert_steps_close(got, want)
            assert sharded.agree(2.5) == 2.5
        dis = shard_mc_objective(port_objective("dis", None), mesh)  # real draws
        x = torch.as_tensor(var_param("dis"))
        plain = vt.RMSProp(0.01).optimize(20, dis, x, generator=torch.Generator().manual_seed(1))
        assert plain["value_history"].shape == (20,) and "obj_state" in plain
        res = vt.RAABBVI(vt.RMSProp(0.01), W_min=50, k_check=50).optimize(
            120, dis, x, generator=torch.Generator().manual_seed(1))
        assert torch.isfinite(res["opt_param"]).all() and res["k_stopped_final"] is None
    finally:
        dist.destroy_process_group()
