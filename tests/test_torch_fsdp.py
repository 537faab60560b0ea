"""``FSDPFullRankELBO``: the full-rank family's rows split over an ``fsdp``
axis (beside an ``mc`` axis) of gloo ranks on the CPU, in float64, against
the JAX package's trainer on the same meshes of virtual CPU devices, the
port's one-rank run and its unsharded ``ExclusiveKL(FullRankGaussian)``
step under ``RMSProp``.

The JAX draws are recomputed here as the JAX step makes them
(``normal(fold_in(key, j), (S / n_mc, d))`` for ``mc`` index ``j``,
``fsdp.py:127, 143``) and injected into the port's step through ``draws=``.
The JAX step's gradient is ``n_fsdp`` times the true one (a known defect
of the reference, ROADMAP.md Queue 3): at ``jitter=1e-300`` RMSProp
cancels the constant and the two packages agree; at the default jitter
JAX's ``nu`` is ``n_fsdp**2`` times the port's. The ranks are
``python -c`` children (tests/test_torch_faso_sharded.py's launcher, JAX
blocked in them).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
from test_torch_faso_sharded import child_source, run_ranks  # noqa: E402
from viabel_tpu.parallel.fsdp import FSDPFullRankELBO as JaxFSDP  # noqa: E402

D, S, LR, STEPS = 6, 8, 0.05, 5
MESHES = {"fsdp2": ((2,), ("fsdp",)), "fsdp2_mc2": ((2, 2), ("fsdp", "mc"))}
#: the sharded step against JAX's on the same draws at jitter=1e-300, and
#: against the port's one-rank and unsharded runs (the mean over mc ranks
#: and the row blocks' products round apart)
RTOL, ATOL = 1e-9, 1e-12


class Solo:
    """A one-rank ``fsdp`` mesh over a one-rank subgroup."""

    mesh_dim_names = ("fsdp",)
    device_type = "cpu"

    def __init__(self, group):
        self.group = group

    def size(self, dim=None):
        return 1

    def get_local_rank(self, name=None):
        return 0

    def get_group(self, name=None):
        return self.group


class StandIn:
    """What the constructor reads of a mesh: axis names and sizes."""

    device_type = "cpu"

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, dim=None):
        return self.shape[dim]

    def get_local_rank(self, name=None):
        return 0

    def get_group(self, name=None):
        return None


class Table:
    """A base sampler that hands out the rows of a ``(steps, S, d)`` table,
    one step's block a call."""

    def __init__(self, table):
        self.table, self.pos = table, 0

    def normal(self, generator, n_samples, width, dtype, device):
        z = torch.as_tensor(self.table[self.pos], dtype=dtype, device=device)
        self.pos += 1
        return z


def child_main(spec):
    """One rank: the sharded trainer at jitter=1e-300 (plain and
    pipelined), one default-jitter step, one step from JAX's state; rank 0
    also the one-rank run and the unsharded ExclusiveKL step."""
    import torch.distributed as dist
    from viabel_torch import convert
    from viabel_torch.parallel import FSDPFullRankELBO, distributed_init, make_mesh
    rank, world = spec["rank"], spec["world"]
    distributed_init("file://" + spec["store"], world_size=world, rank=rank,
                     backend="gloo", device_type="cpu")
    shape, names = tuple(spec["shape"]), tuple(spec["names"])
    mesh = make_mesh(shape, names, device_type="cpu")
    mc = "mc" if "mc" in names else None
    j = mesh.get_local_rank("mc") if mc else 0
    draws = np.load(spec["draws"])          # (steps + 1, n_mc, S / n_mc, d)
    f64 = dict(device="cpu", dtype=torch.float64)
    model = vt.zoo.logistic_regression(dim=D, n_data=40, **f64)[0]

    def run(jitter, n_steps, mesh=mesh, mc=mc, pipeline=None, rows=None):
        trainer = FSDPFullRankELBO(D, model, S, mesh, mc_axis=mc, learning_rate=LR,
                                   jitter=jitter, gather_pipeline=pipeline)
        params = trainer.init_params(torch.float64)
        state = trainer.init_opt_state(params)
        values = []
        for k in range(n_steps):
            z = draws[k, j] if rows is None else rows[k]
            params, state, value = trainer.step(params, state, draws=z)
            values.append(float(value))
        return trainer, params, state, values

    def whole(trainer, pair):
        return [x.numpy() for x in trainer.gather_params(pair)]

    out = {"rank": rank, "rows": list(FSDPFullRankELBO(D, model, S, mesh, mc_axis=mc).rows)}
    for name, kw in (("plain", {}), ("pipelined", {"pipeline": 2})):
        trainer, params, _, values = run(1e-300, STEPS, **kw)
        out[name] = {"params": whole(trainer, params), "values": values}
    trainer, _, state, _ = run(1e-8, 1)
    out["nu"] = whole(trainer, state[:2])
    # one step from the JAX trainer's state after STEPS steps
    jstate = np.load(spec["jax_state"])
    trainer = FSDPFullRankELBO(D, model, S, mesh, mc_axis=mc, learning_rate=LR,
                               jitter=1e-300)
    params = convert.fsdp_params_from_jax(jstate["mu"], jstate["theta"], trainer)
    state = convert.fsdp_opt_state_from_jax(
        (jstate["nu_mu"], jstate["nu_theta"], jstate["t"]), trainer, shape[0])
    params, state, _ = trainer.step(params, state, draws=draws[STEPS, j])
    out["continued"] = whole(trainer, params)
    groups = [dist.new_group([r]) for r in range(world)]
    if rank == 0:
        rows = draws.reshape(draws.shape[0], S, D)   # every mc rank's draws
        trainer, params, _, values = run(1e-300, STEPS, mesh=Solo(groups[0]), mc=None,
                                         rows=rows)
        out["one_rank"] = {"params": whole(trainer, params), "values": values}
        family = vt.FullRankGaussian(D, base_sampler=Table(rows), **f64)
        objective = vt.ExclusiveKL(family, model, S)
        sgo = vt.RMSProp(LR, jitter=1e-300)
        x = family.init_param()
        st = sgo.init_state(x)
        values = []
        for _ in range(STEPS):
            x, st, _, value, _, _ = sgo.step(objective, x, st, {}, None, LR)
            values.append(float(value))
        out["unsharded"] = {"params": [x[:D].numpy(), x[D:].view(D, D).numpy()],
                            "values": values}
    torch.save(out, spec["out"])
    dist.destroy_process_group()


CHILD_SOURCE = child_source(Solo, Table, child_main).replace(
    "import viabel_torch as vt\n",
    f"import viabel_torch as vt\nD, S, LR, STEPS = {D}, {S}, {LR}, {STEPS}\n", 1)


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def jax_draws(key, n_mc):
    """The JAX step's draws: one ``(S / n_mc, d)`` block an mc index."""
    if n_mc == 1:
        return np.asarray(jax.random.normal(key, (1, S, D), jnp.float64))
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, j),
                                                  (S // n_mc, D), jnp.float64))
                     for j in range(n_mc)])


def jax_steps(trainer, params, state, keys):
    values = []
    for key in keys:
        params, state, value = trainer.step(params, state, key)
        values.append(float(value))
    return params, state, values


def assert_pair(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fsdp_step_matches_jax_and_the_unsharded_step(tmp_path, mesh_name):
    """Over gloo ranks (2 on (fsdp=2,), 4 on (fsdp=2, mc=2)), on JAX's
    draws: every rank holds its rows and gathers the same whole
    parameters in fsdp order; at jitter=1e-300 five steps match JAX's
    trainer (parameters and values to rtol 1e-9), and so does one step
    from JAX's state carried over by convert; at the default jitter JAX's
    nu is n_fsdp**2 times the port's after one step (the reference's
    gradient scale, pinned); gather_pipeline=2 equals the plain path; the
    sharded run equals the port's one-rank run, which equals the
    unsharded ExclusiveKL(FullRankGaussian) + RMSProp steps (rtol 1e-9)."""
    shape, names = MESHES[mesh_name]
    n_fsdp, n_mc = shape[0], (shape[1] if len(shape) > 1 else 1)
    keys = [jax.random.PRNGKey(10 + k) for k in range(STEPS + 1)]
    draws = np.stack([jax_draws(key, n_mc) for key in keys])
    np.save(tmp_path / "draws.npy", draws)
    model = vj.zoo.logistic_regression(dim=D, n_data=40)[0]
    mc = "mc" if n_mc > 1 else None

    def jax_trainer(jitter):
        trainer = JaxFSDP(D, model, S, jax_mesh(shape, names), mc_axis=mc,
                          learning_rate=LR, jitter=jitter)
        params = trainer.init_params(jnp.float64)
        return trainer, params, trainer.init_opt_state(params)

    trainer, params, state = jax_trainer(1e-300)
    params, state, values_j = jax_steps(trainer, params, state, keys[:STEPS])
    np.savez(tmp_path / "jax_state.npz", mu=np.asarray(params[0]),
             theta=np.asarray(params[1]), nu_mu=np.asarray(state[0]),
             nu_theta=np.asarray(state[1]), t=np.asarray(state[2]))
    params_j = [np.asarray(x) for x in params]
    next_j, _, _ = jax_steps(trainer, params, state, keys[STEPS:])
    trainer, params, state = jax_trainer(1e-8)
    _, state1_j, _ = jax_steps(trainer, params, state, keys[:1])

    ranks = run_ranks(tmp_path, CHILD_SOURCE,
                      dict(shape=shape, names=names, draws=str(tmp_path / "draws.npy"),
                           jax_state=str(tmp_path / "jax_state.npz")),
                      world=n_fsdp * n_mc)
    rows = D // n_fsdp
    for r in ranks:
        f = r["rank"] // n_mc  # DeviceMesh is row-major, as JAX's Mesh
        assert r["rows"] == list(range(f * rows, (f + 1) * rows))
        for name in ("plain", "pipelined"):
            for got, want in zip(r[name]["params"], ranks[0][name]["params"]):
                np.testing.assert_array_equal(got, want)
    got = ranks[0]
    assert_pair(got["plain"]["params"], params_j)
    np.testing.assert_allclose(got["plain"]["values"], values_j, rtol=RTOL)
    assert_pair(got["continued"], next_j)
    # the reference's n_fsdp-scaled gradient: its nu is n_fsdp**2 the port's
    assert_pair([n_fsdp**2 * x for x in got["nu"]], state1_j[:2], rtol=1e-12, atol=0)
    assert np.abs(got["nu"][1]).max() > 0
    assert_pair(got["pipelined"]["params"], got["plain"]["params"])
    np.testing.assert_allclose(got["pipelined"]["values"], got["plain"]["values"],
                               rtol=RTOL)
    assert_pair(got["plain"]["params"], got["one_rank"]["params"])
    np.testing.assert_allclose(got["plain"]["values"], got["one_rank"]["values"],
                               rtol=RTOL)
    assert_pair(got["one_rank"]["params"], got["unsharded"]["params"])
    np.testing.assert_allclose(got["one_rank"]["values"], got["unsharded"]["values"],
                               rtol=RTOL)
    assert np.all(np.triu(got["plain"]["params"][1], 1) == 0)  # upper part untouched


@pytest.mark.parametrize("case", ["dim", "samples", "pipeline_divides",
                                  "pipeline_positive", "no_fsdp_axis"])
def test_fsdp_trainer_rejects_what_jax_rejects(case):
    """The constructor's refusals on a (fsdp=4, mc=2) mesh, in both
    packages alike (tests/test_parallel.py's divisibility checks): dim 6
    over 4 rows, 7 samples over 2, a pipeline of 3 chunks over 4 local
    samples, a pipeline of 0, and a mesh without the fsdp axis (KeyError,
    the JAX package's mesh.shape[axis])."""
    import viabel_torch as vt
    from viabel_torch.parallel import FSDPFullRankELBO
    jmodel = vj.zoo.correlated_gaussian(6)[0]
    tmodel = vt.zoo.correlated_gaussian(6, device="cpu", dtype=torch.float64)[0]
    args, kw, error, match = {
        "dim": ((6, 8), {}, ValueError, "not divisible"),
        "samples": ((8, 7), {}, ValueError, "not divisible"),
        "pipeline_divides": ((8, 8), {"gather_pipeline": 3}, ValueError, "gather_pipeline"),
        "pipeline_positive": ((8, 8), {"gather_pipeline": 0}, ValueError, "positive"),
        "no_fsdp_axis": ((8, 8), {"fsdp_axis": "rows"}, KeyError, "rows"),
    }[case]
    d, n = args
    with pytest.raises(error, match=match):
        JaxFSDP(d, jmodel, n, jax_mesh((4, 2), ("fsdp", "mc")), mc_axis="mc", **kw)
    with pytest.raises(error, match=match):
        FSDPFullRankELBO(d, tmodel, n, StandIn((4, 2), ("fsdp", "mc")), mc_axis="mc", **kw)


def test_fsdp_shard_and_gather_layout():
    """On a stand-in rank 0 of (fsdp=2,): the shard is rows [0, d/2) of
    mu = 0 and theta = init_log_diag * I, shard_params cuts the same rows
    of whole arrays, and a draws block of the wrong shape raises."""
    import viabel_torch as vt
    from viabel_torch.parallel import FSDPFullRankELBO
    model = vt.zoo.correlated_gaussian(6, device="cpu", dtype=torch.float64)[0]
    trainer = FSDPFullRankELBO(6, model, 4, StandIn((2,), ("fsdp",)), init_log_diag=-0.5)
    mu, theta = trainer.init_params(torch.float64)
    assert list(trainer.rows) == [0, 1, 2]
    assert mu.shape == (3,) and theta.shape == (3, 6)
    np.testing.assert_array_equal(theta.numpy(), -0.5 * np.eye(6)[:3])
    whole = np.arange(36.0).reshape(6, 6)
    mu_s, theta_s = trainer.shard_params(np.arange(6.0), whole)
    np.testing.assert_array_equal(theta_s.numpy(), whole[:3])
    assert mu_s.dtype == torch.float64 and mu_s.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="expected shape"):
        trainer.shard_params(np.zeros(5), whole)
    state = trainer.init_opt_state((mu, theta))
    with pytest.raises(ValueError, match="draws must be"):
        trainer.step((mu, theta), state, draws=np.zeros((3, 6)))
