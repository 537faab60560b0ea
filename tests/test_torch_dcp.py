"""The Orbax pair over ``torch.distributed.checkpoint`` in one process with
no process group (tests/test_checkpoint.py's round trip, overwrite and
real ``resume_state`` through both backends), and the sharded engines'
refusals, each raised before any collective: a restart or path count
that does not divide and a mesh without the named axis (the JAX
package's exception), and a resume from one rank's share of a sharded
state that was not joined with ``merge_resume_states`` or from a state
of another run. A stand-in object plays a two-rank mesh: the refusals
read only its axis names and sizes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402
from viabel_torch.checkpoint import (_flatten, load_pytree, load_pytree_orbax,  # noqa: E402
                                     save_pytree, save_pytree_orbax)
from viabel_torch.parallel import (multistart_faso, multistart_optimize,  # noqa: E402
                                   multistart_raabbvi)
from viabel_torch.parallel.mesh import column_split  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)


class TwoRanks:
    """What the engines read of a two-rank mesh before any collective."""

    def __init__(self, *names):
        self.mesh_dim_names = names

    def size(self, dim=None):
        return 2

    def get_local_rank(self, name=None):
        return 0

    def get_group(self, name=None):
        return None


def leaves_equal(a, b):
    fa, fb = list(_flatten(a)), list(_flatten(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, (torch.Tensor, bool, int, float, str)):
            assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))
            assert np.asarray(x).dtype == np.asarray(y).dtype, path


def test_dcp_round_trip_and_overwrite(tmp_path):
    """Tensors, numpy arrays and scalars, Python scalars and strings, an
    empty tuple and None round-trip with their kinds and dtypes; a second
    save overwrites the first; without a template the saved structure
    comes back; a template of another shape raises ValueError (the JAX
    package's Orbax restore does)."""
    tree = {"a": torch.arange(5.0, dtype=torch.float64), "b": {"c": torch.ones(2, 3), "d": 7},
            "e": [torch.tensor(1.5), np.array([True, False])], "k": np.int64(12),
            "s": "name", "flight": (), "none": None, "u8": torch.arange(4, dtype=torch.uint8)}
    path = str(tmp_path / "ckpt")
    save_pytree_orbax(path, {"old": torch.zeros(3)})
    save_pytree_orbax(path, tree)
    restored = load_pytree_orbax(path, like=tree)
    leaves_equal(restored, tree)
    assert restored["flight"] == () and restored["none"] is None
    plain = load_pytree_orbax(path, device="cpu")
    assert set(plain) == {"a", "b", "e", "k", "s", "u8"}
    assert torch.equal(plain["b"]["c"], tree["b"]["c"]) and plain["b"]["d"] == 7
    with pytest.raises(ValueError, match="stored shape"):
        load_pytree_orbax(path, like={**tree, "a": torch.zeros(6)})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree_orbax(path, like={"a": tree["a"]})


def test_dcp_serializes_real_resume_state(tmp_path):
    """A real FASO resume snapshot (ring, control scalars, generator state,
    in-flight verdicts) restores identically through both backends, and
    resuming from it equals the uninterrupted run."""
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **F64)
    approx = vt.MFGaussian(2, **F64)
    obj = vt.ExclusiveKL(approx, model, 20)
    opt = vt.FASO(vt.RMSProp(0.05), W_min=100, k_check=50, mcse_threshold=0.05,
                  max_history=600)
    x0 = torch.zeros(4, **F64)
    part = opt.optimize(300, obj, x0, generator=torch.Generator().manual_seed(0))
    snap = part["resume_state"]
    assert snap["pending_checks"]
    save_pytree(str(tmp_path / "s.npz"), snap)
    save_pytree_orbax(str(tmp_path / "s_dcp"), snap)
    r_npz = load_pytree(str(tmp_path / "s.npz"), like=snap)
    r_dcp = load_pytree_orbax(str(tmp_path / "s_dcp"), like=snap)
    leaves_equal(r_dcp, r_npz)
    full = opt.optimize(900, obj, x0, generator=torch.Generator().manual_seed(0))
    resumed = opt.optimize(900, obj, x0, generator=torch.Generator(), resume_state=r_dcp)
    assert torch.equal(resumed["opt_param"], full["opt_param"])
    assert resumed["k_stopped"] == full["k_stopped"]


@pytest.mark.parametrize("D,n,dtype,bounds", [
    (1001000, 4, torch.float32, [0, 250248, 500496, 750744, 1001000]),
    (10, 2, torch.float64, [0, 4, 10]), (30, 2, torch.float64, [0, 14, 30]),
    (7, 1, torch.float32, [0, 7]), (3, 2, torch.float64, [0, 1, 3]),
    (2, 4, torch.float32, [0, 0, 1, 1, 2])])
def test_column_split_aligns_to_16_bytes(D, n, dtype, bounds):
    """Inner boundaries on multiples of 4 float32 or 2 float64 columns, the
    last shard taking the remainder; where that would leave a shard empty,
    the even split, with zero-width shards where D is below the rank
    count."""
    assert column_split(D, n, dtype) == bounds
    assert column_split(3, 2, torch.float32) == [0, 1, 3]


def _objective():
    model, dim = vt.zoo.funnel()
    return vt.ExclusiveKL(vt.MFGaussian(dim, **F64), model, 4), dim


@pytest.mark.parametrize("route", ["multistart_faso", "multistart_raabbvi",
                                   "multistart_optimize", "multipath_pathfinder"])
def test_counts_that_do_not_divide_raise(route):
    """Three restarts or paths over a two-rank axis: JAX's ValueError."""
    obj, dim = _objective()
    x0 = torch.zeros((3, 2 * dim), **F64)
    mesh = TwoRanks("restart")
    with pytest.raises(ValueError, match="divisible"):
        if route == "multistart_faso":
            multistart_faso(vt.RMSProp(0.05), 5, obj, x0, mesh=mesh)
        elif route == "multistart_raabbvi":
            multistart_raabbvi(vt.RMSProp(0.05), 5, obj, x0, mesh=mesh, schedule="async")
        elif route == "multistart_optimize":
            multistart_optimize(vt.RMSProp(0.05), 5, obj, x0, mesh=mesh)
        else:
            vt.multipath_pathfinder(obj.model, x0[:, :dim], mesh=mesh)


@pytest.mark.parametrize("route", ["FASO", "multistart_faso", "multistart_raabbvi_lockstep"])
def test_resume_on_another_mesh_shape_raises(route):
    """A resume state resumes on any mesh shape once whole; what still
    raises ValueError, before any collective: one rank's share of a
    two-rank state (FASO's ring columns, the multistart engines' rings)
    resumed without joining it (merge_resume_states), on either mesh
    shape, and a whole state of another D or restart count."""
    obj, dim = _objective()
    x0 = torch.zeros((2, 2 * dim), **F64)
    kw = dict(W_min=50, k_check=50, max_history=200)
    if route == "FASO":
        state = vt.FASO(vt.RMSProp(0.05), **kw).optimize(
            100, obj, x0[0], generator=torch.Generator())["resume_state"]
        D = x0.shape[1]
        share = {**state, "ring": state["ring"][:, 2:], "ring_columns": np.asarray([2, D, D])}

        def resume(rs, mesh=None, x=x0[0]):
            vt.FASO(vt.RMSProp(0.05), mesh=mesh, **kw).optimize(
                200, obj, x, generator=torch.Generator(), resume_state=rs)
    else:
        if route == "multistart_faso":
            state = multistart_faso(vt.RMSProp(0.05), 100, obj, x0, **kw)["resume_state"]
        else:
            state = multistart_raabbvi(vt.RMSProp(0.05), 100, obj, x0, schedule="async",
                                       verbose=False, **kw)["resume_state"]
        share = {**state, "rings": state["rings"][1:], "ring_restarts": np.asarray([1, 2, 2])}

        def resume(rs, mesh=None, x=x0):
            if route == "multistart_faso":
                multistart_faso(vt.RMSProp(0.05), 200, obj, x, resume_state=rs, mesh=mesh,
                                **kw)
            else:
                multistart_raabbvi(vt.RMSProp(0.05), 200, obj, x, schedule="async",
                                   resume_state=rs, verbose=False, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="merge_resume_states"):
        resume(share)
    with pytest.raises(ValueError, match="merge_resume_states"):
        resume(share, mesh=TwoRanks("mc" if route == "FASO" else "restart"))
    with pytest.raises(ValueError, match="this run has"):
        if route == "FASO":
            resume(state, x=torch.zeros(2 * dim + 2, **F64))
        else:
            resume(state, x=torch.zeros((4, 2 * dim), **F64))
