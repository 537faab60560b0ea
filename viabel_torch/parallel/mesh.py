"""Process groups and device meshes (counterpart of
``viabel_tpu/parallel/mesh.py``).

The Monte Carlo sample axis (``"mc"``) is the data-parallel axis of a VI
workload: every rank draws its share of a step's samples and one
all-reduce combines the value and the gradient
(:func:`viabel_torch.parallel.shard_mc_objective`). Where the JAX package
has a ``jax.sharding.Mesh`` over devices, the port has a
``torch.distributed`` process group, one process a device, and a
``DeviceMesh`` over its ranks.

:class:`MeshAxis` is one axis of such a mesh seen from this rank (its
size, this rank's coordinate, its process group and the collectives the
engines need over it), and :func:`column_split` is the coordinate split
of a history ring's columns over an axis.

Under ``torchrun`` each process calls :func:`distributed_init` (which reads
the address, rank and world size that ``torchrun`` sets) and then
:func:`make_mesh`. Without ``torchrun``, pass the address and the rank
yourself, e.g. ``distributed_init("tcp://127.0.0.1:29500", world_size=1,
rank=0)``.
"""

import hashlib
import os

import torch
import torch.distributed as dist

from ..utils import check_device

__all__ = ["make_mesh", "distributed_init", "MeshAxis", "column_split", "restart_axis_of"]

#: the variables ``torchrun`` sets for ``init_method="env://"``
_ENV_KEYS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def _local_devices(device_type):
    device = check_device(device_type)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def distributed_init(init_method=None, world_size=None, rank=None, backend=None,
                     device_type="cuda"):
    """Join a process group and return this process's local devices.

    ``torch.distributed.init_process_group`` is called only when an
    address is given (``init_method``, e.g. ``"tcp://host:port"`` or
    ``"file:///path"``) or found in the environment (``MASTER_ADDR``,
    ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them), and only once
    a process. A single process with neither returns the local devices
    untouched, so library code may call this unconditionally.

    ``backend`` defaults to NCCL on ``device_type="cuda"`` (which raises
    without a card) and gloo on ``"cpu"``. On CUDA each process takes the
    card of its local rank (``LOCAL_RANK``, else ``rank`` modulo the
    cards).
    """
    devices = _local_devices(device_type)
    from_env = all(key in os.environ for key in _ENV_KEYS)
    if init_method is None and not from_env:
        return devices
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is None:
            init_method = "env://"
        kwargs = {}
        if world_size is not None:
            kwargs["world_size"] = int(world_size)
        if rank is not None:
            kwargs["rank"] = int(rank)
        dist.init_process_group(backend, init_method=init_method, **kwargs)
    if devices[0].type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % len(devices)))
        torch.cuda.set_device(devices[local])
    return devices


def make_mesh(shape=None, axis_names=("mc",), device_type="cuda"):
    """A ``DeviceMesh`` over the ranks of the process group.

    ``shape`` defaults to every rank on one ``mc`` axis; ``axis_names``
    gives one name a mesh dimension. Code that takes the mesh reads an
    axis's size and this rank's coordinate from it, and the axis's
    process group with ``mesh.get_group(axis)``. Raises ``ValueError``
    when ``shape`` needs more ranks than the world has, or fewer (a
    ``DeviceMesh`` spans the whole group; the JAX package can take a
    subset of its devices), and when no process group was started
    (:func:`distributed_init`).
    """
    from torch.distributed.device_mesh import init_device_mesh
    check_device(device_type)
    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: call distributed_init "
                         "with an address first (or run under torchrun)")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis names, "
                         f"got {axis_names}")
    n = 1
    for size in shape:
        n *= size
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh shape {shape} covers {n} of the {world} ranks; a "
                         "DeviceMesh spans the whole process group")
    return init_device_mesh(torch.device(device_type).type, shape,
                            mesh_dim_names=axis_names)


def column_split(D, n, dtype):
    """Boundaries ``[0, b_1, ..., D]`` of ``D`` columns over ``n`` ranks.

    Every inner boundary is a multiple of 16 bytes' worth of columns (4 in
    float32, 2 in float64) and the last shard takes the remainder, so
    each shard of a contiguous ``(R, D)`` ring starts on a 16-byte
    boundary with a column count that kernel 1's vector path takes
    (``csrc/ringstats.cu``). Where that would leave a shard empty (fewer
    than 16 bytes of columns a rank), the split is the even one,
    ``[i * D // n]``, which kernel 1's scalar path runs; with ``D < n``
    some of its shards have no column."""
    D = int(D)
    align = max(1, 16 // torch.empty((), dtype=dtype).element_size())
    base = (D // n) // align * align
    if n > 1 and base == 0:
        return [i * D // n for i in range(n)] + [D]
    return [i * base for i in range(n)] + [D]


class MeshAxis:
    """One axis of a ``DeviceMesh`` seen from this rank: its size ``n``,
    this rank's ``coordinate`` and the axis's process group, with the
    collectives the sharded engines use over it. Each collective runs
    also at ``n = 1`` (where it changes nothing) except :meth:`agree`.

    ``mesh`` needs only ``mesh_dim_names``, ``size(dim)``,
    ``get_local_rank(name)`` and ``get_group(name)``. A mesh without the
    axis raises ``ValueError``."""

    def __init__(self, mesh, axis_name):
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise ValueError(f"mesh has no axis {axis_name!r} (axes {names})")
        self.name = axis_name
        self.n = mesh.size(names.index(axis_name))
        self.coordinate = mesh.get_local_rank(axis_name)
        self.group = mesh.get_group(axis_name)

    def local_count(self, S):
        """This rank's share of ``S`` samples."""
        if S % self.n:
            raise ValueError(f"num_mc_samples={S} must be divisible by the "
                             f"{self.name} axis size {self.n}")
        return S // self.n

    def _reduce(self, x, op):
        # in place: every caller passes a tensor of its own
        x = x.detach()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def sum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def gather(self, x, sizes=None):
        """Every rank's ``x`` concatenated along dim 0 in axis order.
        ``sizes`` (one a rank) allows uneven shards: each is padded to the
        widest and trimmed after the all-gather."""
        x = x.detach().contiguous()
        if sizes is None:
            sizes = [x.shape[0]] * self.n
        width = max(sizes)
        if x.shape[0] < width:
            x = torch.cat([x, x.new_zeros((width - x.shape[0],) + x.shape[1:])])
        parts = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat([p[:size] for p, size in zip(parts, sizes)])

    def rows(self, B):
        """This rank's rows of ``B`` split evenly over the axis."""
        per = B // self.n
        return range(self.coordinate * per, (self.coordinate + 1) * per)

    def gather_objects(self, obj):
        """Every rank's picklable ``obj``, a list in axis order. Tensors
        travel through the host."""
        out = [None] * self.n
        dist.all_gather_object(out, _to_host(obj), group=self.group)
        return out

    def agree(self, x):
        """Rank 0's ``x`` on every rank of the axis (one broadcast of a
        float64 scalar), so that a decision that reads a clock is taken
        alike on every rank; ``x`` itself on a one-rank axis."""
        if self.n == 1:
            return x
        # NCCL moves tensors on the current card only
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(self.group) == "nccl" else torch.device("cpu"))
        t = torch.tensor([float(x)], dtype=torch.float64, device=device)
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0), group=self.group)
        return float(t[0])

    def generator(self, generator):
        """The generator of this rank's draws in one step: seeded from the
        caller's generator state and this rank's coordinate (the JAX
        package's ``fold_in(key, axis_index)``). Every rank's caller
        generator is in the same state, so ranks draw apart and a rerun
        draws again what it drew. The caller's generator then advances by
        one draw, so the next step draws anew; nothing waits for the
        device."""
        state = generator.get_state().numpy().tobytes()
        digest = hashlib.blake2b(state + int(self.coordinate).to_bytes(8, "little"),
                                 digest_size=8).digest()
        local = torch.Generator(generator.device)
        local.manual_seed(int.from_bytes(digest, "little") >> 1)
        torch.empty(1, device=generator.device).normal_(generator=generator)
        return local


def restart_axis_of(mesh, restart_axis, B):
    """The restart axis of ``mesh`` for ``B`` restarts, with the JAX
    package's ``ValueError`` for a mesh without the axis and for a ``B``
    that does not divide."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if restart_axis not in names:
        raise ValueError(
            f"mesh has no '{restart_axis}' axis (axes: {names}); multistart shards "
            "RESTARTS — a coordinate-/mc-sharding mesh from single-run kwargs does "
            "not transfer (name a restart axis or pass restart_axis=)")
    axis = MeshAxis(mesh, restart_axis)
    if B % axis.n:
        raise ValueError(f"n_restarts={B} must be divisible by the {restart_axis} "
                         f"axis size {axis.n}")
    return axis


def _to_host(obj):
    """``obj`` with every tensor in it moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj
