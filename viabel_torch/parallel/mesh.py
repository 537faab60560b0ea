"""Process groups and device meshes (counterpart of
``viabel_tpu/parallel/mesh.py``).

The Monte Carlo sample axis (``"mc"``) is the data-parallel axis of a VI
workload: every rank draws its share of a step's samples and one
all-reduce combines the value and the gradient
(:func:`viabel_torch.parallel.shard_mc_objective`). Where the JAX package
has a ``jax.sharding.Mesh`` over devices, the port has a
``torch.distributed`` process group, one process a device, and a
``DeviceMesh`` over its ranks.

Under ``torchrun`` each process calls :func:`distributed_init` (which reads
the address, rank and world size that ``torchrun`` sets) and then
:func:`make_mesh`. Without ``torchrun``, pass the address and the rank
yourself, e.g. ``distributed_init("tcp://127.0.0.1:29500", world_size=1,
rank=0)``.
"""

import os

import torch
import torch.distributed as dist

from ..utils import check_device

__all__ = ["make_mesh", "distributed_init"]

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
