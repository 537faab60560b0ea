"""Multistart engines, MC-sample data parallelism and the parameter-sharded
trainer (counterpart of ``viabel_tpu/parallel``).

The multistart engines (:func:`multistart_optimize`,
:func:`multistart_faso`, :func:`multistart_raabbvi` on the lockstep and the
async schedule), on one device or with their restarts split over the
ranks of a mesh axis (``mesh=``); the MC-sample axis over
``torch.distributed`` (:func:`make_mesh`, :func:`distributed_init`,
:class:`ShardedExclusiveKL`, :func:`shard_mc_objective`); and
:class:`FSDPFullRankELBO`, the full-rank family's rows split over ranks.
"""

from .fsdp import FSDPFullRankELBO
from .mesh import distributed_init, make_mesh
from .multistart import multistart_faso
from .raabbvi import multistart_raabbvi
from .sharded import ShardedExclusiveKL, multistart_optimize, shard_mc_objective

__all__ = ["make_mesh", "distributed_init", "ShardedExclusiveKL", "shard_mc_objective",
           "multistart_optimize", "multistart_faso", "multistart_raabbvi",
           "FSDPFullRankELBO"]
