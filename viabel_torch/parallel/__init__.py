"""Multistart engines and MC-sample data parallelism (counterpart of
``viabel_tpu/parallel``).

Ported: the multistart engines (:func:`multistart_optimize`,
:func:`multistart_faso`, :func:`multistart_raabbvi` on the lockstep and the
async schedule), on one device or with their restarts split over the
ranks of a mesh axis (``mesh=``), and the MC-sample axis over
``torch.distributed`` (:func:`make_mesh`, :func:`distributed_init`,
:class:`ShardedExclusiveKL`, :func:`shard_mc_objective`).
``FSDPFullRankELBO`` raises ``NotImplementedError`` pointing at ROADMAP.md.
"""

from ..utils import deferred_names
from .mesh import distributed_init, make_mesh
from .multistart import multistart_faso
from .raabbvi import multistart_raabbvi
from .sharded import ShardedExclusiveKL, multistart_optimize, shard_mc_objective

__all__ = ["make_mesh", "distributed_init", "ShardedExclusiveKL", "shard_mc_objective",
           "multistart_optimize", "multistart_faso", "multistart_raabbvi"]

__getattr__ = deferred_names(__name__, {"FSDPFullRankELBO": "13b"})
