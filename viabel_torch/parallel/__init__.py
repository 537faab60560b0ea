"""Multistart engines (counterpart of ``viabel_tpu/parallel``).

The single-device engines are ported: :func:`multistart_optimize`,
:func:`multistart_faso` and the lockstep :func:`multistart_raabbvi`. The
distributed ones (``make_mesh``, ``distributed_init``,
``ShardedExclusiveKL``, ``shard_mc_objective``, ``FSDPFullRankELBO``)
raise ``NotImplementedError`` pointing at ROADMAP.md.
"""

from ..utils import deferred_names
from .multistart import multistart_faso
from .raabbvi import multistart_raabbvi
from .sharded import multistart_optimize

__all__ = ["multistart_optimize", "multistart_faso", "multistart_raabbvi"]

__getattr__ = deferred_names(__name__, {name: "13b" for name in (
    "make_mesh", "distributed_init", "ShardedExclusiveKL", "shard_mc_objective",
    "FSDPFullRankELBO")})
