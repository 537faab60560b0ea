"""Group statistics of FASO's history ring (CUDA kernel + plain version).

Counterpart of ``viabel_tpu/ops/ringstats.py``. Convergence checks need,
for every ``group``-row block ``g`` of the ``(R, D)`` ring,

    GS[g] = sum_{r in block g} (ring[r] - center)
    GQ[g] = sum_{r in block g} (ring[r] - center)**2

from which cumulative sums give every candidate window's half-chain
moments (:func:`viabel_torch.mc_diagnostics.split_rhat_ring_windows`).
The CUDA kernel (``csrc/ringstats.cu``) computes both in one read of the
ring. The ring is a plain ``(R, D)`` tensor: the TPU's ``(8, C)`` packing
has no purpose on a GPU.
"""

import torch

from . import _build

__all__ = ["ring_group_stats", "ring_group_stats_plain", "colsum"]


def colsum(x, dim=0):
    """``x.sum(dim)`` with each column summed as it is in any column shard
    of ``x``. On the CPU the reduced axis is made the contiguous last one
    first: a CPU sum over an outer axis rounds by the column count, and a
    ring split over ranks (``FASO(mesh=...)``) must sum each column as the
    whole ring does."""
    if x.device.type == "cpu":
        return x.movedim(dim, -1).contiguous().sum(dim=-1)
    return x.sum(dim=dim)


def ring_group_stats_plain(ring, center, group):
    """Plain PyTorch version: reshape and sum (mc_diagnostics.py:318-320
    of the JAX package, on an unpacked ring)."""
    R = ring.shape[0]
    x = (ring - center).reshape(R // group, group, *ring.shape[1:])
    return colsum(x, dim=1), colsum(x * x, dim=1)


def ring_group_stats(ring, center, group):
    """Per-group sums of centered values and squares in one ring read.

    ``ring``: ``(R, D)`` float32/float64 with ``R % group == 0``;
    ``center``: ``(D,)``. Returns ``(GS, GQ)``, each ``(R // group, D)``.
    A CPU ring takes the plain version; a CUDA ring launches the kernel.
    """
    group = int(group)
    if ring.dim() != 2:
        raise ValueError("ring must be (R, D)")
    R, D = ring.shape
    if group <= 0 or R % group:
        raise ValueError("ring rows must be a multiple of `group`")
    if center.shape != (D,):
        raise ValueError(f"center must be ({D},), got {tuple(center.shape)}")
    if ring.device.type == "cpu":
        return ring_group_stats_plain(ring, center, group)
    if not ring.is_cuda or center.device != ring.device:
        raise ValueError("ring and center must lie on one CUDA device")
    if ring.dtype not in (torch.float32, torch.float64) or center.dtype != ring.dtype:
        raise TypeError("ring_group_stats takes float32 or float64 ring and center")
    if not (ring.is_contiguous() and center.is_contiguous()):
        raise ValueError("ring and center must be contiguous")
    lib = _build.load_library()
    GS = torch.empty((R // group, D), dtype=ring.dtype, device=ring.device)
    GQ = torch.empty_like(GS)
    fn = (lib.viabel_ring_group_stats_f32 if ring.dtype == torch.float32
          else lib.viabel_ring_group_stats_f64)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    _build.check(fn(ring.data_ptr(), center.data_ptr(), GS.data_ptr(),
                    GQ.data_ptr(), R, D, group, stream), "ring_group_stats")
    _build.count_launch("ring_group_stats")
    return GS, GQ
