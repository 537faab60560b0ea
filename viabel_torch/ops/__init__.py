"""Hand-written CUDA kernels of the port, each beside its plain version.

Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version,
a CUDA tensor launches the kernel or raises. There is no switch that
forces the plain version on a CUDA tensor.
"""

from ._build import build_info, launch_counts, load_library, reset_launch_counts
from .ringstats import ring_group_stats, ring_group_stats_plain
from .trsm import (KERNEL_MAX_DIM, stl_transpose_solve, stl_transpose_solve_plain,
                   vmem_solve_triangular, vmem_solve_triangular_plain)

__all__ = ["ring_group_stats", "ring_group_stats_plain", "stl_transpose_solve",
           "stl_transpose_solve_plain", "vmem_solve_triangular",
           "vmem_solve_triangular_plain", "KERNEL_MAX_DIM", "load_library",
           "build_info", "launch_counts", "reset_launch_counts"]
