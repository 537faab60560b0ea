"""Triangular solves (CUDA kernels + plain versions), the counterparts of
``viabel_tpu/ops/trsm.py``.

:func:`vmem_solve_triangular` is the generic ``T^{-1} B`` for a lower or
upper ``T`` (``csrc/tri_solve.cu``), reached through
:func:`viabel_torch.families._tri_solve`.

:func:`stl_transpose_solve` is the STL score solve ``L(theta)^{-T} B``: the
workhorse of the sticking-the-landing score gradient for Cholesky
families, ``dx = -L^{-T} z``. ``theta`` is the raw dense Cholesky
parameter block (strict lower triangle + log diagonal, the
:class:`viabel_torch.families.FullRankGaussian` layout) read straight
from the variational parameter; the CUDA kernel (``csrc/stl_solve.cu``)
forms the factor on the fly and never stores it. Not differentiable (STL
applies it under stopped parameters).

The XLA:TPU workarounds of the JAX module (``blocked_solve_triangular``,
the Newton-inverted diagonal blocks) are not ported: PyTorch has
``torch.linalg.solve_triangular``.
"""

import torch

from . import _build

__all__ = ["stl_transpose_solve", "stl_transpose_solve_plain",
           "vmem_solve_triangular", "vmem_solve_triangular_plain",
           "KERNEL_MAX_DIM"]

#: largest d the kernel takes: the TPU kernel's range (trsm.py:_VMEM_MAX_DIM)
KERNEL_MAX_DIM = 1536


def cholesky_factor(theta):
    """``L = tril(theta, -1) + diag(exp(diag theta))``."""
    return torch.tril(theta, -1) + torch.diag(torch.exp(torch.diagonal(theta)))


def stl_transpose_solve_plain(theta, B):
    """Plain PyTorch version: form ``L``, then one triangular solve."""
    L = cholesky_factor(theta)
    return torch.linalg.solve_triangular(L.T, B, upper=True)


def stl_transpose_solve(theta, B):
    """Solve ``L(theta)^T X = B`` for ``theta`` ``(d, d)``, ``B`` ``(d, S)``.

    A CPU ``theta`` takes the plain version; a CUDA ``theta`` launches the
    kernel, which takes float32/float64, contiguous inputs and
    ``d <= KERNEL_MAX_DIM``.
    """
    if theta.dim() != 2 or theta.shape[0] != theta.shape[1]:
        raise ValueError("theta must be square (d, d)")
    d = theta.shape[0]
    if B.dim() != 2 or B.shape[0] != d:
        raise ValueError(f"B must be ({d}, S), got {tuple(B.shape)}")
    if theta.device.type == "cpu":
        return stl_transpose_solve_plain(theta, B)
    if not theta.is_cuda or B.device != theta.device:
        raise ValueError("theta and B must lie on one CUDA device")
    if theta.dtype not in (torch.float32, torch.float64) or B.dtype != theta.dtype:
        raise TypeError("stl_transpose_solve takes float32 or float64 theta and B")
    if d > KERNEL_MAX_DIM:
        raise ValueError(f"stl_transpose_solve supports d <= {KERNEL_MAX_DIM}")
    if not (theta.is_contiguous() and B.is_contiguous()):
        raise ValueError("theta and B must be contiguous")
    S = B.shape[1]
    lib = _build.load_library()
    X = torch.empty((d, S), dtype=B.dtype, device=B.device)
    fn = (lib.viabel_stl_transpose_solve_f32 if theta.dtype == torch.float32
          else lib.viabel_stl_transpose_solve_f64)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    _build.check(fn(theta.data_ptr(), B.data_ptr(), X.data_ptr(), d, S, stream),
                 "stl_transpose_solve")
    _build.count_launch("stl_transpose_solve")
    return X


def vmem_solve_triangular_plain(T, B, lower=True):
    """Plain PyTorch version: ``torch.linalg.solve_triangular``."""
    return torch.linalg.solve_triangular(T, B, upper=not lower)


def vmem_solve_triangular(T, B, lower=True):
    """Solve ``T X = B`` for a lower (or upper) triangular ``T`` ``(d, d)``
    and ``B`` ``(d, S)``; the other triangle of ``T`` is never read.

    The name is the JAX package's (``vmem_solve_triangular``, whose Pallas
    kernel keeps the whole triangle in the TPU's VMEM) so that a reader
    finds the counterpart; its ``nb`` and ``fast_iters`` tune the TPU's
    Newton-inverted blocks and have no counterpart here. A CPU ``T`` takes
    the plain version; a CUDA ``T`` launches the kernel, which takes
    float32/float64 and ``d <= KERNEL_MAX_DIM``. ``T`` is handed to the
    kernel column-major: a transposed view of a contiguous tensor as it is,
    anything else as a copy. ``B`` may have any strides; ``X`` takes
    ``B``'s layout.
    """
    if T.dim() != 2 or T.shape[0] != T.shape[1]:
        raise ValueError("T must be square (d, d)")
    d = T.shape[0]
    if B.dim() != 2 or B.shape[0] != d:
        raise ValueError(f"B must be ({d}, S), got {tuple(B.shape)}")
    if T.device.type == "cpu":
        return vmem_solve_triangular_plain(T, B, lower)
    if not T.is_cuda or B.device != T.device:
        raise ValueError("T and B must lie on one CUDA device")
    if T.dtype not in (torch.float32, torch.float64) or B.dtype != T.dtype:
        raise TypeError("vmem_solve_triangular takes float32 or float64 T and B")
    if d > KERNEL_MAX_DIM:
        raise ValueError(f"vmem_solve_triangular supports d <= {KERNEL_MAX_DIM}")
    S = B.shape[1]
    X = torch.empty_like(B)
    T_cm = T.mT.contiguous()  # T column-major: no copy for a transposed view
    lib = _build.load_library()
    fn = (lib.viabel_tri_solve_f32 if T.dtype == torch.float32
          else lib.viabel_tri_solve_f64)
    stream = torch.cuda.current_stream(T.device).cuda_stream
    _build.check(fn(T_cm.data_ptr(), B.data_ptr(), X.data_ptr(), d, S,
                    B.stride(0), B.stride(1), X.stride(0), X.stride(1),
                    int(bool(lower)), stream), "vmem_solve_triangular")
    _build.count_launch("vmem_solve_triangular")
    return X
