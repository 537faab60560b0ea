"""The STL score solve ``L(theta)^{-T} B`` (CUDA kernel + plain version).

Counterpart of ``stl_transpose_solve`` in ``viabel_tpu/ops/trsm.py``: the
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
