"""Carry state from the JAX package into the port.

The flat variational-parameter layouts are shared, so these are checked
copies. They take numpy arrays (or anything ``np.asarray`` reads, such as
JAX arrays) and never import JAX.
"""

import numpy as np
import torch

from .families import LRGaussian, _CholeskyFamily, _MeanFieldLocScale
from .utils import check_device

__all__ = ["params_from_jax", "rmsprop_state_from_jax", "opt_state_from_jax",
           "ring_from_jax"]


def params_from_jax(var_param, approx, device=None, dtype=None):
    """A JAX flat variational parameter as a tensor for ``approx``:
    length ``dim + dim**2`` for a full-rank (Cholesky) family
    (``FullRankGaussian``, ``MultivariateT``), ``2 * dim`` for a mean-field
    one (``MFGaussian``, ``MFStudentT``), ``2 * dim + dim * k`` for
    ``LRGaussian``. ``device``/``dtype`` default to the family's."""
    vp = np.asarray(var_param)
    if vp.ndim != 1:
        raise ValueError(f"expected a flat parameter, got shape {vp.shape}")
    d = approx.dim
    if isinstance(approx, _CholeskyFamily):
        want = d + d * d
    elif isinstance(approx, _MeanFieldLocScale):
        want = 2 * d
    elif isinstance(approx, LRGaussian):
        want = 2 * d + d * approx.k
    else:
        raise TypeError(f"no parameter layout known for {type(approx).__name__}")
    if vp.shape[0] != want:
        raise ValueError(f"{type(approx).__name__}({d}) takes {want} "
                         f"parameters, got {vp.shape[0]}")
    return torch.as_tensor(vp.copy(), dtype=dtype or approx.dtype,
                           device=device or approx.device)


def rmsprop_state_from_jax(state, device="cuda", dtype=None):
    """A JAX ``RMSProp``/``AveragedRMSProp`` state dict as the port's."""
    return opt_state_from_jax(state, device=device, dtype=dtype)


def opt_state_from_jax(state, dim=None, device="cuda", dtype=None):
    """A JAX step-rule state dict as the port's, for every rule of
    :mod:`viabel_torch.optimizers`: the moments (``momentum``,
    ``avg_grad_sq``, ``sum_grad_sq``) as tensors, the step count ``t`` as
    an int, and ``WindowedAdagrad``'s packed ``(W, 8, C)`` ``ring`` as the
    port's ``(W, dim)`` ring (:func:`ring_from_jax`; ``dim`` is then
    required)."""
    device = check_device(device)
    out = {}
    for name, value in state.items():
        if name == "t":
            out[name] = int(np.asarray(value))
        elif name == "ring":
            if dim is None:
                raise ValueError("a WindowedAdagrad state needs dim")
            out[name] = ring_from_jax(value, dim, device=device, dtype=dtype)
        elif name in ("momentum", "avg_grad_sq", "sum_grad_sq"):
            out[name] = torch.as_tensor(np.asarray(value).copy(), device=device,
                                        dtype=dtype or torch.float64)
        else:
            raise ValueError(f"no step-rule state entry {name!r} is known")
    return out


def ring_from_jax(packed, D, device="cuda", dtype=None):
    """A packed ``(R, 8, C)`` JAX history ring as the port's ``(R, D)``
    ring: the row-major flattening of ``utils.unpack_rows``."""
    packed = np.asarray(packed)
    if packed.ndim != 3 or packed.shape[1] != 8 or 8 * packed.shape[2] < D:
        raise ValueError(f"expected a packed (R, 8, C) ring holding {D} "
                         f"coordinates, got shape {packed.shape}")
    flat = packed.reshape(packed.shape[0], -1)[:, :D]
    return torch.as_tensor(flat.copy(), device=check_device(device),
                           dtype=dtype or torch.float64)
