"""Carry state from the JAX package into the port.

The flat variational-parameter layouts are shared, so these are checked
copies. They take numpy arrays (or anything ``np.asarray`` reads, such as
JAX arrays) and never import JAX.
"""

import numpy as np
import torch

from .families import FullRankGaussian, MFGaussian

__all__ = ["params_from_jax", "rmsprop_state_from_jax", "ring_from_jax"]


def params_from_jax(var_param, approx, device=None, dtype=None):
    """A JAX flat variational parameter as a tensor for ``approx``:
    length ``dim + dim**2`` for a full-rank (Cholesky) family, ``2 * dim``
    for ``MFGaussian``. ``device``/``dtype`` default to the family's."""
    vp = np.asarray(var_param)
    if vp.ndim != 1:
        raise ValueError(f"expected a flat parameter, got shape {vp.shape}")
    d = approx.dim
    if isinstance(approx, FullRankGaussian):
        want = d + d * d
    elif isinstance(approx, MFGaussian):
        want = 2 * d
    else:
        raise TypeError(f"no parameter layout known for {type(approx).__name__}")
    if vp.shape[0] != want:
        raise ValueError(f"{type(approx).__name__}({d}) takes {want} "
                         f"parameters, got {vp.shape[0]}")
    return torch.as_tensor(vp.copy(), dtype=dtype or approx.dtype,
                           device=device or approx.device)


def rmsprop_state_from_jax(state, device="cpu", dtype=None):
    """A JAX ``RMSProp``/``AveragedRMSProp`` state dict as the port's."""
    nu = np.asarray(state["avg_grad_sq"])
    return {"avg_grad_sq": torch.as_tensor(nu.copy(), device=device,
                                           dtype=dtype or torch.float64),
            "t": int(np.asarray(state["t"]))}


def ring_from_jax(packed, D, device="cpu", dtype=None):
    """A packed ``(R, 8, C)`` JAX history ring as the port's ``(R, D)``
    ring: the row-major flattening of ``utils.unpack_rows``."""
    packed = np.asarray(packed)
    if packed.ndim != 3 or packed.shape[1] != 8 or 8 * packed.shape[2] < D:
        raise ValueError(f"expected a packed (R, 8, C) ring holding {D} "
                         f"coordinates, got shape {packed.shape}")
    flat = packed.reshape(packed.shape[0], -1)[:, :D]
    return torch.as_tensor(flat.copy(), device=device,
                           dtype=dtype or torch.float64)
