"""Carry state from the JAX package into the port.

The flat variational-parameter layouts are shared, so these are checked
copies. They take numpy arrays (or anything ``np.asarray`` reads, such as
JAX arrays) and never import JAX. A FASO checkpoint that the JAX package
wrote loads with :func:`viabel_torch.checkpoint.load_pytree` (the JAX
state as the template) and :func:`resume_state_from_jax` makes it a
resume state of the port.
"""

import numpy as np
import torch

from .families import (LRGaussian, NeuralNet, NVPFlow, _CholeskyFamily,
                       _MeanFieldLocScale)
from .utils import check_device

__all__ = ["params_from_jax", "rmsprop_state_from_jax", "opt_state_from_jax",
           "ring_from_jax", "obj_state_from_jax", "resume_state_from_jax",
           "fsdp_params_from_jax", "fsdp_opt_state_from_jax"]

_KNOWN_LAYOUTS = (_CholeskyFamily, _MeanFieldLocScale, LRGaussian, NeuralNet, NVPFlow)


def params_from_jax(var_param, approx, device=None, dtype=None):
    """A JAX flat variational parameter as a tensor for ``approx``:
    length ``dim + dim**2`` for a full-rank (Cholesky) family
    (``FullRankGaussian``, ``MultivariateT``), ``2 * dim`` for a mean-field
    one (``MFGaussian``, ``MFStudentT``), ``2 * dim + dim * k`` for
    ``LRGaussian``, the per-layer ``(W, b)`` pairs for ``NeuralNet`` and
    the per-coupling ``(t, s)`` networks for ``NVPFlow``: in every case
    the family's ``var_param_dim``. ``device``/``dtype`` default to the
    family's."""
    vp = np.asarray(var_param)
    if vp.ndim != 1:
        raise ValueError(f"expected a flat parameter, got shape {vp.shape}")
    if not isinstance(approx, _KNOWN_LAYOUTS):
        raise TypeError(f"no parameter layout known for {type(approx).__name__}")
    want = approx.var_param_dim
    if vp.shape[0] != want:
        raise ValueError(f"{type(approx).__name__}({approx.dim}) takes {want} "
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


def obj_state_from_jax(state, approx, device=None, dtype=None):
    """A JAX objective state as the port's: DISInclusiveKL's dict (``eps``,
    ``ok``, and with resampling the ``samples``/``w_norm``/``w_sum``
    cache on the device, the ``step`` counter as a CPU tensor), or the
    empty state ``{}`` of a stateless objective. ``device``/``dtype``
    default to the family's."""
    if not isinstance(state, dict) or not state:
        return {}
    device = check_device(device or approx.device)
    dtype = dtype or approx.dtype
    out = {}
    for name, value in state.items():
        value = np.asarray(value)
        if name == "step":
            out[name] = torch.tensor(int(value))
        elif name == "ok":
            out[name] = torch.tensor(bool(value), device=device)
        elif name in ("eps", "samples", "w_norm", "w_sum"):
            out[name] = torch.as_tensor(value.copy(), dtype=dtype, device=device)
        else:
            raise ValueError(f"no objective-state entry {name!r} is known")
    return out


_RESUME_INTS = ("t", "k", "k_conv", "k_Rhat", "W_check", "check_interval",
                "next_check_at", "interval_adjusted_at", "mc_samples",
                "mc_escalated_at")


def resume_state_from_jax(rs, approx, sgo, device=None, dtype=None):
    """A JAX FASO ``resume_state`` (in memory, or read back with
    :func:`viabel_torch.checkpoint.load_pytree`) as the port's: the
    parameter and the iterate average by :func:`params_from_jax`'s layout,
    the packed ring by :func:`ring_from_jax`, the step-rule state by
    :func:`opt_state_from_jax` (it must have the entries of
    ``sgo.init_state``), the objective state by
    :func:`obj_state_from_jax`, the counters as Python numbers and the
    in-flight R-hat verdicts as host arrays. The JAX PRNG key is dropped:
    the port's run continues the generator the caller passes."""
    device = check_device(device or approx.device)
    dtype = dtype or approx.dtype
    var_param = params_from_jax(rs["var_param"], approx, device=device, dtype=dtype)
    D = var_param.shape[0]
    opt_state = (opt_state_from_jax(rs["opt_state"], dim=D, device=device, dtype=dtype)
                 if isinstance(rs["opt_state"], dict) else {})
    want = set(sgo.init_state(var_param))
    if set(opt_state) != want:
        raise ValueError(f"the JAX step-rule state has entries {sorted(opt_state)}; "
                         f"{type(sgo).__name__} keeps {sorted(want)}")
    out = {
        "var_param": var_param,
        "opt_state": opt_state,
        "obj_state": obj_state_from_jax(rs.get("obj_state", {}), approx,
                                        device=device, dtype=dtype),
        "ring": ring_from_jax(rs["ring"], D, device=device, dtype=dtype),
        "iterate_average": torch.as_tensor(
            np.asarray(rs["iterate_average"]).copy(), device=device, dtype=dtype),
        "total_opt_time": float(np.asarray(rs["total_opt_time"])),
        "pending_checks": [
            {"k": int(np.asarray(ck["k"])), "windows": np.asarray(ck["windows"]),
             "r_hats": np.asarray(ck["r_hats"])} for ck in rs.get("pending_checks", [])],
    }
    for name in _RESUME_INTS:
        if name in rs:
            out[name] = int(np.asarray(rs[name]))
    for name in ("mc_plateau", "mc_plateau_mcse", "mc_events"):
        if name in rs:
            out[name] = np.asarray(rs[name])
    return out


def fsdp_params_from_jax(mu, theta, trainer):
    """The global ``(mu, theta)`` arrays of a JAX ``FSDPFullRankELBO`` as
    this rank's shard of ``trainer`` (a
    :class:`viabel_torch.parallel.FSDPFullRankELBO`), in their dtype."""
    return trainer.shard_params(np.asarray(mu), np.asarray(theta))


def fsdp_opt_state_from_jax(state, trainer, jax_fsdp_size):
    """A JAX ``FSDPFullRankELBO`` opt state ``(nu_mu, nu_theta, t)`` (global
    arrays) as this rank's shard of ``trainer``'s. The JAX step's gradient
    is ``jax_fsdp_size`` times the true one (its ``fsdp`` axis size; a
    known defect of the reference, ROADMAP.md Queue 3), so its ``nu`` is
    divided by ``jax_fsdp_size**2``."""
    nu_mu, nu_theta, t = state
    scale = float(jax_fsdp_size) ** 2
    nu_mu, nu_theta = trainer.shard_params(np.asarray(nu_mu) / scale,
                                           np.asarray(nu_theta) / scale)
    return nu_mu, nu_theta, int(np.asarray(t))
