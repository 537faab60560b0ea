"""The mean-field Gaussian's sticking-the-landing draw and score (CUDA
kernels + plain versions).

:class:`viabel_torch.families.MFGaussian` draws ``x = mu + sigma z`` and
scores it by ``log q`` at stopped parameters. :func:`mf_stl_forward` gives
both from the base normals ``z`` in one pass (``csrc/mf_stl.cu``), the
value through the identity ``(x - mu) / sigma = z``; :func:`mf_stl_backward`
gives the parameters' gradient from the draws' and the scores' gradients in
one more. The JAX package has no kernel here (its step is plain XLA).
"""

import ctypes
import math

import torch

from . import _build

__all__ = ["mf_stl_forward", "mf_stl_forward_plain", "mf_stl_backward",
           "mf_stl_backward_plain"]

_LOG_2PI = math.log(2.0 * math.pi)


def mf_stl_forward_plain(var_param, z):
    """Plain PyTorch version: ``(x, log_q)``."""
    d = z.shape[1]
    mu, log_sigma = var_param[:d], var_param[d:]
    x = mu + torch.exp(log_sigma) * z
    log_q = (-0.5 * torch.sum(z * z, dim=1) - torch.sum(log_sigma)
             - 0.5 * d * _LOG_2PI)
    return x, log_q


def mf_stl_backward_plain(var_param, z, g_x, g_lq):
    """Plain PyTorch version: the ``(2 d,)`` gradient ``[d mu, d log_sigma]``
    of ``x = mu + sigma z`` and of ``log q`` at stopped parameters, ``d mu =
    sum_s G`` and ``d log_sigma = sigma sum_s G z`` with ``G = g_x - g_lq (x
    - mu) / sigma^2 = g_x - g_lq z / sigma``. ``g_x`` or ``g_lq`` may be None
    (zero). Written as the composite ``sample`` and ``log_density`` would
    differentiate it, so that under grad mode its own gradient is theirs."""
    d = z.shape[1]
    mu, sigma = var_param[:d], torch.exp(var_param[d:])
    G = torch.zeros_like(z) if g_x is None else g_x
    if g_lq is not None:
        x = mu + sigma * z
        s = sigma.detach()
        G = G - g_lq[:, None] * ((x - mu.detach()) / (s * s))
    return torch.cat([G.sum(dim=0), sigma * (G * z).sum(dim=0)])


def _check(var_param, z, g_x=None, g_lq=None):
    """Shapes and types first, then one device: whether it is the CPU."""
    if z.dim() != 2 or var_param.shape != (2 * z.shape[1],):
        raise ValueError(f"z must be (S, d) and var_param (2 d,), got {tuple(z.shape)} "
                         f"and {tuple(var_param.shape)}")
    if g_x is not None and g_x.shape != z.shape:
        raise ValueError(f"g_x must be {tuple(z.shape)}, got {tuple(g_x.shape)}")
    if g_lq is not None and g_lq.shape != z.shape[:1]:
        raise ValueError(f"g_lq must be ({z.shape[0]},), got {tuple(g_lq.shape)}")
    tensors = [t for t in (var_param, z, g_x, g_lq) if t is not None]
    if z.dtype not in (torch.float32, torch.float64) or any(t.dtype != z.dtype
                                                             for t in tensors):
        raise TypeError("mf_stl takes float32 or float64 tensors of one dtype")
    if any(t.device != z.device for t in tensors) or z.device.type not in ("cpu", "cuda"):
        raise ValueError("mf_stl's tensors must lie on the CPU or on one CUDA device")
    return z.device.type == "cpu"


def _scratch(lib, S, d, dtype, device, backward):
    """The launcher's float64 scratch, as many doubles as it asks for."""
    n = ctypes.c_int64()
    _build.check(lib.viabel_mf_stl_scratch(S, d, torch.finfo(dtype).bits // 8,
                                           int(backward), ctypes.byref(n)), "mf_stl_scratch")
    return torch.empty(n.value, dtype=torch.float64, device=device)


def mf_stl_forward(var_param, z):
    """The draws ``x = mu + exp(log_sigma) z`` and their STL log density
    ``log q = -0.5 |z|^2 - sum log_sigma - d/2 log 2 pi``, for ``var_param =
    [mu, log_sigma]`` ``(2 d,)`` and base normals ``z`` ``(S, d)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernels
    (one pass over ``z``, then the rows' sums in a fixed order) or raises.
    float32 and float64; each row's sum of squares is kept in float64.
    """
    if _check(var_param, z):
        return mf_stl_forward_plain(var_param, z)
    S, d = z.shape
    z, var_param = z.contiguous(), var_param.contiguous()
    x = torch.empty_like(z)
    log_q = torch.empty(S, dtype=z.dtype, device=z.device)
    lib = _build.load_library()
    scratch = _scratch(lib, S, d, z.dtype, z.device, backward=False)
    fn = (lib.viabel_mf_stl_forward_f32 if z.dtype == torch.float32
          else lib.viabel_mf_stl_forward_f64)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    _build.check(fn(z.data_ptr(), var_param[:d].data_ptr(), var_param[d:].data_ptr(),
                    x.data_ptr(), log_q.data_ptr(), scratch.data_ptr(), S, d, stream),
                 "mf_stl_forward")
    if S:
        _build.count_launch("mf_stl", 2)  # the draw, then the rows' sums
    return x, log_q


def mf_stl_backward(var_param, z, g_x, g_lq):
    """The gradient ``[d mu, d log_sigma]`` ``(2 d,)`` of :func:`mf_stl_forward`
    given the draws' gradient ``g_x`` ``(S, d)`` and the scores' ``g_lq``
    ``(S,)`` (any row weights), either of which may be None, with ``log q``'s
    parameters held fixed.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one pass over ``g_x`` and ``z``, sums over S kept in float64; where d
    is too narrow to fill the card, S is split and the splits' sums added
    by a second kernel in a fixed order) or raises.
    """
    if _check(var_param, z, g_x, g_lq):
        return mf_stl_backward_plain(var_param, z, g_x, g_lq)
    S, d = z.shape
    z, log_sigma = z.contiguous(), var_param[d:].contiguous()
    g_x = None if g_x is None else g_x.contiguous()
    g_lq = None if g_lq is None else g_lq.contiguous()
    grad = torch.empty(2 * d, dtype=z.dtype, device=z.device)
    lib = _build.load_library()
    scratch = _scratch(lib, S, d, z.dtype, z.device, backward=True)
    fn = (lib.viabel_mf_stl_backward_f32 if z.dtype == torch.float32
          else lib.viabel_mf_stl_backward_f64)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    _build.check(fn(None if g_x is None else g_x.data_ptr(),
                    None if g_lq is None else g_lq.data_ptr(), z.data_ptr(),
                    log_sigma.data_ptr(), grad.data_ptr(), scratch.data_ptr(), S, d, stream),
                 "mf_stl_backward")
    _build.count_launch("mf_stl", 2 if scratch.numel() else 1)
    return grad
