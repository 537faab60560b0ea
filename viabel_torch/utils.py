"""Small support utilities (counterpart of ``viabel_tpu/utils.py:34-56``).

The TPU-specific helpers of the JAX module (``pack_rows``,
``packed_width``, ``unpack_rows`` for the ``(8, 128)`` tiling, and the XLA
compilation cache) have no counterpart: the port keeps plain ``(R, D)``
rings and runs eagerly.
"""

import time

import torch

__all__ = ["Timer", "ensure_2d", "not_ported", "deferred_names", "check_device"]


class Timer:
    """Context manager measuring wall-clock time with ``perf_counter``.

    Used by FASO's adaptive recheck schedule; on a GPU the timed region
    must end in a device synchronisation (a host read of the result) so
    device work is accounted for.
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.end = time.perf_counter()
        self.interval = self.end - self.start


def ensure_2d(x):
    """Return ``x`` with a leading batch axis (shape ``(n, dim)``)."""
    return x[None, :] if x.dim() == 1 else x


def check_device(device):
    """``torch.device(device)``, raising where it names CUDA and no card is
    present. The port's entry points default to ``device="cuda"``; there
    is no silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} is not available (no CUDA "
                           "card); pass device=\"cpu\" to run on the CPU")
    return device


def not_ported(what, item):
    """The error every part of the JAX package that this port does not
    cover yet raises, pointing at its ROADMAP.md item."""
    return NotImplementedError(f"{what} is not ported to viabel_torch yet "
                               f"(ROADMAP.md, Queue 1 item {item})")


def deferred_names(module_name, names):
    """A module ``__getattr__`` raising :func:`not_ported` for ``names``
    (``{name: ROADMAP item}``) and ``AttributeError`` for anything else."""

    def __getattr__(name):
        if name in names:
            raise not_ported(f"{module_name}.{name}", names[name])
        raise AttributeError(f"module {module_name!r} has no attribute {name!r}")

    return __getattr__
