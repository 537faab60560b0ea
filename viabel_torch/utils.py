"""Small support utilities (counterpart of ``viabel_tpu/utils.py:34-56``).

The TPU-specific helpers of the JAX module (``pack_rows``,
``packed_width``, ``unpack_rows`` for the ``(8, 128)`` tiling, and the XLA
compilation cache) have no counterpart: the port keeps plain ``(R, D)``
rings. :class:`GraphSafety` is how a step rule, an objective, a family and
a model each state whether a CUDA graph may replay their part of a step.
The private helpers below serve the engines' resume states and clocks.
"""

import math
import time

import torch

__all__ = ["Timer", "ensure_2d", "check_device", "standard_gamma", "chisquare",
           "GraphSafety"]


class GraphSafety:
    """A part of an optimizer step that states whether a CUDA graph of the
    step may replay it (:class:`viabel_torch.optimizers._GraphedStep`).

    A graph records the step's device work once and replays none of the
    host code that chose it: every host value the step reads (a Python
    float on a model, a step count) is frozen at capture, as under
    ``jax.jit``. A class whose step work reads no host value that changes
    between steps states ``graph_safe = True`` in its own body; a subclass
    that states nothing is never replayed, so host code added in a
    subclass is never replayed unseen. :meth:`graph_refusal` adds what an
    instance shows.
    """

    graph_safe = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.graph_safe = cls.__dict__.get("graph_safe", False)

    def graph_refusal(self):
        """Why this part of a step cannot be replayed, or None."""
        if not self.graph_safe:
            return f"{type(self).__name__} is not stated safe to replay"
        return None


# indirection so tests can stub the engines' clock deterministically
_now = time.perf_counter


def _clone_state(state):
    """A copy of a state dict's tensors (a step rule may write its state
    in place, and a resume state must stay reusable)."""
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def _set_generator_state(generator, state):
    """Continue ``generator`` from a saved ``get_state()``. A CPU and a
    CUDA generator keep states of different sizes, and one cannot seed
    the other. The state is copied first: ``set_state`` reads a view
    with a storage offset (a row of stacked states) from the wrong place
    and can crash."""
    state = torch.as_tensor(state, dtype=torch.uint8, device="cpu").clone()
    if state.numel() != generator.get_state().numel():
        raise ValueError(
            "the resume_state's generator_state was taken from a generator on "
            f"another device type than this {generator.device.type!r} one; pass "
            "a generator on the device type of the run that saved it")
    generator.set_state(state)


def _int_list(x):
    """A short integer vector of a resume state (a list, a numpy array or
    a tensor on any device) as a list of ints."""
    return [int(v) for v in torch.as_tensor(x).tolist()]


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


def standard_gamma(generator, shape_param, size, dtype, device):
    """``Gamma(shape_param, 1)`` draws of shape ``size`` from ``generator``.

    Marsaglia & Tsang (2000), vectorised: every round proposes for all
    lanes and keeps the first acceptance of each, until every lane has one
    (one host read of a flag a round; more than 95% of proposals are
    accepted for a shape of at least 1). A shape below 1 draws
    ``Gamma(shape + 1) * U^(1/shape)``. ``torch._standard_gamma`` and
    ``torch.distributions`` take no generator, so they are not used.
    """
    a = float(shape_param)
    if not a > 0.0:
        raise ValueError(f"the gamma shape must be positive, got {a}")
    boost = a < 1.0
    dd = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * dd)
    out = torch.zeros(size, dtype=dtype, device=device)
    pending = torch.ones(size, dtype=torch.bool, device=device)
    while True:
        x = torch.randn(size, generator=generator, dtype=dtype, device=device)
        # 1 - rand lies in (0, 1], so its log is finite
        u = 1.0 - torch.rand(size, generator=generator, dtype=dtype, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x**2 + dd - dd * v
                        + dd * torch.log(torch.clamp(v, min=torch.finfo(dtype).tiny)))
        take = pending & ok
        out = torch.where(take, dd * v, out)
        pending = pending & ~ok
        if not bool(pending.any()):
            break
    if boost:
        u = 1.0 - torch.rand(size, generator=generator, dtype=dtype, device=device)
        out = out * u ** (1.0 / a)
    return out


def chisquare(generator, df, size, dtype, device):
    """``chi2(df)`` draws of shape ``size`` from ``generator``: for an
    integer ``df`` the exact sum of ``df`` squared standard normals (what
    the JAX package's QMC path builds, families.py:644-651), else
    ``2 Gamma(df / 2)`` by :func:`standard_gamma`."""
    df = float(df)
    size = tuple(size)
    if df == int(df):
        z = torch.randn(size + (int(df),), generator=generator, dtype=dtype,
                        device=device)
        return torch.sum(z**2, dim=-1)
    return 2.0 * standard_gamma(generator, 0.5 * df, size, dtype, device)
