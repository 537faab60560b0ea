"""Spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` is a context manager. While no profiler records it is one
shared ``contextlib.nullcontext()``: nothing is allocated, no clock is
read and nothing synchronises. While a ``torch.profiler`` session records
it is ``torch.profiler.record_function(name)``, so the profiler keeps the
span on the same clock as the card's kernels and copies, and each idle
gap of the card can be put down to the program phase that was open.
There is no other switch: run any ``viabel_torch`` call under
``torch.profiler.profile`` and the spans appear on its timeline.

Every span opens on the calling (main) thread; spans nest, so every span
inside a ``viabel.bbvi`` or ``viabel.vi_diagnostics`` interval belongs to
that call. The spans and what each encloses:

``viabel.bbvi``
    one :func:`viabel_torch.bbvi` fit.
``viabel.raabbvi.round``
    one RAABBVI round: its inner ``FASO.optimize`` call.
``viabel.raabbvi.regression``
    the round regression: the ``wlr_hmc`` launch and the read of its
    posterior means.
``viabel.faso.segment``
    ``k_check`` steps of ``FASO.optimize`` (one ``_run_segment`` call).
``viabel.step``
    one optimizer step of a FASO segment, its ring write included.
``viabel.step.loss``, ``viabel.step.grad``
    the objective's Monte Carlo loss, and ``torch.autograd.grad`` of it
    (the autograd route of ``value_and_grad``).
``viabel.step.rule``
    the step rule: descent direction, update and weight decay.
``viabel.step.replay``
    a step replayed from a CUDA graph (``optimizers._GraphedStep``), inside
    ``viabel.step``: the carry's load where it enters, the graph's launch
    and the loss's copy. A replayed step opens none of the three above.
``viabel.step.capture``
    one capture of a step's CUDA graph, after the eager step it records.
``viabel.flow.sample``, ``viabel.flow.log_density``
    an :class:`~viabel_torch.NVPFlow`'s pass from latent to data
    (``g``), and its pass from data to latent with the log-determinant
    (``f``). Like every span inside a step, they open on eager steps, at a
    graph's capture and in ``vi_diagnostics``, never on a replay.
``viabel.bnn.log_density``, ``viabel.bnn.prior``
    a :func:`~viabel_torch.models.zoo.bnn_classifier`'s log density over
    its S networks, and, inside it, the unit Gaussian prior's pass over
    the S x d weights. Like the flow's, they open on eager steps, at a
    graph's capture and in ``vi_diagnostics``, never on a replay.
``viabel.faso.rhat_dispatch``
    the R-hat statistics over the ring and the start of their copy to the
    host.
``viabel.faso.rhat_readback``
    one R-hat verdict: its read on the host and the decisions it makes.
``viabel.faso.mcse_check``
    the MCSE / ESS check and its host reads.
``viabel.faso.escalate``
    one escalation of the Monte Carlo sample count.
``viabel.vi_diagnostics``
    one :func:`viabel_torch.vi_diagnostics` call.
``viabel.diag.log_weights``
    q's draws and their log weights.
``viabel.diag.psis``
    Pareto smoothing of the log weights (``psislw``).
``viabel.diag.moments``
    q's mean and covariance.
``viabel.diag.bounds``
    the divergence, Wasserstein and error bounds (``all_diagnostics``).
``viabel.diag.cov_norm``
    a covariance's spectral norm inside the error bounds.
``viabel.diag.cov_norm.eigh``
    the symmetric eigensolve inside ``viabel.diag.cov_norm``
    (``diagnostics._spectral_norm``): it opens once for a symmetric
    covariance, as every family's is, and never for a matrix whose skew
    part rules the route out before the solve. Its count over the calls
    says how often the route engages.
``viabel.diag.ksd``
    the calibrated KSD test, past the k-hat gate.
"""

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name):
    """A span named ``name`` while a profiler records, else a shared
    null context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
