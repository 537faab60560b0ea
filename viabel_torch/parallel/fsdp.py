"""Parameter-sharded full-rank BBVI (counterpart of
``viabel_tpu/parallel/fsdp.py``).

At very large ``d`` the full-rank factor (d^2 parameters) and its
optimizer state outgrow one device: at d = 30,000 ``theta`` alone is 3.6
GB in float32. :class:`FSDPFullRankELBO` shards the family itself: the
rows of the Cholesky parameter ``theta`` (and of ``mu``) are split over an
``fsdp`` axis of a ``DeviceMesh``, optionally beside an ``mc`` axis that
splits the Monte Carlo samples. One process a rank; on CUDA one card a
rank over NCCL.

Each step, on each rank:

1. the rank's masked row block ``L_loc`` of ``L = tril(theta, -1) +
   diag(exp(diag theta))``;
2. its columns of the samples, ``x_loc = mu_loc + z @ L_loc^T``, from
   draws ``z`` that every ``fsdp`` rank makes alike and the ``mc`` ranks
   make apart;
3. an all-gather of the sample columns over ``fsdp`` (``S * d`` numbers,
   not ``d^2``), or with ``gather_pipeline=n`` one asynchronous gather a
   sample chunk, each chunk's model forward waiting only on its own;
4. the model on the gathered samples, the mean over ``mc`` and the
   entropy summed over ``fsdp``;
5. the gradient on the local shard, averaged over ``mc``, and the RMSProp
   step on it.

The gradient is the true one. Every ``fsdp`` rank evaluates the model on
the same gathered samples, so the gradient of its columns is its own
column block of the samples' gradient, and the entropy's sum contributes
its local terms: neither backward needs a collective. The JAX package's
step differs here (a known defect of the reference, ROADMAP.md Queue 3):
under ``shard_map(check_vma=False)`` the transpose of its ``all_gather``
sums ``n_fsdp`` copies of a replicated cotangent, and so does the
transpose of the entropy's ``psum``, so its gradient is ``n_fsdp`` times
the true one. RMSProp nearly cancels that constant; its ``nu`` is
``n_fsdp**2`` times the port's, and what remains is the ``jitter`` term.

The port assumes the model is deterministic: the gathered samples are
bit-identical on every ``fsdp`` rank, and the model must give every rank
the same value and gradient on them (a model that reduces with atomics
in a varying order breaks the collective-free backward).
"""

import math

import torch
import torch.distributed as dist

from ..utils import check_device
from .mesh import MeshAxis

__all__ = ["FSDPFullRankELBO"]

_LOG_2PI = math.log(2.0 * math.pi)


def _axis(mesh, name):
    """``MeshAxis(mesh, name)`` with the JAX package's ``KeyError`` (its
    ``mesh.shape[name]``) for a mesh without the axis."""
    try:
        return MeshAxis(mesh, name)
    except ValueError:
        raise KeyError(name) from None


class FSDPFullRankELBO:
    """Parameter-sharded full-rank Gaussian ELBO trainer.

    Parameters
    ----------
    dim : int, divisible by the ``fsdp`` axis size
    model : callable, a batched log density: ``(n, dim) -> (n,)``
    num_mc_samples : int, the samples of a step over all ranks (divisible
        by the ``mc`` axis size when there is one)
    mesh : a ``DeviceMesh`` (:func:`viabel_torch.parallel.make_mesh`) with
        an ``fsdp`` axis and optionally an ``mc`` axis; its device type is
        the trainer's (CUDA: this process's current card)
    learning_rate, beta, jitter : RMSProp's, seeded with the first squared
        gradient as in the reference
    init_log_diag : the initial ``log diag L``
    gather_pipeline : int, optional
        Split this rank's samples into this many chunks: each chunk's
        all-gather is asynchronous, so it overlaps the next chunk's
        product and the previous chunk's model forward. The draws are
        the plain path's; only the mean is reassociated. Must divide the
        per-rank sample count. Default (None/1): one all-gather.

    Every rank constructs the trainer alike and calls :meth:`step` with
    the same generator state.
    """

    def __init__(self, dim, model, num_mc_samples, mesh, fsdp_axis="fsdp",
                 mc_axis=None, learning_rate=0.01, beta=0.9, jitter=1e-8,
                 init_log_diag=0.0, gather_pipeline=None):
        self.dim = int(dim)
        self.mesh = mesh
        self._model = model
        self._fsdp = _axis(mesh, fsdp_axis)
        n_fsdp = self._fsdp.n
        if self.dim % n_fsdp != 0:
            raise ValueError(f"dim={dim} not divisible by {fsdp_axis} axis "
                             f"size {n_fsdp}")
        self._local_rows = self.dim // n_fsdp
        self._row0 = self._fsdp.coordinate * self._local_rows
        self._mc = _axis(mesh, mc_axis) if mc_axis else None
        n_mc = self._mc.n if self._mc is not None else 1
        if num_mc_samples % n_mc != 0:
            raise ValueError("num_mc_samples not divisible by mc axis size")
        self._local_S = num_mc_samples // n_mc
        self._lr = float(learning_rate)
        self._beta = float(beta)
        self._jitter = float(jitter)
        self._init_log_diag = float(init_log_diag)
        self._pipeline = 1 if gather_pipeline is None else int(gather_pipeline)
        if self._pipeline < 1:
            raise ValueError("gather_pipeline must be a positive chunk count")
        if self._pipeline > 1 and self._local_S % self._pipeline != 0:
            raise ValueError(
                f"per-device sample count {self._local_S} not divisible by "
                f"gather_pipeline={self._pipeline}")
        device = check_device(getattr(mesh, "device_type", "cuda"))
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    # -- parameter layout -----------------------------------------------------
    @property
    def rows(self):
        """The rows ``[row0, row0 + dim / n_fsdp)`` of ``mu`` and ``theta``
        that this rank holds."""
        return range(self._row0, self._row0 + self._local_rows)

    def init_params(self, dtype=torch.float32):
        """This rank's shard ``(mu_loc, theta_loc)``, shapes ``(d/P,)`` and
        ``(d/P, d)``, of ``mu = 0`` and ``theta = init_log_diag * I``."""
        n, d = self._local_rows, self.dim
        rows = torch.arange(self._row0, self._row0 + n, device=self.device)[:, None]
        cols = torch.arange(d, device=self.device)[None, :]
        theta = self._init_log_diag * (rows == cols).to(dtype)
        return torch.zeros(n, dtype=dtype, device=self.device), theta

    def init_opt_state(self, params):
        mu, theta = params
        return torch.zeros_like(mu), torch.zeros_like(theta), 0

    def shard_params(self, mu, theta, dtype=None):
        """This rank's rows of a whole ``(d,)`` / ``(d, d)`` pair (tensors
        or arrays; ``dtype`` defaults to theirs), on the trainer's device.
        A state saved on one mesh shape goes onto another this way; the
        opt state's ``(nu_mu, nu_theta)`` too."""
        out = []
        for x, shape in ((mu, (self.dim,)), (theta, (self.dim, self.dim))):
            x = torch.as_tensor(x)
            if tuple(x.shape) != shape:
                raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
            out.append(x[self._row0:self._row0 + self._local_rows].to(
                device=self.device, dtype=dtype or x.dtype, copy=True))
        return tuple(out)

    def gather_params(self, params):
        """The whole ``(mu, theta)`` on every rank, from each rank's shard
        (the JAX package's global arrays); the opt state's ``(nu_mu,
        nu_theta)`` too."""
        return tuple(self._fsdp.gather(x) for x in params)

    # -- the sharded training step ---------------------------------------------
    def _gather_columns(self, x_loc, async_op=False):
        """Start the all-gather of ``x_loc``'s sample columns over
        ``fsdp``; returns ``finish()``, which waits for it and gives the
        ``(S, d)`` samples in ``fsdp`` order. Their gradient reaches
        ``x_loc`` from this rank's own column block only."""
        fsdp = self._fsdp
        parts = [torch.empty_like(x_loc) for _ in range(fsdp.n)]
        work = dist.all_gather(parts, x_loc.detach().contiguous(), group=fsdp.group,
                               async_op=async_op)

        def finish():
            if work is not None:
                work.wait()
            parts[fsdp.coordinate] = x_loc
            return torch.cat(parts, dim=1)

        return finish

    def _logp_grad(self, mu, L, z):
        """The local samples' mean log density and its gradient with
        respect to this rank's sample columns, ``(S_loc, d/P)``."""
        S_loc = self._local_S
        if self._pipeline == 1:
            x_loc = (mu + z @ L.T).requires_grad_(True)
            leaves = [x_loc]
            logp = torch.mean(self._model(self._gather_columns(x_loc)()))
        else:
            # chunk c's gather is in flight while chunk c + 1's product and
            # chunk c - 1's model forward run
            Sc = S_loc // self._pipeline
            leaves, pending = [], []
            logp_sum = torch.zeros((), dtype=L.dtype, device=L.device)
            for c in range(self._pipeline + 1):
                if c < self._pipeline:
                    x_c = (mu + z[c * Sc:(c + 1) * Sc] @ L.T).requires_grad_(True)
                    leaves.append(x_c)
                    pending.append(self._gather_columns(x_c, async_op=True))
                if c > 0:
                    logp_sum = logp_sum + torch.sum(self._model(pending.pop(0)()))
            logp = logp_sum / S_loc
        grads = torch.autograd.grad(logp, leaves)
        return logp.detach(), torch.cat(grads)

    def step(self, params, opt_state, generator=None, draws=None):
        """One sharded ELBO / RMSProp step. ``params`` and ``opt_state`` are
        this rank's (:meth:`init_params`, :meth:`init_opt_state`) and are
        updated in place. ``generator`` is the caller's, in the same state
        on every rank; with an ``mc`` axis each rank draws from
        ``MeshAxis.generator`` of it (the JAX package's ``fold_in``).
        ``draws``: this rank's ``(S_loc, d)`` standard normal draws in
        place of the generator's. Returns ``(params, opt_state, value)``;
        ``value``, the same on every rank, is the negative ELBO estimate.
        """
        mu, theta = params
        nu_mu, nu_theta, t = opt_state
        d, r0 = self.dim, self._row0
        shape = (self._local_S, d)
        if draws is None:
            gen = generator if self._mc is None else self._mc.generator(generator)
            z = torch.randn(shape, generator=gen, dtype=theta.dtype, device=theta.device)
        else:
            z = torch.as_tensor(draws, dtype=theta.dtype, device=theta.device)
            if tuple(z.shape) != shape:
                raise ValueError(f"draws must be {shape}, got {tuple(z.shape)}")
        with torch.no_grad():
            # row i of the block is row r0 + i of L: strict lower part, then
            # the exponentiated diagonal at column r0 + i
            log_diag = theta.diagonal(r0)
            exp_diag = torch.exp(log_diag)
            L = torch.tril(theta, r0 - 1)
            L.diagonal(r0).copy_(exp_diag)
        logp, gx = self._logp_grad(mu, L, z)
        del L
        with torch.no_grad():
            # d(-logp)/d mu_loc and d(-logp)/d L_loc = -gx^T z through the
            # mask, minus the entropy's 1 on the diagonal
            gx = gx.neg_()
            g_mu = gx.sum(dim=0)
            g_theta = torch.mm(gx.T, z)
            g_diag = g_theta.diagonal(r0) * exp_diag - 1.0
            g_theta.tril_(r0 - 1)
            g_theta.diagonal(r0).copy_(g_diag)
            if self._mc is not None:
                logp = self._mc.sum(logp) / self._mc.n
                if self._mc.n > 1:
                    g_mu = self._mc.sum(g_mu) / self._mc.n
                    g_theta = self._mc.sum(g_theta).div_(self._mc.n)
            entropy = 0.5 * d * (1.0 + _LOG_2PI) + self._fsdp.sum(log_diag.sum())
            value = -(logp + entropy)
            for x, nu, g in ((mu, nu_mu, g_mu), (theta, nu_theta, g_theta)):
                if t == 0:
                    torch.mul(g, g, out=nu)
                else:
                    nu.mul_(self._beta).addcmul_(g, g, value=1.0 - self._beta)
                x.addcdiv_(g, nu.add(self._jitter).sqrt_(), value=-self._lr)
        return (mu, theta), (nu_mu, nu_theta, t + 1), value
