"""RealNVP affine coupling flow (Dinh, Sohl-Dickstein & Bengio, ICLR 2017,
arXiv:1605.08803), with viabel's tanh ``s`` and ``t`` nets.

Coupling ``i`` (``i = 0 .. K-1``) has a 0/1 mask ``m_i`` that is 1 on the
first ``d // 2`` coordinates when ``i`` is even and on the others when it
is odd. From latent to data, ``g`` applies the couplings in order:

    x <- m x + (1 - m) (x exp(s(m x)) + t(m x))

where ``s`` and ``t`` are MLPs ``(d, h_1), ..., (h_L, d)`` with tanh
between layers; ``s`` ends in tanh and ``t`` in the identity, and both
are read only on the coordinates ``1 - m`` moves. ``f`` undoes them in
reverse order, ``z <- m z + (1 - m) (z - t(m z)) exp(-s(m z))``, and the
log density is ``log N(f(x); 0, I) - sum_i sum (1 - m_i) s_i``. The base
is the standard normal, so a draw is ``g(z)`` of the base normal ``z``.

Flat parameters: per coupling the ``t`` net then the ``s`` net, each
layer's ``W (m*n, row-major)`` then ``b (n)``. The start draws every hidden
layer's ``W`` as ``randn(m, n) / sqrt(m)`` in float64 from a CPU generator
seeded with ``init_seed`` (coupling by coupling, ``t`` before ``s``, layer
by layer) with ``b = 0``; every last layer is zero, so q starts as the
base. Matrix products run at the precision the caller set: PyTorch's
default (no TF32) for the check, TF32 where the control asks for it.
"""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Family:
    def __init__(self, dim, n_couplings=4, hidden=(512, 512), init_seed=0):
        self.dim = int(dim)
        self.n_couplings = int(n_couplings)
        widths = [self.dim, *(int(h) for h in hidden), self.dim]
        self.shapes = list(zip(widths[:-1], widths[1:]))
        self.net_size = sum(m * n + n for m, n in self.shapes)
        self.init_seed = int(init_seed)

    def leaves(self):
        """One leaf for each coupling's ``t`` net and one for its ``s`` net."""
        out, i = {}, 0
        for c in range(self.n_couplings):
            for net in ("t", "s"):
                out[f"coupling{c}.{net}"] = slice(i, i + self.net_size)
                i += self.net_size
        return out

    def init(self, dtype, device):
        gen = torch.Generator().manual_seed(self.init_seed)
        parts = []
        for _ in range(2 * self.n_couplings):
            for idx, (m, n) in enumerate(self.shapes):
                if idx + 1 < len(self.shapes):
                    W = torch.randn(m, n, generator=gen, dtype=torch.float64) / math.sqrt(m)
                else:
                    W = torch.zeros(m, n, dtype=torch.float64)
                parts += [W.reshape(-1), torch.zeros(n, dtype=torch.float64)]
        return torch.cat(parts).to(device=device, dtype=dtype)

    def _net(self, p, x, last_tanh):
        i = 0
        for idx, (m, n) in enumerate(self.shapes):
            W, b = p[i:i + m * n].reshape(m, n), p[i + m * n:i + m * n + n]
            i += m * n + n
            x = x @ W + b
            if idx + 1 < len(self.shapes) or last_tanh:
                x = torch.tanh(x)
        return x

    def _coupling(self, vp, c, x):
        """Coupling ``c``'s mask and its ``(s, t)`` on the moved coordinates."""
        first = torch.arange(self.dim, device=x.device) < self.dim // 2
        m = (first if c % 2 == 0 else ~first).to(x.dtype)
        at = 2 * c * self.net_size
        xm = m * x
        t = self._net(vp[at:at + self.net_size], xm, False) * (1.0 - m)
        s = self._net(vp[at + self.net_size:at + 2 * self.net_size], xm, True) * (1.0 - m)
        return m, s, t

    def draws(self, vp, z):
        x = z
        for c in range(self.n_couplings):
            m, s, t = self._coupling(vp, c, x)
            x = m * x + (1.0 - m) * (x * torch.exp(s) + t)
        return x

    def log_q(self, vp, x):
        z, logdet = x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for c in reversed(range(self.n_couplings)):
            m, s, t = self._coupling(vp, c, z)
            z = m * z + (1.0 - m) * (z - t) * torch.exp(-s)
            logdet = logdet - torch.sum(s, dim=1)
        return -0.5 * torch.sum(z * z, dim=1) - 0.5 * self.dim * _LOG_2PI + logdet

    def entropy(self, vp):
        raise NotImplementedError("a RealNVP flow has no closed-form entropy; "
                                  "fit it with the sticking-the-landing estimator")
