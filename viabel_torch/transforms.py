"""Constrained-parameter transforms (counterpart of ``viabel_tpu/transforms.py``).

ADVI-style support handling: bijectors for the standard Stan constraint
types, a :class:`ParamSpec` that lays blocks of named parameters along one
flat unconstrained vector, and :class:`TransformedModel`, a
:class:`~viabel_torch.models.Model` whose log density is the pushforward

    ``log p(constrain(z)) + log |det d constrain / d z|``

as ADVI defines it (Kucukelbir et al., JMLR 2017, §2.3) and as Stan's
reference manual ("Constraint transforms") specifies each type. Every
bijector broadcasts over leading batch axes and is written in
differentiable torch operations.
"""

import math

import torch
from torch.nn import functional as F

from .models.base import Model

__all__ = [
    "Bijector", "Identity", "Affine", "LowerBound", "UpperBound",
    "Interval", "Simplex", "Ordered", "CorrCholesky",
    "identity", "affine", "positive", "lower_bound", "upper_bound",
    "interval", "unit_interval", "simplex", "ordered", "corr_cholesky",
    "ParamSpec", "TransformedModel",
]


class Bijector:
    """One constraint type: a map from R^m (unconstrained) to a manifold.

    ``forward`` maps ``(..., m)`` unconstrained coordinates to ``(..., n)``
    constrained values, ``inverse`` undoes it, and
    ``forward_log_det_jacobian`` returns the ``(...,)`` log absolute
    determinant of the forward map (for a non-square map like the
    simplex, of the map onto the manifold's free coordinates, the Stan
    convention).
    """

    def unconstrained_size(self, constrained_size):
        """Free dimensions backing a block of ``constrained_size``."""
        return constrained_size

    def forward(self, x):
        raise NotImplementedError()

    def inverse(self, y):
        raise NotImplementedError()

    def forward_log_det_jacobian(self, x):
        raise NotImplementedError()

    def forward_and_fldj(self, x):
        """Both at once; subclasses override where work is shared."""
        return self.forward(x), self.forward_log_det_jacobian(x)


class Identity(Bijector):
    """Unconstrained block (Stan ``real``/``vector``)."""

    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


def _as_tensor(value):
    """A tensor as it is; anything else as a float64 tensor, so that no
    precision is lost before the value meets its input's dtype."""
    return value if torch.is_tensor(value) else torch.as_tensor(value, dtype=torch.float64)


class Affine(Bijector):
    """``y = loc + scale * x`` (Stan ``<offset=o, multiplier=m>``);
    log|J| = sum log scale. The standardization bijector of
    :func:`viabel_torch.convenience.pilot_standardize`. ``loc`` and
    ``scale`` are scalars or ``(m,)`` vectors, moved to each input's
    device and dtype where they are used."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = _as_tensor(loc), _as_tensor(scale)
        if bool(torch.any(self.scale <= 0.0)):
            raise ValueError("Affine needs strictly positive scales")

    def forward(self, x):
        return self.loc.to(x) + self.scale.to(x) * x

    def inverse(self, y):
        return (y - self.loc.to(y)) / self.scale.to(y)

    def forward_log_det_jacobian(self, x):
        return torch.sum(torch.broadcast_to(torch.log(self.scale.to(x)), x.shape),
                         dim=-1)


class LowerBound(Bijector):
    """``y = lb + exp(x)`` (Stan ``<lower=lb>``); log|J| = sum x."""

    def __init__(self, lb=0.0):
        self.lb = float(lb)

    def forward(self, x):
        return self.lb + torch.exp(x)

    def inverse(self, y):
        return torch.log(y - self.lb)

    def forward_log_det_jacobian(self, x):
        return torch.sum(x, dim=-1)


class UpperBound(Bijector):
    """``y = ub - exp(x)`` (Stan ``<upper=ub>``); log|J| = sum x."""

    def __init__(self, ub=0.0):
        self.ub = float(ub)

    def forward(self, x):
        return self.ub - torch.exp(x)

    def inverse(self, y):
        return torch.log(self.ub - y)

    def forward_log_det_jacobian(self, x):
        return torch.sum(x, dim=-1)


class Interval(Bijector):
    """``y = lo + (hi - lo) * sigmoid(x)`` (Stan ``<lower=lo,upper=hi>``);
    log|J| per coordinate = log(hi - lo) + log sigmoid(x) + log sigmoid(-x),
    through ``logsigmoid`` for stability at large |x|."""

    def __init__(self, lo, hi):
        lo, hi = float(lo), float(hi)
        if not lo < hi:
            raise ValueError("Interval requires lo < hi")
        self.lo, self.hi = lo, hi

    def forward(self, x):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(x)

    def inverse(self, y):
        z = (y - self.lo) / (self.hi - self.lo)
        return torch.log(z) - torch.log1p(-z)

    def forward_log_det_jacobian(self, x):
        per = math.log(self.hi - self.lo) + F.logsigmoid(x) + F.logsigmoid(-x)
        return torch.sum(per, dim=-1)


class Simplex(Bijector):
    """Stick-breaking simplex (Stan convention): K-1 free coordinates -> K.

    ``z_k = sigmoid(x_k - log(K - k))`` (the offset maps x = 0 to the
    uniform simplex), ``y_k = z_k * prod_{i<k}(1 - z_i)``, ``y_K =
    prod(1 - z_i)``; log|J| = sum_k [log z_k + log(1 - z_k) + log
    prod_{i<k}(1 - z_i)]. The prefix products are one ``cumsum`` in log
    space.
    """

    def unconstrained_size(self, constrained_size):
        if constrained_size < 2:
            raise ValueError("simplex blocks need size >= 2")
        return constrained_size - 1

    @staticmethod
    def _offset(km1, like):
        return torch.log(torch.arange(km1, 0, -1, dtype=like.dtype, device=like.device))

    def _pieces(self, x):
        t = x - self._offset(x.shape[-1], x)
        log_z = F.logsigmoid(t)
        log_1mz = F.logsigmoid(-t)
        # log prod_{i<k} (1 - z_i), the empty product 0 at k = 1
        log_rem = torch.cat([torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype,
                                         device=x.device),
                             torch.cumsum(log_1mz, dim=-1)], dim=-1)
        return log_z, log_1mz, log_rem

    def forward(self, x):
        return self.forward_and_fldj(x)[0]

    def inverse(self, y):
        # the stick remaining before y_k breaks off: 1 - sum_{i<k} y_i
        rem = 1.0 - torch.cumsum(y[..., :-1], dim=-1)
        rem = torch.cat([torch.ones(y.shape[:-1] + (1,), dtype=y.dtype,
                                    device=y.device), rem[..., :-1]], dim=-1)
        z = y[..., :-1] / rem
        return torch.log(z) - torch.log1p(-z) + self._offset(y.shape[-1] - 1, y)

    def forward_log_det_jacobian(self, x):
        return self.forward_and_fldj(x)[1]

    def forward_and_fldj(self, x):
        log_z, log_1mz, log_rem = self._pieces(x)
        head = torch.exp(log_z + log_rem[..., :-1])
        tail = torch.exp(log_rem[..., -1:])
        y = torch.cat([head, tail], dim=-1)
        return y, torch.sum(log_z + log_1mz + log_rem[..., :-1], dim=-1)


class Ordered(Bijector):
    """Increasing vector (Stan ``ordered``): ``y_1 = x_1``, ``y_k = y_{k-1}
    + exp(x_k)``; log|J| = sum_{k>=2} x_k."""

    def forward(self, x):
        return torch.cumsum(torch.cat([x[..., :1], torch.exp(x[..., 1:])], dim=-1),
                            dim=-1)

    def inverse(self, y):
        return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], dim=-1)

    def forward_log_det_jacobian(self, x):
        return torch.sum(x[..., 1:], dim=-1)


class CorrCholesky(Bijector):
    """Cholesky factor of a K x K correlation matrix (Stan
    ``cholesky_factor_corr``) from K(K-1)/2 unconstrained coordinates, by
    tanh canonical partial correlations (Lewandowski-Kurowicka-Joe).

    Row i (0-indexed) of L is built from its i CPCs ``c = tanh(x)``:
    ``L[i, j] = c_j * prod_{m<j} sqrt(1 - c_m^2)`` for j < i and ``L[i, i]
    = prod_{m<i} sqrt(1 - c_m^2)``. The constrained block is the dense
    row-major ``(K*K,)`` flattening of L (zeros above the diagonal). The
    log-Jacobian sums, over the CPCs, ``log(1 - c^2)`` (the tanh) and the
    log of the running product factor at (i, j).
    """

    def __init__(self, k):
        self.k = int(k)
        if self.k < 2:
            raise ValueError("corr_cholesky needs K >= 2")
        rows, cols = torch.tril_indices(self.k, self.k, -1)
        self._rows, self._cols = rows, cols
        self._flat = rows * self.k + cols  # the CPCs' slots in the (K*K,) grid

    def unconstrained_size(self, constrained_size):
        expect = self.k * self.k
        if constrained_size != expect:
            raise ValueError(
                f"corr_cholesky({self.k}) blocks are the dense (K*K,) "
                f"row-major Cholesky factor; got size {constrained_size}")
        return self.k * (self.k - 1) // 2

    def _grid(self, values):
        """The CPC-shaped ``values`` scattered into the strict lower
        triangle of a zero ``(..., K, K)`` grid."""
        k = self.k
        flat = values.new_zeros(values.shape[:-1] + (k * k,))
        flat = flat.index_copy(-1, self._flat.to(values.device), values)
        return flat.reshape(values.shape[:-1] + (k, k))

    def _build(self, x):
        k = self.k
        c = torch.tanh(x)
        log_1mc2 = self._grid(torch.log1p(-c * c))
        # prefix log prod_{m<j} sqrt(1 - c_{i,m}^2) along each row
        log_fac = torch.cat([x.new_zeros(x.shape[:-1] + (k, 1)),
                             torch.cumsum(0.5 * log_1mc2, dim=-1)[..., :-1]], dim=-1)
        idx = torch.arange(k, device=x.device)
        lower = idx[None, :] < idx[:, None]  # strict lower, j < i
        diag = idx[None, :] == idx[:, None]
        L = torch.where(lower, self._grid(c) * torch.exp(log_fac), 0.0)
        # L[i, i] = prod_{m<i} sqrt(1 - c_{i,m}^2) = exp(log_fac[i, i])
        L = torch.where(diag, torch.exp(log_fac), L)
        return L, log_1mc2, log_fac, lower

    def forward(self, x):
        return self.forward_and_fldj(x)[0]

    def inverse(self, y):
        k = self.k
        L = y.reshape(y.shape[:-1] + (k, k))
        # c_{i,j} = L[i,j] / prod_{m<j} sqrt(1 - c_{i,m}^2), and the prefix
        # products are sqrt(1 - sum_{m<=j} L[i,m]^2), with no iteration
        fac = torch.sqrt(torch.clamp(1.0 - torch.cumsum(L * L, dim=-1), min=1e-30))
        fac_prev = torch.cat([torch.ones(fac.shape[:-1] + (1,), dtype=y.dtype,
                                         device=y.device), fac[..., :-1]], dim=-1)
        c = L / fac_prev
        cv = c[..., self._rows.to(y.device), self._cols.to(y.device)]
        return torch.atanh(torch.clamp(cv, -1.0 + 1e-15, 1.0 - 1e-15))

    def forward_log_det_jacobian(self, x):
        return self.forward_and_fldj(x)[1]

    def forward_and_fldj(self, x):
        L, log_1mc2, log_fac, lower = self._build(x)
        per = torch.where(lower, log_1mc2 + log_fac, 0.0)
        return (L.reshape(x.shape[:-1] + (self.k * self.k,)),
                torch.sum(per, dim=(-1, -2)))


def identity():
    return Identity()


def affine(loc=0.0, scale=1.0):
    """Stan ``<offset=loc, multiplier=scale>``: the standardizer."""
    return Affine(loc, scale)


def positive():
    """Stan ``<lower=0>``."""
    return LowerBound(0.0)


def lower_bound(lb):
    return LowerBound(lb)


def upper_bound(ub):
    return UpperBound(ub)


def interval(lo, hi):
    return Interval(lo, hi)


def unit_interval():
    """Stan ``<lower=0,upper=1>``."""
    return Interval(0.0, 1.0)


def simplex():
    return Simplex()


def ordered():
    return Ordered()


def corr_cholesky(k):
    return CorrCholesky(k)


def _squeezed(size, bij):
    """Size-1 elementwise blocks reach the model as ``(...,)``."""
    return size == 1 and not isinstance(bij, (Simplex, CorrCholesky))


class ParamSpec:
    """Named constrained blocks laid along one flat vector.

    Parameters
    ----------
    blocks : sequence of (name, constrained_size, bijector)
        ``constrained_size`` is the CONSTRAINED length of the block (a
        ``simplex`` block of size K takes K-1 flat coordinates; a
        ``corr_cholesky(K)`` block of size K*K takes K(K-1)/2).

    Size-1 elementwise blocks are handed to the model squeezed to shape
    ``(...,)`` (a scalar per sample); every other block keeps its trailing
    size axis.
    """

    def __init__(self, blocks):
        self._blocks = []
        offset = 0
        names = set()
        for name, size, bij in blocks:
            size = int(size)
            if size < 1:
                raise ValueError(f"block {name!r}: size must be >= 1")
            if name in names:
                raise ValueError(f"duplicate block name {name!r}")
            names.add(name)
            m = bij.unconstrained_size(size)
            self._blocks.append((name, size, bij, offset, m))
            offset += m
        self._dim = offset

    @property
    def dim(self):
        """Flat UNCONSTRAINED dimension (what ``bbvi(dimension)`` takes)."""
        return self._dim

    @property
    def names(self):
        return [b[0] for b in self._blocks]

    def constrain(self, z):
        """``(..., dim)`` unconstrained -> dict of constrained blocks."""
        z = torch.as_tensor(z)
        out = {}
        for name, size, bij, off, m in self._blocks:
            y = bij.forward(z[..., off:off + m])
            out[name] = y[..., 0] if _squeezed(size, bij) else y
        return out

    def constrain_and_fldj(self, z):
        """Constrained blocks plus the total ``(...,)`` log|Jacobian|."""
        z = torch.as_tensor(z)
        out = {}
        fldj = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for name, size, bij, off, m in self._blocks:
            y, j = bij.forward_and_fldj(z[..., off:off + m])
            out[name] = y[..., 0] if _squeezed(size, bij) else y
            fldj = fldj + j
        return out, fldj

    def unconstrain(self, params):
        """dict of constrained blocks -> ``(..., dim)`` flat vector. Blocks
        must have the shapes :meth:`constrain` produces."""
        pieces = []
        for name, size, bij, _, _ in self._blocks:
            y = torch.as_tensor(params[name])
            if _squeezed(size, bij):
                y = y[..., None]
            pieces.append(bij.inverse(y))
        return torch.cat(pieces, dim=-1)


class TransformedModel(Model):
    """A model over CONSTRAINED parameters, optimized unconstrained.

    ``log_density`` receives a dict of batched constrained blocks (each
    ``(n, size)``, size-1 elementwise blocks squeezed to ``(n,)``) and
    returns ``(n,)``. The wrapper adds the transforms' log-Jacobian, so any
    family on R^dim targets the right pushforward; ``constrain`` works on
    single vectors and batches alike.
    """

    graph_safe = True

    def __init__(self, log_density, spec, **kwargs):
        kwargs.setdefault("constrain_fn", spec.constrain)
        super().__init__(log_density, **kwargs)
        self._spec = spec

    @property
    def spec(self):
        return self._spec

    def __call__(self, model_param):
        params, fldj = self._spec.constrain_and_fldj(model_param)
        return self._log_density(params) + fldj
