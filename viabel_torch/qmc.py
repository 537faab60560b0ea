"""Randomized quasi-Monte Carlo base sampling (counterpart of
``viabel_tpu/qmc.py``).

Replaces a reparameterized family's standard-normal base draws with a
randomized low-discrepancy point set, which cuts the variance of the ELBO
and its gradient far below the 1/S Monte Carlo rate on smooth integrands
(Buchholz, Wenzel & Mandt, ICML 2018).

:class:`SobolNormal` holds an unscrambled Sobol block ``(n, width)`` of
32-bit lattice points, built once on the host with
``scipy.stats.qmc.Sobol`` and cached on the device. Each call draws one
32-bit seed a dimension from the step's generator and either XORs it into
every point (a random digital shift) or uses it to key Burley's hash-based
Owen scramble (``owen=True``); the scrambled points go through the normal
inverse CDF. Both keep the net structure and make every marginal exactly
uniform, so the estimator stays unbiased and independent across steps.

torch has no wrapping ``uint32`` arithmetic on the GPU, so the lattice and
the hash live in ``int64`` with every value in ``[0, 2^32)``: each
multiply, add and left shift is masked back to 32 bits, and every product
fits in 63 bits.

Usage::

    from viabel_torch import FullRankGaussian, qmc
    approx = FullRankGaussian(dim, base_sampler=qmc.SobolNormal())

The families that accept ``base_sampler`` draw one block a step:
``MFGaussian``, ``FullRankGaussian``, ``LRGaussian`` (one joint ``(k +
dim)`` block), ``NeuralNet``/``NVPFlow`` and ``MultivariateT`` at an
integer ``df`` (one joint ``(dim + df)`` block whose last ``df``
coordinates build the chi-square mixer).
"""

import warnings

import numpy as np
import torch

__all__ = ["SobolNormal", "AntitheticNormal"]

# scipy's Joe-Kuo direction-number table covers this many dimensions
_SCIPY_SOBOL_MAXDIM = 21201
_MASK32 = 0xFFFFFFFF


def _reverse_bits32(x):
    """Bit-reverse each 32-bit lane of an int64 tensor of values in
    ``[0, 2^32)``."""
    x = ((x >> 16) | (x << 16)) & _MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def _owen_scramble32(bits, seed):
    """Hash-based Owen (nested-uniform) scramble of 32-bit lattice points
    (Burley, JCGT 2020, listing 4): reverse the bits, apply a hash whose
    every output bit depends only on its own and lower input bits, and
    reverse back, so each digit is permuted by a hash of the digits above
    it. ``bits`` and ``seed`` are int64 tensors of values in ``[0, 2^32)``;
    the result is equal, lane for lane, to the JAX package's uint32 hash."""
    x = _reverse_bits32(bits)
    x = x ^ ((x * 0x3D20ADEA) & _MASK32)
    x = (x + seed) & _MASK32
    x = (x * ((seed >> 16) | 1)) & _MASK32
    x = x ^ ((x * 0x05526C56) & _MASK32)
    x = x ^ ((x * 0x53A22864) & _MASK32)
    return _reverse_bits32(x)


class SobolNormal:
    """Scrambled Sobol standard-normal base sampler.

    Parameters
    ----------
    skip_first : bool, default False
        Use Sobol points ``1..n`` instead of ``0..n-1``.
    owen : bool, default False
        Owen (nested-uniform) scrambling instead of the digital shift; it
        attains the O(n^-1.5) RMSE rate on smooth integrands (Owen 1997).

    Base blocks are cached per ``(n, width, device)``. Balance is best at
    a power-of-two ``n_samples``; other sizes stay unbiased.
    """

    def __init__(self, skip_first=False, owen=False):
        self._skip_first = bool(skip_first)
        self._owen = bool(owen)
        self._cache = {}

    def _base_block(self, n, width, device):
        """``(n, width)`` int64 lattice of the unscrambled Sobol prefix, with
        values in ``[0, 2^32)``."""
        if width > _SCIPY_SOBOL_MAXDIM:
            raise ValueError(
                f"SobolNormal supports at most {_SCIPY_SOBOL_MAXDIM} "
                f"dimensions (requested {width}); use a pseudo-random "
                f"base sampler for wider families")
        device = torch.device(device)
        cache_key = (int(n), int(width), device)
        block = self._cache.get(cache_key)
        if block is None:
            from scipy.stats import qmc as _sqmc
            eng = _sqmc.Sobol(d=width, scramble=False)
            count = n + 1 if self._skip_first else n
            with warnings.catch_warnings():
                # non-power-of-two prefixes are deliberate (still unbiased)
                warnings.simplefilter("ignore", UserWarning)
                u = eng.random(count)
            if self._skip_first:
                u = u[1:]
            # scipy's points lie on a 2^-b lattice, b <= 32, exact in
            # float64, so the floor recovers the integer lattice exactly
            block = torch.as_tensor(np.floor(u * 4294967296.0).astype(np.int64),
                                    device=device)
            self._cache[cache_key] = block
        return block

    def scrambled_bits(self, n_samples, width, seeds):
        """The scrambled lattice for the per-dimension ``seeds`` (int64 in
        ``[0, 2^32)``, shape ``(width,)``)."""
        base = self._base_block(n_samples, width, seeds.device)
        if self._owen:
            return _owen_scramble32(base, seeds[None, :])
        return base ^ seeds[None, :]

    def normal_from_seeds(self, n_samples, width, seeds, dtype):
        """The ``(n_samples, width)`` N(0, 1) block for given seeds."""
        bits = self.scrambled_bits(n_samples, width, seeds)
        if dtype == torch.float64:
            # all 32 bits are exact in float64
            u = (bits.to(torch.float64) + 0.5) * 2.0 ** -32
        else:
            # the top 24 bits, exact in float32 and bounded away from 0 and
            # 1, so ndtri stays finite
            u = ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
        return torch.special.ndtri(u).to(dtype)

    def normal(self, generator, n_samples, width, dtype, device):
        """Draw an ``(n_samples, width)`` scrambled-Sobol N(0, 1) block; one
        seed a dimension comes from ``generator``."""
        seeds = torch.randint(0, 2**32, (width,), generator=generator,
                              dtype=torch.int64, device=device)
        return self.normal_from_seeds(n_samples, width, seeds, dtype)


class AntitheticNormal:
    """Antithetic-pairs standard-normal base sampler: ``ceil(n/2)``
    pseudo-random points and their mirrors ``[z; -z]``. Odd integrand
    components cancel within each pair; even ones pay (the pair members are
    perfectly correlated there), so it helps when the error is
    location-dominated. Marginals are exactly N(0, 1)."""

    def normal(self, generator, n_samples, width, dtype, device):
        half = (n_samples + 1) // 2
        z = torch.randn((half, width), generator=generator, dtype=dtype, device=device)
        return torch.cat([z, -z], dim=0)[:n_samples]
