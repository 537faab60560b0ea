"""viabel_torch's randomized quasi-Monte Carlo base samplers against the JAX
package, in float64 on the CPU.

The Sobol lattice and both scrambles are integer maps, compared exactly.
The per-dimension seeds come from the step key in the JAX package and from
the generator here; their streams never match, so the JAX seeds are
recomputed from the key (``jax.random.bits``, qmc.py:179) and injected.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
from viabel_torch import qmc as tq  # noqa: E402
from viabel_torch.convert import params_from_jax  # noqa: E402
from viabel_tpu import qmc as jq  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_seeds(key, width):
    """The seeds JAX's ``SobolNormal.normal`` draws from ``key``, as int64."""
    return np.asarray(jax.random.bits(key, (width,), dtype=jnp.uint32)).astype(np.int64)


class SeededSobol(tq.SobolNormal):
    """The port's SobolNormal with the per-dimension seeds injected in order."""

    def __init__(self, seeds, **kw):
        super().__init__(**kw)
        self.seeds = list(seeds)

    def normal(self, generator, n_samples, width, dtype, device):
        seeds = torch.as_tensor(self.seeds.pop(0), device=device)
        assert seeds.shape == (width,)
        return self.normal_from_seeds(n_samples, width, seeds, dtype)


@pytest.mark.parametrize("n,width,skip_first", [(16, 7, False), (10, 30, False),
                                                (40, 9, True)])
def test_sobol_lattice_equals_jax_base_block(n, width, skip_first):
    """The unscrambled lattice, built from scipy as the JAX package builds
    it, is equal as integers; the block is cached per (n, width, device)."""
    want = np.asarray(jq.SobolNormal(skip_first=skip_first)._base_block(n, width))
    sampler = tq.SobolNormal(skip_first=skip_first)
    got = sampler._base_block(n, width, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert sampler._base_block(n, width, "cpu") is got


def test_sobol_width_limit_raises_as_jax_does():
    with pytest.raises(ValueError, match="at most 21201"):
        tq.SobolNormal()._base_block(4, 21202, "cpu")


def test_scrambles_equal_jax_bit_for_bit():
    """The bit reversal, the digital shift and Burley's Owen hash in int64
    with 32-bit masks equal the JAX package's uint32 arithmetic on the same
    seeds, lane for lane, including seeds and points near 2^32."""
    from viabel_tpu.qmc import _owen_scramble32 as owen_j, _reverse_bits32 as rev_j
    from viabel_torch.qmc import _owen_scramble32 as owen_t, _reverse_bits32 as rev_t
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2**32, size=(64, 12), dtype=np.uint64).astype(np.uint32)
    bits[0] = np.uint32(0xFFFFFFFF)
    seeds = rng.randint(0, 2**32, size=(12,), dtype=np.uint64).astype(np.uint32)
    seeds[:2] = (np.uint32(0xFFFFFFFF), np.uint32(0))
    bj, sj = jnp.asarray(bits), jnp.asarray(seeds)[None, :]
    bt, st = torch.as_tensor(bits.astype(np.int64)), torch.as_tensor(seeds.astype(np.int64))
    np.testing.assert_array_equal(rev_t(bt).numpy(), np.asarray(rev_j(bj)).astype(np.int64))
    np.testing.assert_array_equal(owen_t(bt, st[None, :]).numpy(),
                                  np.asarray(owen_j(bj, sj)).astype(np.int64))
    for owen in (False, True):
        base_j = np.asarray(jq.SobolNormal(owen=owen)._base_block(32, 12))
        scr_j = owen_j(jnp.asarray(base_j), sj) if owen else jnp.asarray(base_j) ^ sj
        scr_t = tq.SobolNormal(owen=owen).scrambled_bits(32, 12, st)
        np.testing.assert_array_equal(scr_t.numpy(), np.asarray(scr_j).astype(np.int64))


@pytest.mark.parametrize("owen", [False, True])
def test_normal_matches_jax(owen):
    """float64: all 32 bits, ndtri against JAX's at 1e-12. float32: finite,
    from the same top 24 bits, and within float32 round-off of JAX's."""
    key = jax.random.PRNGKey(5)
    seeds = torch.as_tensor(_jax_seeds(key, 9))
    js, ts = jq.SobolNormal(owen=owen), tq.SobolNormal(owen=owen)
    z_j = np.asarray(js.normal(key, 32, 9, jnp.float64))
    z_t = ts.normal_from_seeds(32, 9, seeds, torch.float64)
    assert z_t.dtype == torch.float64
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-12, atol=1e-15)
    z_j32 = np.asarray(js.normal(key, 32, 9, jnp.float32))
    z_t32 = ts.normal_from_seeds(32, 9, seeds, torch.float32)
    assert z_t32.dtype == torch.float32 and torch.isfinite(z_t32).all()
    # the uniforms from the top 24 bits of JAX's own scrambled lattice
    from viabel_tpu.qmc import _owen_scramble32 as owen_j
    base_j = js._base_block(32, 9)
    seeds_j = jax.random.bits(key, (9,), dtype=jnp.uint32)[None, :]
    bits_j = np.asarray(owen_j(base_j, seeds_j) if owen else base_j ^ seeds_j)
    u_j = (((bits_j >> 8).astype(np.float32) + np.float32(0.5))
           * np.float32(2.0**-24))
    torch.testing.assert_close(z_t32, torch.special.ndtri(torch.as_tensor(u_j)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(z_t32.numpy(), z_j32, rtol=2e-6, atol=2e-6)
    # and through the generator: one seed a dimension, in [0, 2^32)
    gen = torch.Generator().manual_seed(3)
    z = ts.normal(gen, 32, 9, torch.float64, "cpu")
    ref = torch.Generator().manual_seed(3)
    want = torch.randint(0, 2**32, (9,), generator=ref, dtype=torch.int64)
    torch.testing.assert_close(z, ts.normal_from_seeds(32, 9, want, torch.float64),
                               rtol=0, atol=0)
    assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("n", [8, 9])
def test_antithetic_structure(n):
    """[z; -z] over ceil(n/2) generator draws, cut to n rows."""
    gen = torch.Generator().manual_seed(4)
    z = tq.AntitheticNormal().normal(gen, n, 5, torch.float64, "cpu")
    assert z.shape == (n, 5)
    half = (n + 1) // 2
    ref = torch.randn((half, 5), generator=torch.Generator().manual_seed(4),
                      dtype=torch.float64)
    torch.testing.assert_close(z[:half], ref, rtol=0, atol=0)
    torch.testing.assert_close(z[half:], -ref[: n - half], rtol=0, atol=0)


def _model_pair(d):
    rng = np.random.default_rng(0)
    tmu, tsd = rng.normal(size=d), np.exp(0.3 * rng.normal(size=d))
    return vj.zoo.diagonal_gaussian(tmu, tsd)[0], vt.zoo.diagonal_gaussian(tmu, tsd, **CPU)[0]


@pytest.mark.parametrize("owen", [False, True])
@pytest.mark.parametrize("kind", ["mf", "full", "full_stl", "lr", "mvt"])
def test_qmc_families_value_and_grad_match_jax(kind, owen):
    """ExclusiveKL value and gradient on every family that takes a QMC
    sampler, with the JAX step's seeds injected, at rtol 1e-10. LRGaussian
    draws one joint (k + dim) block, MultivariateT one (dim + df) block."""
    d, S = 5, 16
    key = jax.random.PRNGKey(7)
    model_j, model_t = _model_pair(d)
    factories = {"mf": (lambda pkg, **kw: pkg.MFGaussian(d, **kw), d),
                 "full": (lambda pkg, **kw: pkg.FullRankGaussian(d, **kw), d),
                 "full_stl": (lambda pkg, **kw: pkg.FullRankGaussian(d, **kw), d),
                 "lr": (lambda pkg, **kw: pkg.LRGaussian(d, 2, **kw), d + 2),
                 "mvt": (lambda pkg, **kw: pkg.MultivariateT(d, 6, **kw), d + 6)}
    factory, width = factories[kind]
    fj = factory(vj, base_sampler=jq.SobolNormal(owen=owen))
    ft = factory(vt, base_sampler=SeededSobol([_jax_seeds(key, width)], owen=owen), **CPU)
    vp = np.asarray(fj.init_param()) + 0.2 * np.random.RandomState(8).randn(fj.var_param_dim)
    stl = dict(use_path_deriv=kind == "full_stl")
    val_j, grad_j = vj.ExclusiveKL(fj, model_j, S, **stl).value_and_grad(jnp.asarray(vp), key)
    val_t, grad_t = vt.ExclusiveKL(ft, model_t, S, **stl).value_and_grad(
        params_from_jax(vp, ft), None)
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=RTOL)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=RTOL, atol=1e-12)


def test_fractional_df_multivariate_t_refuses_a_sampler():
    """The chi-square mixer is built from df squared base normals, so a
    fractional df refuses a base sampler, with JAX's message."""
    with pytest.raises(ValueError) as exc_j:
        vj.MultivariateT(3, 5.5, base_sampler=jq.SobolNormal())
    with pytest.raises(ValueError) as exc_t:
        vt.MultivariateT(3, 5.5, base_sampler=tq.SobolNormal(), **CPU)
    assert str(exc_t.value) == str(exc_j.value)


def _grad_variance(sampler, vp, model, S, n_rep=200):
    approx = vt.MFGaussian(vp.shape[0] // 2, base_sampler=sampler, **CPU)
    objective = vt.ExclusiveKL(approx, model, S)
    grads = torch.stack([objective.value_and_grad(vp, torch.Generator().manual_seed(i))[1]
                         for i in range(n_rep)])
    return float(torch.mean(torch.var(grads, dim=0)))


def test_sobol_survives_the_escalation_rung_climb():
    """The escalation x QMC check: FASO's stalled gate climbs 10 -> 40 on a
    Sobol-backed family, which builds a new (40, 8) block (40 is no power
    of two, where nets are weakest), and at the new rung the gradient
    variance over 200 generators stays under half of pseudo-MC's on the
    d = 8 Gaussian."""
    d = 8
    model = _model_pair(d)[1]
    sampler = tq.SobolNormal()
    objective = vt.ExclusiveKL(vt.MFGaussian(d, base_sampler=sampler, **CPU), model, 10)
    faso = tfaso.FASO(vt.RMSProp(0.05), W_min=50, k_check=50, rhat_threshold=1.0005,
                      max_history=300, mc_escalation=4.0, mc_max_samples=40)
    res = faso.optimize(900, objective, objective.approx.init_param(),
                        generator=torch.Generator().manual_seed(0))
    assert res["mc_escalation_history"][:, 1].tolist() == [40]
    assert objective.num_mc_samples == 40
    assert {key[:2] for key in sampler._cache} == {(10, d), (40, d)}
    rng = np.random.default_rng(0)
    tmu, tsd = rng.normal(size=d), np.exp(0.3 * rng.normal(size=d))
    vp = torch.as_tensor(np.concatenate([tmu + 0.3, np.log(tsd) + 0.2]))
    v_mc = _grad_variance(None, vp, model, 40)
    v_q = _grad_variance(sampler, vp, model, 40)
    assert v_q < 0.5 * v_mc, (v_q, v_mc)
