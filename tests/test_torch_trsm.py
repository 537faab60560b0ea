"""viabel_torch's generic triangular solve against the JAX package, in
float64 on the CPU.

On the CPU :func:`viabel_torch.ops.vmem_solve_triangular` takes its plain
version; these tests hold it to the Pallas kernel run in interpret mode (as
tests/test_ops.py runs it), and hold the gradient of the autograd Function
that wraps it to ``jax.grad`` through ``jax.scipy.linalg.solve_triangular``.
The CUDA kernel itself is compared with the plain version in
tests/test_torch_kernels.py (skipped without a card) and by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.scipy.linalg import solve_triangular  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_torch import ops  # noqa: E402
from viabel_torch.convert import params_from_jax  # noqa: E402
from viabel_torch.families import _TriSolve  # noqa: E402


def _triangle(d, lower, rng):
    """tests/test_ops.py's recipe: tril(randn) + d I, transposed for upper."""
    A = np.tril(rng.randn(d, d)) + d * np.eye(d)
    return A if lower else A.T


@pytest.mark.parametrize("d,S,lower", [(8, 3, True), (130, 5, False), (300, 7, True),
                                       (33, 17, False), (64, 40, True)])
def test_vmem_solve_triangular_plain_matches_pallas(d, S, lower):
    """rtol 1e-9, atol 1e-12: the bar of tests/test_ops.py for the Pallas
    kernel's Newton-inverted blocks against a direct solve."""
    from viabel_tpu.ops.trsm import vmem_solve_triangular as jax_vmem
    rng = np.random.RandomState(d)
    T, B = _triangle(d, lower, rng), rng.randn(d, S)
    want = np.asarray(jax_vmem(jnp.asarray(T), jnp.asarray(B), lower))
    got = ops.vmem_solve_triangular(torch.as_tensor(T), torch.as_tensor(B), lower)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    # the other triangle is never read; junk is laid out in memory as T is
    # (an upper T is a transpose), since the CPU solve's rounding depends on
    # the layout and the check is exact
    junk = T + (np.triu(rng.randn(d, d), 1) if lower else np.tril(rng.randn(d, d), -1))
    junk = np.asarray(junk, order="F" if np.isfortran(T) else "C")
    got_junk = ops.vmem_solve_triangular(torch.as_tensor(junk), torch.as_tensor(B), lower)
    np.testing.assert_array_equal(got_junk.numpy(), got.numpy())


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("needs_T", [True, False])
def test_tri_solve_function_gradient_matches_jax(lower, needs_T):
    """The Function's adjoint (dB = T^{-T} g by the same op with lower
    flipped, dT = -dB X^T masked to the triangle) against jax.grad, atol
    1e-10; dT is formed only when T needs a gradient."""
    d, S = 40, 6
    rng = np.random.RandomState(3)
    T, B, W = _triangle(d, lower, rng), rng.randn(d, S), rng.randn(d, S)

    def f_j(T, B):
        return jnp.sum(W * jnp.sin(solve_triangular(T, B, lower=lower)))

    gT_j, gB_j = jax.grad(f_j, (0, 1))(jnp.asarray(T), jnp.asarray(B))
    Tt = torch.as_tensor(T).requires_grad_(needs_T)
    Bt = torch.as_tensor(B).requires_grad_(True)
    val = torch.sum(torch.as_tensor(W) * torch.sin(_TriSolve.apply(Tt, Bt, lower)))
    val.backward()
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gB_j), atol=1e-10)
    if needs_T:
        # jax.grad of solve_triangular is the masked adjoint too
        np.testing.assert_allclose(Tt.grad.numpy(), np.asarray(gT_j), atol=1e-10)
    else:
        assert Tt.grad is None


def test_log_density_score_and_kl_match_jax():
    """The solves vi_diagnostics runs: FullRankGaussian.log_density, its
    score in x (the KSD null score, through the adjoint) and the closed-form
    KL, rtol 1e-10; at d=300 the JAX side takes its blocked solve."""
    d = 300
    rng = np.random.RandomState(9)
    fj, ft = vj.FullRankGaussian(d), vt.FullRankGaussian(d, device="cpu",
                                                         dtype=torch.float64)
    vp0 = np.concatenate([rng.randn(d), 0.02 * rng.randn(d * d)])
    vp1 = np.concatenate([rng.randn(d), 0.02 * rng.randn(d * d)])
    x = rng.randn(5, d)

    def logq_j(xx):
        return jnp.sum(fj.log_density(jnp.asarray(vp0), xx))

    val_j, score_j = jax.value_and_grad(logq_j)(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    val_t = torch.sum(ft.log_density(params_from_jax(vp0, ft), xt))
    (score_t,) = torch.autograd.grad(val_t, xt)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-10)
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(
        float(ft.kl(params_from_jax(vp0, ft), params_from_jax(vp1, ft))),
        float(fj.kl(jnp.asarray(vp0), jnp.asarray(vp1))), rtol=1e-10)


@pytest.mark.parametrize("kind", ["full", "mf"])
def test_pth_moment_matches_jax(kind):
    """pth_moment for p = 2 and 4, rtol 1e-8; other p raise."""
    d = 7
    rng = np.random.RandomState(4)
    if kind == "full":
        fj, ft = vj.FullRankGaussian(d), vt.FullRankGaussian(d, device="cpu",
                                                             dtype=torch.float64)
        vp = np.concatenate([rng.randn(d), 0.3 * rng.randn(d * d)])
    else:
        fj, ft = vj.MFGaussian(d), vt.MFGaussian(d, device="cpu", dtype=torch.float64)
        vp = 0.3 * rng.randn(2 * d)
    for p in (2, 4):
        assert ft.supports_pth_moment(p)
        np.testing.assert_allclose(float(ft.pth_moment(params_from_jax(vp, ft), p)),
                                   float(fj.pth_moment(jnp.asarray(vp), p)), rtol=1e-8)
    assert not ft.supports_pth_moment(3)
    with pytest.raises(ValueError):
        ft.pth_moment(params_from_jax(vp, ft), 3)
