"""viabel_torch's constrained-parameter transforms against the JAX package,
in float64 on the CPU: every bijector's forward map, inverse and
log-det-Jacobian, the log-det also against the slogdet of the autograd
Jacobian onto the block's free coordinates (where a dropped term of the
stick-breaking or the CPC product would show), and ``ParamSpec`` /
``TransformedModel`` values and gradients against ``jax.grad``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from viabel_tpu import transforms as jtr  # noqa: E402
from viabel_torch import transforms as ttr  # noqa: E402

RTOL = 1e-12

# (name, factory(module), constrained size, unconstrained size)
BIJECTORS = [
    ("identity", lambda tr: tr.identity(), 4, 4),
    ("affine", lambda tr: tr.affine(np.array([1.0, -2.0, 0.5]),
                                    np.array([0.3, 4.0, 1.7])), 3, 3),
    ("affine_scalar", lambda tr: tr.affine(-1.5, 2.5), 3, 3),
    ("positive", lambda tr: tr.positive(), 3, 3),
    ("lower", lambda tr: tr.lower_bound(-2.5), 3, 3),
    ("upper", lambda tr: tr.upper_bound(1.5), 3, 3),
    ("interval", lambda tr: tr.interval(-1.0, 3.0), 3, 3),
    ("unit_interval", lambda tr: tr.unit_interval(), 2, 2),
    ("simplex", lambda tr: tr.simplex(), 7, 6),
    ("ordered", lambda tr: tr.ordered(), 4, 4),
    ("corr_chol", lambda tr: tr.corr_cholesky(5), 25, 10),
]


def _free_coords(name, k, y):
    """A constrained block's free coordinates: the simplex drops its last
    coordinate, the correlation Cholesky factor keeps its strict lower
    triangle, every other map is square."""
    if name == "simplex":
        return y[..., :-1]
    if name == "corr_chol":
        rows, cols = np.tril_indices(k, -1)
        return y.reshape(y.shape[:-1] + (k, k))[..., rows, cols]
    return y


@pytest.mark.parametrize("name,factory,size,m", BIJECTORS, ids=[b[0] for b in BIJECTORS])
def test_bijector_matches_jax_and_autograd(name, factory, size, m):
    """forward, inverse, forward_log_det_jacobian and forward_and_fldj
    against JAX at rtol 1e-12 over a batch; the log-det also against
    slogdet of ``torch.autograd.functional.jacobian`` at each point."""
    bj, bt = factory(jtr), factory(ttr)
    assert bt.unconstrained_size(size) == m
    x = np.random.RandomState(0).randn(6, m)
    xt = torch.as_tensor(x)
    y_j = np.asarray(bj.forward(jnp.asarray(x)))
    y_t = bt.forward(xt)
    assert y_t.shape == (6, size)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(bt.inverse(y_t).numpy(), np.asarray(bj.inverse(jnp.asarray(y_j))),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(bt.inverse(y_t).numpy(), x, rtol=1e-9, atol=1e-9)
    fldj_j = np.asarray(bj.forward_log_det_jacobian(jnp.asarray(x)))
    np.testing.assert_allclose(bt.forward_log_det_jacobian(xt).numpy(), fldj_j,
                               rtol=RTOL, atol=1e-14)
    y2, fldj2 = bt.forward_and_fldj(xt)
    np.testing.assert_allclose(y2.numpy(), y_j, rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(fldj2.numpy(), fldj_j, rtol=RTOL, atol=1e-14)
    k = getattr(bt, "k", None)
    for i in range(x.shape[0]):
        jac = torch.autograd.functional.jacobian(
            lambda v: _free_coords(name, k, bt.forward(v)), xt[i])
        _, logdet = torch.linalg.slogdet(jac)
        np.testing.assert_allclose(float(fldj2[i]), float(logdet), rtol=1e-10, atol=1e-10)


def test_bijector_validation_matches_jax():
    """The constructors' and block sizes' ValueErrors."""
    for tr in (jtr, ttr):
        with pytest.raises(ValueError, match="lo < hi"):
            tr.interval(2.0, 2.0)
        with pytest.raises(ValueError, match="strictly positive"):
            tr.affine(0.0, np.array([1.0, -1.0]))
        with pytest.raises(ValueError, match="K >= 2"):
            tr.corr_cholesky(1)
        with pytest.raises(ValueError, match="size >= 2"):
            tr.ParamSpec([("w", 1, tr.simplex())])
        with pytest.raises(ValueError, match="dense"):
            tr.ParamSpec([("L", 9, tr.corr_cholesky(4))])
        with pytest.raises(ValueError, match="duplicate"):
            tr.ParamSpec([("a", 2, tr.identity()), ("a", 1, tr.positive())])


def _spec(tr):
    return tr.ParamSpec([("beta", 3, tr.identity()), ("sigma", 1, tr.positive()),
                         ("w", 4, tr.simplex()), ("p", 1, tr.unit_interval()),
                         ("L", 9, tr.corr_cholesky(3)), ("c", 3, tr.ordered()),
                         ("s", 2, tr.affine(np.array([0.5, -1.0]), np.array([2.0, 0.1])))])


def test_param_spec_matches_jax():
    """Layout, the size-1 squeeze, constrain, constrain_and_fldj and
    unconstrain on batches and on a single vector, at rtol 1e-12."""
    sj, st = _spec(jtr), _spec(ttr)
    assert st.dim == sj.dim == 3 + 1 + 3 + 1 + 3 + 3 + 2
    assert st.names == sj.names
    z = np.random.RandomState(1).randn(5, st.dim)
    out_j, fldj_j = jax.jit(sj.constrain_and_fldj)(jnp.asarray(z))
    out_t, fldj_t = st.constrain_and_fldj(torch.as_tensor(z))
    np.testing.assert_allclose(fldj_t.numpy(), np.asarray(fldj_j), rtol=RTOL)
    for name in sj.names:
        assert tuple(out_t[name].shape) == tuple(out_j[name].shape)
        np.testing.assert_allclose(out_t[name].numpy(), np.asarray(out_j[name]),
                                   rtol=RTOL, atol=1e-15)
        np.testing.assert_allclose(st.constrain(torch.as_tensor(z))[name].numpy(),
                                   np.asarray(out_j[name]), rtol=RTOL, atol=1e-15)
    assert out_t["sigma"].shape == (5,) and out_t["w"].shape == (5, 4)
    np.testing.assert_allclose(st.unconstrain(out_t).numpy(), z, rtol=1e-9, atol=1e-9)
    single = st.constrain(torch.as_tensor(z[0]))
    assert single["sigma"].shape == ()
    np.testing.assert_allclose(single["w"].numpy(), out_t["w"][0].numpy(), rtol=1e-15)


def _target(xp):
    """A log density over the spec's constrained blocks."""
    s = jnp if xp is jnp else torch

    def log_density(p):
        return (-0.5 * s.sum(p["beta"] ** 2, -1) - p["sigma"] + s.log(p["sigma"])
                + s.sum(s.log(p["w"]) * (1.0 + s.arange(4.0)), -1)
                + 2.0 * s.log(p["p"]) + s.log1p(-p["p"])
                + s.sum(p["L"][..., [3, 6, 7]] ** 2, -1)
                - 0.5 * s.sum(p["c"] ** 2, -1) - 0.5 * s.sum(p["s"] ** 2, -1))
    return log_density


def test_transformed_model_value_and_grad_match_jax():
    """TransformedModel's pushforward log density and its gradient (by
    autograd, against ``jax.grad``) at rtol 1e-12; its ``constrain`` is the
    spec's."""
    sj, st = _spec(jtr), _spec(ttr)
    model_j = jtr.TransformedModel(_target(jnp), sj)
    model_t = ttr.TransformedModel(_target(torch), st)
    assert model_t.spec is st
    z = np.random.RandomState(2).randn(4, st.dim)
    np.testing.assert_allclose(model_t(torch.as_tensor(z)).numpy(),
                               np.asarray(jax.jit(model_j)(jnp.asarray(z))), rtol=RTOL)
    grad_j = jax.jit(jax.grad(lambda v: jnp.sum(model_j(v))))(jnp.asarray(z))
    zt = torch.as_tensor(z).requires_grad_(True)
    (grad_t,) = torch.autograd.grad(torch.sum(model_t(zt)), zt)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=RTOL, atol=1e-13)
    want = jax.jit(model_j.constrain)(jnp.asarray(z[1]))
    for name in st.names:
        np.testing.assert_allclose(model_t.constrain(torch.as_tensor(z[1]))[name].numpy(),
                                   np.asarray(want[name]), rtol=RTOL, atol=1e-15)
