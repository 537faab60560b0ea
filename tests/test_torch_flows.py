"""The port's NeuralNet and NVPFlow families against the JAX package.

Both packages push the same base normals (one numpy table, handed to each
family's ``base_sampler``) through networks with the same flat
parameters, in float64 on the CPU, so every output agrees to round-off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from viabel_torch.convert import params_from_jax  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class TableNormal:
    """The first rows of one numpy table of standard normals, for either
    package's hook."""

    def __init__(self, table):
        self.table = table

    def normal(self, key, n_samples, width, dtype, device=None):
        rows = self.table[:n_samples, :width]
        if device is None:
            return jnp.asarray(rows, dtype=dtype)
        return torch.as_tensor(rows, dtype=dtype, device=device)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def _nets(d, square, seed=0, table=None):
    """A tanh MLP (square: two (d, d) layers, identity last; otherwise
    (d, 5) then (5, d), tanh last) in both packages, with one parameter."""
    if square:
        shapes, last_j, last_t = [(d, d), (d, d)], (lambda x: x), (lambda x: x)
    else:
        shapes, last_j, last_t = [(d, 5), (5, d)], jnp.tanh, torch.tanh
    sampler = TableNormal(np.random.RandomState(seed).randn(64, d) if table is None
                          else table)
    net_j = vj.NeuralNet(shapes, last=last_j, base_sampler=sampler)
    net_t = vt.NeuralNet(shapes, last=last_t, base_sampler=sampler, **F64)
    vp = 0.5 * np.random.RandomState(seed + 1).randn(net_j.var_param_dim)
    return net_j, net_t, vp


def _flows(d, seed=0):
    """A two-coupling RealNVP flow over an MFGaussian prior at a non-zero
    parameter, in both packages; masks alternate (one row, half at d=1)."""
    mask = (np.array([[1.0], [0.0]]) if d == 1
            else np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]]))
    layers = [(d, 6), (6, d)]
    table = TableNormal(np.random.RandomState(seed).randn(64, d))
    prior_param = 0.2 * np.random.RandomState(seed + 2).randn(2 * d)
    flow_j = vj.NVPFlow(layers, layers, mask, vj.MFGaussian(d, base_sampler=table),
                        prior_param, d)
    flow_t = vt.NVPFlow(layers, layers, mask, vt.MFGaussian(d, base_sampler=table, **F64),
                        prior_param, d)
    vp = 0.4 * np.random.RandomState(seed + 1).randn(flow_j.var_param_dim)
    return flow_j, flow_t, vp


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("d", [1, 3])
def test_neural_net_forward_and_sample_match_jax(d, square):
    net_j, net_t, vp = _nets(d, square)
    assert net_t.var_param_dim == net_j.var_param_dim
    x = np.random.RandomState(7).randn(9, d)
    _close(net_t.forward(torch.as_tensor(vp), torch.as_tensor(x)),
           net_j.forward(jnp.asarray(vp), jnp.asarray(x)))
    _close(net_t.sample(torch.as_tensor(vp), 20, None),
           net_j.sample(jnp.asarray(vp), 20, jax.random.PRNGKey(0)))
    with pytest.raises(NotImplementedError):
        net_t.log_density(torch.as_tensor(vp), torch.as_tensor(x))


@pytest.mark.parametrize("d", [1, 3])
def test_neural_net_sample_and_log_density_matches_jax(d):
    """The exact pushforward density of a square net (jacfwd under vmap,
    then slogdet), and its gradient, to rtol 1e-10."""
    net_j, net_t, vp = _nets(d, square=True)
    x_j, lq_j = net_j.sample_and_log_density(jnp.asarray(vp), 16, jax.random.PRNGKey(0))
    p = torch.as_tensor(vp).requires_grad_(True)
    x_t, lq_t = net_t.sample_and_log_density(p, 16, None)
    _close(x_t, x_j)
    _close(lq_t, lq_j)
    (g_t,) = torch.autograd.grad(torch.sum(lq_t), p)
    g_j = jax.grad(lambda v: jnp.sum(net_j.sample_and_log_density(
        v, 16, jax.random.PRNGKey(0))[1]))(jnp.asarray(vp))
    _close(g_t, g_j)


def test_neural_net_affine_density_is_the_gaussian():
    """An affine square net (identity last) pushes N(0, I) to N(b, W^T W):
    the density at its own samples is that Gaussian's (the JAX package's
    tests/test_families.py check, in the port)."""
    from scipy import stats
    d = 3
    table = TableNormal(np.random.RandomState(31).randn(256, d))
    net = vt.NeuralNet([(d, d)], last=lambda x: x, base_sampler=table, **F64)
    rng = np.random.RandomState(32)
    W, b = rng.randn(d, d), rng.randn(d)
    vp = torch.as_tensor(np.concatenate([W.reshape(-1), b]))
    x, log_q = net.sample_and_log_density(vp, 256, None)
    expected = stats.multivariate_normal(mean=b, cov=W.T @ W).logpdf(x.numpy())
    np.testing.assert_allclose(log_q.numpy(), expected, rtol=1e-10, atol=1e-10)


def test_neural_net_density_needs_square_layers():
    net = vt.NeuralNet([(2, 4), (4, 2)], **F64)
    with pytest.raises(ValueError, match="square"):
        net.sample_and_log_density(torch.zeros(net.var_param_dim, dtype=torch.float64),
                                   4, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("d", [1, 3])
def test_nvp_flow_matches_jax(d):
    """g, f (with its log-determinant), log_density (and its gradient)
    and sample, to rtol 1e-10."""
    flow_j, flow_t, vp = _flows(d)
    assert flow_t.var_param_dim == flow_j.var_param_dim
    z = np.random.RandomState(8).randn(11, d)
    vp_j, vp_t = jnp.asarray(vp), torch.as_tensor(vp)
    _close(flow_t.g(vp_t, torch.as_tensor(z)), flow_j.g(vp_j, jnp.asarray(z)))
    z_t, ld_t = flow_t.f(vp_t, torch.as_tensor(z))
    z_j, ld_j = flow_j.f(vp_j, jnp.asarray(z))
    _close(z_t, z_j)
    _close(ld_t, ld_j)
    p = vp_t.clone().requires_grad_(True)
    lq_t = flow_t.log_density(p, torch.as_tensor(z))
    _close(lq_t, flow_j.log_density(vp_j, jnp.asarray(z)))
    (g_t,) = torch.autograd.grad(torch.sum(lq_t), p)
    g_j = jax.grad(lambda v: jnp.sum(flow_j.log_density(v, jnp.asarray(z))))(vp_j)
    _close(g_t, g_j)
    _close(flow_t.log_density(vp_t, torch.as_tensor(z[0])),
           flow_j.log_density(vp_j, jnp.asarray(z[0])))
    _close(flow_t.sample(vp_t, 20, None), flow_j.sample(vp_j, 20, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("d", [1, 3])
def test_nvp_flow_f_inverts_g(d):
    flow_j, flow_t, vp = _flows(d, seed=4)
    vp_t = torch.as_tensor(vp)
    z = torch.as_tensor(np.random.RandomState(9).randn(13, d))
    back, _ = flow_t.f(vp_t, flow_t.g(vp_t, z))
    _close(back, z.numpy(), rtol=1e-12, atol=1e-12)


def test_nvp_flow_mask_takes_the_parameter_dtype():
    """The mask is cast to the parameter's dtype where it is used, so a
    float32 mask does not round a float64 flow."""
    flow_j, flow_t, vp = _flows(3)
    flow_t.mask = flow_t.mask.to(torch.float32)
    z = torch.as_tensor(np.random.RandomState(10).randn(5, 3))
    out = flow_t.g(torch.as_tensor(vp), z)
    assert out.dtype == torch.float64
    _close(out, flow_j.g(jnp.asarray(vp), jnp.asarray(z.numpy())))


@pytest.mark.parametrize("family", ["neural_net", "nvp_flow"])
def test_exclusive_kl_through_the_new_families_matches_jax(family):
    """ExclusiveKL's value and gradient: a square NeuralNet through the
    sample_and_log_density branch, NVPFlow through sample and
    log_density."""
    d = 3
    if family == "neural_net":
        approx_j, approx_t, vp = _nets(d, square=True)
    else:
        approx_j, approx_t, vp = _flows(d)
    model_j, _ = vj.zoo.logistic_regression(dim=d, n_data=30)
    model_t, _ = vt.zoo.logistic_regression(dim=d, n_data=30, **F64)
    val_j, grad_j = vj.ExclusiveKL(approx_j, model_j, 12).value_and_grad(
        jnp.asarray(vp), jax.random.PRNGKey(0))
    val_t, grad_t = vt.ExclusiveKL(approx_t, model_t, 12).value_and_grad(
        torch.as_tensor(vp), None)
    _close(val_t, val_j)
    _close(grad_t, grad_j)


@pytest.mark.parametrize("family", ["neural_net", "nvp_flow"])
def test_params_from_jax_carries_both_layouts(family):
    """A JAX parameter of either layout moves 1:1 and gives the same
    samples; a wrong length is refused."""
    if family == "neural_net":
        approx_j, approx_t, vp = _nets(3, square=False)
    else:
        approx_j, approx_t, vp = _flows(3)
    vp_t = params_from_jax(jnp.asarray(vp), approx_t)
    assert vp_t.dtype == torch.float64 and vp_t.shape == (approx_t.var_param_dim,)
    _close(approx_t.sample(vp_t, 8, None),
           approx_j.sample(jnp.asarray(vp), 8, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError):
        params_from_jax(np.zeros(approx_t.var_param_dim + 1), approx_t)


@pytest.mark.parametrize("family", ["neural_net", "nvp_flow"])
def test_mean_and_cov_by_monte_carlo(family):
    """mean_and_cov by mc_samples internal draws from the generator: the
    same generator seed gives the same moments, a symmetric covariance of
    the family's width."""
    if family == "neural_net":
        approx = vt.NeuralNet([(3, 3), (3, 3)], mc_samples=500, **F64)
        vp = torch.as_tensor(0.5 * np.random.RandomState(1).randn(approx.var_param_dim))
    else:
        _, approx, vp = _flows(3)
        approx = vt.NVPFlow([(3, 6), (6, 3)], [(3, 6), (6, 3)], approx.mask,
                            vt.MFGaussian(3, **F64), np.zeros(6), 3, mc_samples=500)
        vp = torch.as_tensor(vp)
    m1, c1 = approx.mean_and_cov(vp, generator=torch.Generator().manual_seed(2))
    m2, c2 = approx.mean_and_cov(vp, generator=torch.Generator().manual_seed(2))
    assert torch.equal(m1, m2) and torch.equal(c1, c2)
    assert m1.shape == (3,) and c1.shape == (3, 3)
    torch.testing.assert_close(c1, c1.T)
    assert approx.supports_pth_moment(2) is False
