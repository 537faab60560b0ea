"""viabel_torch's model extras (``TemperedModel``, ``Model.from_single`` and
``constrain``, ``SubsampledModel``) and the objectives' minibatch protocol
against the JAX package, in float64 on the CPU.

The JAX package draws a step's minibatch from half of the step key; torch
cannot reproduce that stream, so the JAX indices are recomputed from the
key and injected through ``SubsampledModel(index_sampler=...)``. Base
normals come from one numpy table through the families' ``base_sampler``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from test_torch_families import TableNormal, TorchTableNormal  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10
D, N, B = 4, 50, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    y = (rng.rand(N) < 0.5).astype(np.float64)
    return X, y


def _logistic(xp):
    """The logistic-regression prior and summed likelihood over a ``(X,
    y)`` batch, in either package's array module."""
    if xp is jnp:
        def log_prior(beta):
            return -0.5 * jnp.sum(beta**2, axis=-1)

        def log_lik(beta, batch):
            X, y = batch
            logits = beta @ X.T
            return jnp.sum(y * logits - jnp.logaddexp(0.0, logits), axis=-1)
    else:
        def log_prior(beta):
            return -0.5 * torch.sum(beta**2, dim=-1)

        def log_lik(beta, batch):
            X, y = batch
            logits = beta @ X.T
            return torch.sum(y * logits - torch.nn.functional.softplus(logits), dim=-1)
    return log_prior, log_lik


class FixedIndices:
    """An index hook handing out given index rows in order, counting calls."""

    def __init__(self, rows):
        self.rows, self.calls = list(rows), 0

    def __call__(self, generator, n_data, batch_size, device):
        self.calls += 1
        idx = torch.as_tensor(np.array(self.rows.pop(0)), dtype=torch.long,
                              device=device)
        assert idx.shape == (batch_size,) and int(idx.max()) < n_data
        return idx


def _jax_step_indices(key, n_data=N, batch_size=B):
    """The minibatch the JAX package's objective step draws from ``key``
    (objectives.py:55-69, models/base.py:157)."""
    _, model_key = jax.random.split(key)
    return np.asarray(jax.random.randint(model_key, (batch_size,), 0, n_data))


def test_tempered_model_matches_jax():
    """beta * log_density at two temperatures, and the hooks' flags."""
    x = np.random.RandomState(1).randn(3, D)
    model_j = vj.TemperedModel(lambda v: -0.5 * jnp.sum(v**2, axis=-1), inverse_temp=0.5)
    model_t = vt.TemperedModel(lambda v: -0.5 * torch.sum(v**2, dim=-1), inverse_temp=0.5)
    assert model_t.supports_tempering and model_j.supports_tempering
    for beta in (0.5, 0.25):
        model_j.set_inverse_temperature(beta)
        model_t.set_inverse_temperature(beta)
        np.testing.assert_allclose(model_t(torch.as_tensor(x)).numpy(),
                                   np.asarray(model_j(jnp.asarray(x))), rtol=1e-15)


def test_model_from_single_and_constrain():
    """``from_single`` batches a per-sample density with ``torch.func.vmap``
    (the JAX package's ``jax.vmap``); ``constrain`` needs a
    ``constrain_fn``; the base model has no tempering."""
    x = np.random.RandomState(2).randn(5, D)
    model_j = vj.Model.from_single(lambda v: -jnp.sum(jnp.cos(v) * v**2))
    model_t = vt.Model.from_single(lambda v: -torch.sum(torch.cos(v) * v**2))
    np.testing.assert_allclose(model_t(torch.as_tensor(x)).numpy(),
                               np.asarray(model_j(jnp.asarray(x))), rtol=1e-15)
    assert not model_t.supports_tempering
    with pytest.raises(NotImplementedError):
        model_t.set_inverse_temperature(0.5)
    with pytest.raises(NotImplementedError):
        model_t.constrain(torch.zeros(D))
    model_t = vt.Model(lambda v: v.sum(-1), constrain_fn=lambda v: {"x": torch.exp(v)})
    model_j = vj.Model(lambda v: v.sum(-1), constrain_fn=lambda v: {"x": jnp.exp(v)})
    np.testing.assert_allclose(model_t.constrain(torch.as_tensor(x))["x"].numpy(),
                               np.asarray(model_j.constrain(jnp.asarray(x))["x"]),
                               rtol=1e-15)


@pytest.mark.parametrize("layout", ["tuple", "dict", "tensor"])
def test_subsampled_model_injected_indices_match_jax(layout):
    """With the JAX step's indices injected, the minibatch estimate equals
    JAX's ``log_prior + (n/b) log_lik(data[idx])`` to 1e-13, for data as a
    tuple, a dict and a single tensor; the full-data log density equals
    JAX's."""
    X, y = _data()
    beta = np.random.RandomState(3).randn(6, D)
    lp_j, ll_j = _logistic(jnp)
    lp_t, ll_t = _logistic(torch)
    if layout == "tuple":
        data_j, data_t = (jnp.asarray(X), jnp.asarray(y)), (torch.as_tensor(X),
                                                          torch.as_tensor(y))
    elif layout == "dict":
        data_j = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
        data_t = {"X": torch.as_tensor(X), "y": torch.as_tensor(y)}
        ll_j = (lambda f: lambda b, d: f(b, (d["X"], d["y"])))(ll_j)
        ll_t = (lambda f: lambda b, d: f(b, (d["X"], d["y"])))(ll_t)
    else:
        Xy = np.concatenate([X, y[:, None]], axis=1)
        data_j, data_t = jnp.asarray(Xy), torch.as_tensor(Xy)
        ll_j = (lambda f: lambda b, d: f(b, (d[:, :D], d[:, D])))(ll_j)
        ll_t = (lambda f: lambda b, d: f(b, (d[:, :D], d[:, D])))(ll_t)
    keys = [jax.random.PRNGKey(s) for s in range(3)]
    rows = [np.asarray(jax.random.randint(k, (B,), 0, N)) for k in keys]
    model_j = vj.SubsampledModel(lp_j, ll_j, data_j, B)
    model_t = vt.SubsampledModel(lp_t, ll_t, data_t, B, index_sampler=FixedIndices(rows))
    assert model_t.needs_generator and not vt.Model(lp_t).needs_generator
    assert (model_t.n_data, model_t.batch_size) == (N, B)
    for key in keys:
        got = model_t(torch.as_tensor(beta), None)
        np.testing.assert_allclose(got.numpy(), np.asarray(model_j(jnp.asarray(beta), key)),
                                   rtol=1e-13)
    np.testing.assert_allclose(model_t.full_data_log_density(torch.as_tensor(beta)).numpy(),
                               np.asarray(model_j.full_data_log_density(jnp.asarray(beta))),
                               rtol=1e-13)


def test_subsampled_model_default_draw_is_uniform_with_replacement():
    """The default hook draws ``batch_size`` indices in [0, n_data) from the
    generator: the same generator state gives the same minibatch."""
    X, y = _data()
    lp_t, ll_t = _logistic(torch)
    model = vt.SubsampledModel(lp_t, ll_t, (torch.as_tensor(X), torch.as_tensor(y)), 30)
    idx = model.draw_indices(torch.Generator().manual_seed(4))
    assert idx.shape == (30,) and int(idx.min()) >= 0 and int(idx.max()) < N
    assert len(set(idx.tolist())) < 30  # with replacement, 30 of 50 collide
    torch.testing.assert_close(model.draw_indices(torch.Generator().manual_seed(4)), idx)
    beta = torch.as_tensor(np.random.RandomState(5).randn(2, D))
    torch.testing.assert_close(model(beta, torch.Generator().manual_seed(4)),
                               model.bind(torch.Generator().manual_seed(4))(beta))


@pytest.mark.parametrize("case", ["batch_size", "leading", "empty"])
def test_subsampled_model_validation_errors_match_jax(case):
    """The JAX package's three ValueErrors, with its messages."""
    def args(xp, zeros):
        prior = (lambda x: x.sum(-1))  # noqa: E731
        lik = (lambda x, b: x.sum(-1))  # noqa: E731
        data = {"batch_size": (zeros(10), 11),
                "leading": ({"a": zeros(10), "b": zeros(9)}, 2),
                "empty": ({}, 2)}[case]
        return prior, lik, *data

    with pytest.raises(ValueError) as exc_j:
        vj.SubsampledModel(*args(jnp, jnp.zeros))
    with pytest.raises(ValueError) as exc_t:
        vt.SubsampledModel(*args(torch, lambda n: torch.zeros(n)))
    assert str(exc_t.value) == str(exc_j.value)


def _subsampled_pair(rows):
    X, y = _data()
    lp_j, ll_j = _logistic(jnp)
    lp_t, ll_t = _logistic(torch)
    hook = FixedIndices(rows)
    model_j = vj.SubsampledModel(lp_j, ll_j, (jnp.asarray(X), jnp.asarray(y)), B)
    model_t = vt.SubsampledModel(lp_t, ll_t, (torch.as_tensor(X), torch.as_tensor(y)), B,
                                 index_sampler=hook)
    return model_j, model_t, hook


@pytest.mark.parametrize("estimator", ["entropy", "stl", "mean_only", "loo_diag_approx"])
def test_exclusive_kl_binds_one_minibatch_a_step(estimator):
    """ExclusiveKL over a SubsampledModel against JAX's, the JAX step's
    minibatch injected: one index draw a step, read by every model
    evaluation of the step (with the control variates, the value, the
    gradient samples and the Hessian-vector products), value and gradient
    at rtol 1e-10 over three steps."""
    keys = [jax.random.PRNGKey(s) for s in (7, 8, 9)]
    model_j, model_t, hook = _subsampled_pair([_jax_step_indices(k) for k in keys])
    table = np.random.RandomState(6).randn(64, D)
    kw = {"entropy": {}, "stl": dict(use_path_deriv=True),
          "mean_only": dict(hessian_approx_method="mean_only"),
          "loo_diag_approx": dict(hessian_approx_method="loo_diag_approx")}[estimator]
    obj_j = vj.ExclusiveKL(vj.MFGaussian(D, base_sampler=TableNormal(table)), model_j, 10, **kw)
    obj_t = vt.ExclusiveKL(vt.MFGaussian(D, base_sampler=TorchTableNormal(table), **CPU),
                           model_t, 10, **kw)
    vp = 0.3 * np.random.RandomState(10).randn(2 * D)
    for step, key in enumerate(keys, start=1):
        val_j, grad_j = obj_j.value_and_grad(jnp.asarray(vp), key)
        val_t, grad_t = obj_t.value_and_grad(torch.as_tensor(vp), None)
        assert hook.calls == step
        np.testing.assert_allclose(float(val_t), float(val_j), rtol=RTOL)
        np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name", ["IWELBO", "AlphaDivergence", "DISInclusiveKL"])
def test_importance_weight_objectives_refuse_a_subsampled_model(name):
    """IWELBO, AlphaDivergence and DISInclusiveKL raise JAX's ValueError for
    a subsampled model, at construction and through the model setter."""
    model_j, model_t, _ = _subsampled_pair([])

    def build(pkg, family, model, **family_kw):
        extra = {"IWELBO": {}, "AlphaDivergence": dict(alpha=2.0),
                 "DISInclusiveKL": dict(ess_target=5, temper_prior=family(D, **family_kw),
                                        temper_prior_params=np.zeros(2 * D))}[name]
        return getattr(pkg, name)(family(D, **family_kw), model, 10, **extra)

    with pytest.raises(ValueError) as exc_j:
        build(vj, vj.MFGaussian, model_j)
    with pytest.raises(ValueError) as exc_t:
        build(vt, vt.MFGaussian, model_t, **CPU)
    assert str(exc_t.value) == str(exc_j.value)
    assert "use ExclusiveKL for SubsampledModel" in str(exc_t.value)
    objective = build(vt, vt.MFGaussian, vt.Model(lambda x: -torch.sum(x**2, -1)), **CPU)
    with pytest.raises(ValueError, match=name):
        objective.model = model_t


def test_model_setter_swaps_the_model_of_the_next_step():
    """The setter is all a rebind needs: the next step reads the new
    model."""
    table = np.random.RandomState(11).randn(16, D)
    approx = vt.MFGaussian(D, base_sampler=TorchTableNormal(table), **CPU)
    first = vt.Model(lambda x: -0.5 * torch.sum(x**2, -1))
    second = vt.Model(lambda x: -0.5 * torch.sum((x - 1.0) ** 2, -1))
    objective = vt.ExclusiveKL(approx, first, 10)
    vp = approx.init_param()
    swapped = vt.ExclusiveKL(approx, second, 10).value_and_grad(vp, None)
    objective.model = second
    assert objective.model is second
    got = objective.value_and_grad(vp, None)
    torch.testing.assert_close(got[0], swapped[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], swapped[1], rtol=0, atol=0)


@pytest.mark.parametrize("use_path_deriv", [False, True])
def test_keyless_model_keeps_its_generator_stream(use_path_deriv):
    """A model that draws nothing leaves the generator's stream exactly as
    it was: the ExclusiveKL value from seed 0 equals, bit for bit, the one
    formed by hand from that seed's draws, and the generator ends where the
    family's draw alone leaves it. A subsampled model draws its indices
    first, from the same generator."""
    model = vt.zoo.logistic_regression(dim=D, n_data=30, **CPU)[0]
    approx = vt.MFGaussian(D, **CPU)
    vp = torch.as_tensor(0.3 * np.random.RandomState(12).randn(2 * D))
    gen = torch.Generator().manual_seed(0)
    value, _ = vt.ExclusiveKL(approx, model, 10, use_path_deriv=use_path_deriv
                              ).value_and_grad(vp, gen)
    ref = torch.Generator().manual_seed(0)
    z = torch.randn((10, D), generator=ref, dtype=torch.float64)
    x = vp[:D] + torch.exp(vp[D:]) * z
    if use_path_deriv:
        want = -torch.mean(model(x) - approx.log_density(vp, x))
    else:
        want = -(torch.mean(model(x)) + approx.entropy(vp))
    assert float(value) == float(want)
    assert torch.equal(gen.get_state(), ref.get_state())
    X, y = _data()
    lp_t, ll_t = _logistic(torch)
    sub = vt.SubsampledModel(lp_t, ll_t, (torch.as_tensor(X), torch.as_tensor(y)), B)
    gen = torch.Generator().manual_seed(0)
    vt.ExclusiveKL(approx, sub, 10, use_path_deriv=use_path_deriv).value_and_grad(vp, gen)
    ref = torch.Generator().manual_seed(0)
    torch.randint(0, N, (B,), generator=ref)
    torch.randn((10, D), generator=ref, dtype=torch.float64)
    assert torch.equal(gen.get_state(), ref.get_state())
