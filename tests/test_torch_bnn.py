"""The port's Bayesian neural-network classifier (``zoo.bnn_classifier``)
against the plain reference of the benchmark
(``perfbench/reference/model_bnn_classifier.py`` and
``family_MFGaussian.py``, loaded by their paths), in float64 on the CPU at
a small size: the data, the log density and its gradient, the mean-field
start, a fit through ``bbvi``'s adaptive route, and the spans.

This file imports no JAX. The tests marked ``cuda`` replay the network's
steps from CUDA graphs and skip without a card; on a machine with one,

    python -m pytest tests/test_torch_bnn.py --noconftest -q
"""

import contextlib
import importlib.util
import io
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402
from viabel_torch.models import zoo  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)
SIZE = dict(n_data=16, in_dim=12, hidden=(8, 8), classes=3)
#: 12*8 + 8 + 8*8 + 8 + 8*3 + 3
D = 203
#: float64 on one machine: the port and the reference run the same
#: products, but not the same fused calls
RTOL = 1e-12
#: a seed whose 16 labels take every class at SIZE's widths
SEED = 5


def _reference(stem):
    path = Path(__file__).resolve().parents[1] / "perfbench" / "reference" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"{stem}_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref_model():
    return _reference("model_bnn_classifier")


@pytest.fixture(scope="module")
def ref_family():
    return _reference("family_MFGaussian")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bnn(seed=SEED, **kw):
    return zoo.bnn_classifier(**{**SIZE, **kw}, seed=seed, **F64)


def draws(n, seed=1, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return scale * torch.randn(n, D, generator=gen, dtype=torch.float64)


def test_bnn_dimension_is_every_weight_and_bias():
    _, dim = bnn()
    assert dim == D
    shapes = zoo._bnn_shapes(784, (400, 400), 10)
    assert sum(m * n + n for m, n in shapes) == 478_410


def test_bnn_data_equal_the_references(ref_model):
    x, y = zoo._bnn_data(SIZE["n_data"], zoo._bnn_shapes(12, (8, 8), 3), SEED)
    ref_x, ref_y = ref_model.data(seed=SEED, **SIZE)
    assert np.array_equal(x, ref_x) and np.array_equal(y, ref_y)
    assert x.min() >= 0.0 and x.max() < 1.0
    assert set(y.tolist()) == {0, 1, 2}
    other, _ = zoo._bnn_data(SIZE["n_data"], zoo._bnn_shapes(12, (8, 8), 3), SEED + 1)
    assert not np.array_equal(x, other)


def test_bnn_log_density_and_gradient_match_the_reference(ref_model):
    model, _ = bnn()
    log_p = ref_model.build(data_seed=SEED, dtype=torch.float64, device="cpu", **SIZE)
    # more draws than the reference's block, so its blocks are joined
    theta = draws(230).requires_grad_(True)
    value = model(theta)
    ref_value = log_p(theta)
    torch.testing.assert_close(value, ref_value, rtol=RTOL, atol=0.0)
    (grad,) = torch.autograd.grad(value.sum(), theta)
    (ref_grad,) = torch.autograd.grad(ref_value.sum(), theta)
    scale = float(ref_grad.abs().max())
    assert float((grad - ref_grad).abs().max()) <= RTOL * scale


def test_bnn_log_density_is_the_written_network():
    """One draw worked out by hand: layers as matrices, the 1/sqrt(fan_in)
    scaling, log-softmax at the labels and the unit Gaussian prior."""
    model, _ = bnn()
    x, y = zoo._bnn_data(SIZE["n_data"], zoo._bnn_shapes(12, (8, 8), 3), SEED)
    theta = draws(1, seed=3)[0]
    W1, b1 = theta[:96].reshape(12, 8), theta[96:104]
    W2, b2 = theta[104:168].reshape(8, 8), theta[168:176]
    W3, b3 = theta[176:200].reshape(8, 3), theta[200:203]
    h = torch.relu(torch.as_tensor(x) @ W1 / math.sqrt(12) + b1)
    h = torch.relu(h @ W2 / math.sqrt(8) + b2)
    f = h @ W3 / math.sqrt(8) + b3
    loglik = torch.log_softmax(f, dim=1)[torch.arange(16), torch.as_tensor(y)].sum()
    prior = -0.5 * torch.sum(theta**2) - 0.5 * D * math.log(2 * math.pi)
    torch.testing.assert_close(model(theta[None])[0], loglik + prior, rtol=RTOL, atol=0.0)


def test_bnn_takes_any_number_of_draws_and_views_its_input():
    model, _ = bnn()
    theta = draws(7)
    whole = model(theta)
    for S in (1, 3):
        torch.testing.assert_close(model(theta[:S]), whole[:S], rtol=1e-14, atol=0.0)
    # a strided (S, d) view, as a history ring's rows are
    wide = torch.zeros(7, 2 * D, dtype=torch.float64)
    wide[:, :D] = theta
    torch.testing.assert_close(model(wide[:, :D]), whole, rtol=1e-14, atol=0.0)


def test_mfgaussian_default_start_is_the_references():
    q = vt.MFGaussian(5, **F64)
    start = q.init_param()
    assert torch.equal(start[:5], torch.zeros(5, dtype=torch.float64))
    assert torch.equal(start[5:], torch.full((5,), 2.0, dtype=torch.float64))
    assert torch.equal(vt.MFStudentT(5, 4.0, **F64).init_param(), start)


@pytest.mark.parametrize("init_log_sigma", [0.0, -1.5])
def test_mfgaussian_init_log_sigma_sets_the_start(ref_family, init_log_sigma):
    q = vt.MFGaussian(D, init_log_sigma=init_log_sigma, **F64)
    start = q.init_param()
    mu, log_sigma = q.unpack(start)
    assert not torch.any(mu)
    assert torch.equal(log_sigma, torch.full((D,), init_log_sigma, dtype=torch.float64))
    assert torch.equal(start, ref_family.Family(D, init_log_sigma).init(torch.float64, "cpu"))


def test_mfgaussian_matches_its_reference(ref_family):
    q = vt.MFGaussian(D, **F64)
    ref = ref_family.Family(D)
    vp = torch.cat([draws(1, seed=6)[0], 0.3 * draws(1, seed=7)[0]])
    z = draws(9, seed=8)
    x = q.sample(vp, 9, torch.Generator().manual_seed(8))
    torch.testing.assert_close(x, ref.draws(vp, z), rtol=RTOL, atol=0.0)
    torch.testing.assert_close(q.log_density(vp, x), ref.log_q(vp, x), rtol=RTOL, atol=0.0)
    torch.testing.assert_close(q.entropy(vp), ref.entropy(vp), rtol=RTOL, atol=0.0)
    c2, c4, spec = ref.moments(vp)
    torch.testing.assert_close(q.pth_moment(vp, 2), c2, rtol=RTOL, atol=0.0)
    torch.testing.assert_close(q.pth_moment(vp, 4), c4, rtol=RTOL, atol=0.0)
    torch.testing.assert_close(torch.linalg.matrix_norm(q.mean_and_cov(vp)[1], ord=2), spec,
                               rtol=RTOL, atol=0.0)


def test_stl_loss_and_gradient_match_the_reference(ref_model, ref_family):
    model, _ = bnn()
    q = vt.MFGaussian(D, init_log_sigma=0.0, **F64)
    vp = q.init_param() + 0.1 * torch.cat([draws(1, seed=2)[0], draws(1, seed=3)[0]])
    objective = vt.ExclusiveKL(q, model, 12, use_path_deriv=True)
    value, grad = objective.value_and_grad(vp, torch.Generator().manual_seed(8))
    z = torch.randn(12, D, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    log_p = ref_model.build(data_seed=SEED, dtype=torch.float64, device="cpu", **SIZE)
    fam = ref_family.Family(D, 0.0)
    v = vp.clone().requires_grad_(True)
    x = fam.draws(v, z)
    ref_value = -torch.mean(log_p(x) - fam.log_q(v.detach(), x))
    (ref_grad,) = torch.autograd.grad(ref_value, v)
    torch.testing.assert_close(value, ref_value.detach(), rtol=RTOL, atol=0.0)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-10, atol=1e-12)


def test_bnn_states_its_steps_replayable():
    model, _ = bnn()
    q = vt.MFGaussian(D, init_log_sigma=0.0, **F64)
    assert model.graph_refusal() is None
    assert vt.ExclusiveKL(q, model, 10, use_path_deriv=True).graph_refusal() is None


def _layer_means(mu):
    """``{layer: (W, b)}`` of the means at SIZE's widths."""
    out, at = {}, 0
    for i, (m, n) in enumerate(zoo._bnn_shapes(12, (8, 8), 3)):
        out[i] = (mu[at:at + m * n], mu[at + m * n:at + m * n + n])
        at += m * n + n
    return out


def test_bnn_fits_through_bbvis_adaptive_route_and_moves_every_layer():
    model, _ = bnn()
    q = vt.MFGaussian(D, init_log_sigma=0.0, **F64)
    objective = vt.ExclusiveKL(q, model, 10, use_path_deriv=True)
    with contextlib.redirect_stdout(io.StringIO()):
        res = vt.bbvi(D, objective=objective, n_iters=450, learning_rate=0.01,
                      generator=torch.Generator().manual_seed(0),
                      RMS_kwargs=dict(diagnostics=False),
                      RAABBVI_kwargs=dict(max_history=400, mc_max_samples=40))
    values = res["value_history"]
    assert values.shape[0] == 450 and torch.isfinite(values).all()
    assert float(values[-50:].mean()) < float(values[:50].mean())
    mu, log_sigma = q.unpack(res["opt_param"])
    for i, (W, b) in _layer_means(mu).items():
        assert torch.count_nonzero(W) == W.numel() and torch.count_nonzero(b) == b.numel(), i
    assert torch.count_nonzero(log_sigma) == D
    assert float(log_sigma.mean()) < 0.0  # q narrows from its prior's scale


def test_bnn_opens_its_spans_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    model, _ = bnn()
    theta = draws(4)
    plain = model(theta)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = model(theta)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("viabel.bnn.log_density") == 1 and names.count("viabel.bnn.prior") == 1
    assert torch.equal(plain, traced)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bnn_replayed_steps_equal_eager_steps(dtype):
    """FASO on the card replays the network's step from CUDA graphs; an
    eager run (a step rule that states nothing about replay) gives the
    same iterates, losses and ring to the bit, across an escalation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    class EagerRMSProp(vt.RMSProp):
        pass

    def run(sgo_class):
        model, dim = zoo.bnn_classifier(n_data=64, in_dim=48, hidden=(32, 32), classes=10,
                                        seed=2, device="cuda", dtype=dtype)
        q = vt.MFGaussian(dim, init_log_sigma=0.0, device="cuda", dtype=dtype)
        objective = vt.ExclusiveKL(q, model, 10, use_path_deriv=True)
        faso = vt.FASO(sgo_class(0.001), W_min=20, k_check=20, max_history=80)
        gen = torch.Generator("cuda").manual_seed(3)

        def escalate(k, loss):
            if k == 20:
                objective.num_mc_samples = 40

        res = faso.optimize(60, objective, q.init_param(), generator=gen,
                            progress_callback=escalate)
        return res, faso._graphed

    got, graphed = run(vt.RMSProp)
    ref, none = run(EagerRMSProp)
    assert none is None and graphed is not None
    # two eager steps at S = 10 and two at 40, every other step replayed
    assert graphed.replays == got["value_history"].shape[0] - 4
    assert set(graphed.graphs) == {10, 40}
    assert torch.equal(got["value_history"], ref["value_history"])
    assert torch.equal(got["opt_param"], ref["opt_param"])
    assert torch.equal(got["resume_state"]["ring"], ref["resume_state"]["ring"])
