"""The port's RealNVP flow against the plain reference of the benchmark
(``perfbench/reference/family_RealNVP.py``, loaded by its path), in
float64 on the CPU: draws, log density, the sticking-the-landing loss and
gradient, the start, and a start from which every layer trains.

This file imports no JAX. The test marked ``cuda`` replays the flow's
steps from CUDA graphs and skips without a card; on a machine with one,

    python -m pytest tests/test_torch_realnvp.py --noconftest -q
"""

import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402

F64 = dict(device="cpu", dtype=torch.float64)
D, K, HIDDEN = 12, 4, (16, 16)
#: float64 on one machine: the port and the reference run the same
#: operations in the same order, but not the same fused calls
RTOL = 1e-12


def _reference_module():
    path = Path(__file__).resolve().parents[1] / "perfbench" / "reference" / "family_RealNVP.py"
    spec = importlib.util.spec_from_file_location("family_RealNVP_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def reference():
    return _reference_module()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flow(dim=D, hidden=HIDDEN, init_seed=3, **kw):
    return vt.RealNVP(dim, n_couplings=K, hidden=hidden, init_seed=init_seed, **{**F64, **kw})


def random_weights(q, seed=1, scale=0.2):
    """Seeded weights with no layer zero, so every net acts."""
    gen = torch.Generator().manual_seed(seed)
    return scale * torch.randn(q.var_param_dim, generator=gen, dtype=torch.float64)


def model(dim):
    return vt.zoo.logistic_regression(dim=dim, n_data=30, seed=4, **F64)[0]


def layers(q, vp):
    """``{(coupling, net, layer): (W, b)}`` of a flat parameter."""
    out = {}
    for c, (tp, sp) in enumerate(q.unpack(vp)):
        for name, net, p in (("t", q.t_net, tp), ("s", q.s_net, sp)):
            for j, Wb in enumerate(net.unpack(p)):
                out[(c, name, j)] = Wb
    return out


def test_realnvp_draws_and_density_match_the_reference(reference):
    q = flow()
    ref = reference.Family(D, K, HIDDEN, 3)
    vp = random_weights(q)
    z = torch.randn(40, D, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    x = q.g(vp, z)
    torch.testing.assert_close(x, ref.draws(vp, z), rtol=RTOL, atol=1e-13)
    torch.testing.assert_close(q.log_density(vp, x), ref.log_q(vp, x), rtol=RTOL, atol=1e-12)
    assert torch.allclose(x, z) is False  # the weights act


def test_realnvp_stl_loss_and_gradient_match_the_reference(reference):
    q = flow()
    ref = reference.Family(D, K, HIDDEN, 3)
    log_p = model(D)
    vp = random_weights(q)
    objective = vt.ExclusiveKL(q, log_p, 25, use_path_deriv=True)
    value, grad = objective.value_and_grad(vp, torch.Generator().manual_seed(8))
    # the port draws its base normals from the generator as one (S, d) block
    z = torch.randn(25, D, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    v = vp.clone().requires_grad_(True)
    x = ref.draws(v, z)
    ref_value = -torch.mean(log_p(x) - ref.log_q(v.detach(), x))
    (ref_grad,) = torch.autograd.grad(ref_value, v)
    torch.testing.assert_close(value, ref_value.detach(), rtol=RTOL, atol=1e-12)
    torch.testing.assert_close(grad, ref_grad, rtol=1e-10, atol=1e-12)


def test_realnvp_inverse_undoes_the_draw():
    q = flow()
    vp = random_weights(q, scale=0.5)
    z = torch.randn(30, D, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    back, _ = q.f(vp, q.g(vp, z))
    torch.testing.assert_close(back, z, rtol=1e-12, atol=1e-12)


def test_realnvp_log_det_is_the_jacobians():
    """log q(g(z)) = log N(z) - log |det dg/dz|, the determinant of the
    Jacobian by autograd."""
    q = flow(dim=6, hidden=(8, 8))
    vp = random_weights(q, scale=0.5)
    for z in torch.randn(4, 6, generator=torch.Generator().manual_seed(6), dtype=torch.float64):
        jac = torch.autograd.functional.jacobian(lambda u: q.g(vp, u[None])[0], z)
        _, logabsdet = torch.linalg.slogdet(jac)
        log_base = -0.5 * torch.sum(z * z) - 3.0 * math.log(2.0 * math.pi)
        torch.testing.assert_close(q.log_density(vp, q.g(vp, z[None]))[0],
                                   log_base - logabsdet, rtol=1e-12, atol=1e-12)


def test_realnvp_start_is_the_references_and_the_base(reference):
    q = flow()
    start = q.init_param()
    assert torch.equal(start, reference.Family(D, K, HIDDEN, 3).init(torch.float64, "cpu"))
    assert torch.equal(q.init_param(), start) and q.init_param() is not start
    assert not torch.equal(start, flow(init_seed=4).init_param())
    for (c, name, j), (W, b) in layers(q, start).items():
        assert not torch.any(b), (c, name, j)
        assert torch.any(W) == (j < len(HIDDEN)), (c, name, j)
    z = torch.randn(20, D, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    assert torch.equal(q.g(start, z), z)
    base = vt.MFGaussian(D, **F64)
    torch.testing.assert_close(q.log_density(start, z),
                               base.log_density(torch.zeros(2 * D, dtype=torch.float64), z),
                               rtol=1e-14, atol=1e-13)
    assert q.sample(start, 5, torch.Generator().manual_seed(1)).shape == (5, D)


def test_realnvp_masks_alternate_halves():
    q = flow(dim=5)
    assert q.mask.dtype == torch.float64
    assert q.mask.tolist() == [[1, 1, 0, 0, 0], [0, 0, 1, 1, 1]] * 2


def _moved_after_three_steps(q, start):
    """Per layer, whether its W and its b moved in three RMSProp steps of
    STL ExclusiveKL from ``start``."""
    objective = vt.ExclusiveKL(q, model(q.dim), 10, use_path_deriv=True)
    sgo = vt.RMSProp(0.001)
    gen = torch.Generator().manual_seed(9)
    vp, state = start, sgo.init_state(start)
    for _ in range(3):
        vp, state, _, _, _, _ = sgo.step(objective, vp, state, {}, gen, 0.001)
    before, after = layers(q, start), layers(q, vp)
    return {key: (not torch.equal(before[key][0], after[key][0]),
                  not torch.equal(before[key][1], after[key][1])) for key in before}


def test_realnvp_every_layer_trains_from_its_start():
    q = flow()
    moved = _moved_after_three_steps(q, q.init_param())
    assert all(w and b for w, b in moved.values()), moved


def test_nvpflow_zero_start_moves_only_output_biases():
    """The all-zero start NVPFlow keeps for parity with the JAX package:
    every hidden activation and every output matrix is zero, so only the
    output biases get a gradient."""
    q = flow()
    moved = _moved_after_three_steps(q, torch.zeros(q.var_param_dim, dtype=torch.float64))
    last = len(HIDDEN)
    assert all(m == (False, j == last) for (_, _, j), m in moved.items()), moved


def test_realnvp_states_its_steps_replayable():
    assert "graph_safe" in vt.RealNVP.__dict__
    assert flow().graph_refusal() is None

    class Unstated(vt.RealNVP):
        pass

    assert "not stated safe" in Unstated(D, hidden=HIDDEN, **F64).graph_refusal()


def test_realnvp_fits_through_bbvi():
    """``bbvi``'s adaptive route on the flow: a family with no KL, so one
    FASO call with the sample-count escalation armed."""
    q = flow(dim=6, hidden=(8, 8))
    objective = vt.ExclusiveKL(q, model(6), 10, use_path_deriv=True)
    res = vt.bbvi(6, objective=objective, n_iters=450, learning_rate=0.01,
                  generator=torch.Generator().manual_seed(0),
                  RMS_kwargs=dict(diagnostics=False), RAABBVI_kwargs=dict(max_history=400))
    values = res["value_history"]
    assert values.shape[0] == 450 and torch.isfinite(values).all()
    assert torch.isfinite(res["opt_param"]).all()
    assert res["resume_state"]["flight"]["ring"].shape == (400, q.var_param_dim)
    assert float(values[-50:].mean()) < float(values[:50].mean())


def test_realnvp_fit_stopped_by_raabbvi_resumes_where_it_stopped():
    """RAABBVI's one round over the flow, stopped at 150 of 300 steps and
    resumed from its ``resume_state``, takes the uninterrupted run's steps
    to the bit."""
    q = flow(dim=6, hidden=(8, 8))
    x0 = q.init_param()

    def run(n_iters, resume_state=None):
        opt = vt.RAABBVI(vt.RMSProp(0.01, diagnostics=False), max_history=200,
                         mc_escalation=4.0)
        objective = vt.ExclusiveKL(q, model(6), 10, use_path_deriv=True)
        return opt.optimize(n_iters, objective, x0, generator=torch.Generator().manual_seed(0),
                            resume_state=resume_state)

    whole, first = run(300), run(150)
    assert first["k_stopped"] is None and len(first["k_conv"]) == 1
    rest = run(300, resume_state=first["resume_state"])
    assert torch.equal(torch.cat([first["value_history"], rest["value_history"]]),
                       whole["value_history"])
    for name in ("var_param", "ring"):
        assert torch.equal(rest["resume_state"]["flight"][name],
                           whole["resume_state"]["flight"][name])
    assert torch.equal(rest["opt_param"], whole["opt_param"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_realnvp_replayed_steps_equal_eager_steps(dtype):
    """FASO on the card replays the flow's step from CUDA graphs; an eager
    run (a step rule that states nothing about replay) gives the same
    iterates, losses and ring to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from viabel_torch import optimizers

    class EagerRMSProp(vt.RMSProp):
        pass

    def run(sgo_class):
        q = vt.RealNVP(40, hidden=(64, 64), device="cuda", dtype=dtype)
        log_p = vt.zoo.logistic_regression(dim=40, n_data=64, seed=2, device="cuda",
                                           dtype=dtype)[0]
        objective = vt.ExclusiveKL(q, log_p, 10, use_path_deriv=True)
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
    assert optimizers.graph_refusal(vt.RMSProp(0.001), graphed.objective,
                                    got["opt_param"], {}) is None
    assert torch.equal(got["value_history"], ref["value_history"])
    assert torch.equal(got["opt_param"], ref["opt_param"])
    assert torch.equal(got["resume_state"]["ring"], ref["resume_state"]["ring"])
