"""The mean-field Gaussian's STL draw and score (``ops/mfstl.py``,
``csrc/mf_stl.cu``): the plain route on the CPU, the wrapper's checks, the
autograd wiring, and on a card the kernels against their plain versions.

This file imports no JAX. Tests marked ``cuda`` skip without a card; on a
machine with one, run them with

    python -m pytest tests/test_torch_mf_stl.py --noconftest -q
"""

import math

import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402
from viabel_torch import ops  # noqa: E402
from viabel_torch.families import ApproximationFamily, _MFSTL, _MFSTLGrad  # noqa: E402
from viabel_torch.ops import _build  # noqa: E402

F64 = torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels on the card")
    return torch.device("cuda")


def _case(S, d, dtype, device, seed=0):
    """``var_param`` (log sigma spread over [-1, 1]), base normals, a draws'
    gradient and non-uniform row weights, made on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    vp = torch.cat([torch.randn(d, generator=gen, dtype=F64),
                    2.0 * torch.rand(d, generator=gen, dtype=F64) - 1.0])
    z = torch.randn(S, d, generator=gen, dtype=F64)
    g_x = torch.randn(S, d, generator=gen, dtype=F64)
    g_lq = torch.rand(S, generator=gen, dtype=F64) + 0.5
    return [t.to(device=device, dtype=dtype) for t in (vp, z, g_x, g_lq)]


def _composite(vp, z):
    """The draw and the STL score as the composite route computes them."""
    d = z.shape[1]
    x = vp[:d] + torch.exp(vp[d:]) * z
    w = (x - vp[:d].detach()) / torch.exp(vp[d:].detach())
    return x, torch.sum(-0.5 * w**2 - vp[d:].detach() - 0.5 * math.log(2 * math.pi), dim=-1)


def _model(x):
    """A log density with a non-constant Hessian, row by row."""
    return torch.sum(torch.sin(x) - 0.1 * x**2, dim=-1)


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_is_the_composite_and_leaves_the_counter(dtype, monkeypatch):
    """On the CPU, MFGaussian's STL method is the composite sample and
    log_density at detached parameters, bit for bit, and neither loads the
    library nor counts a launch."""
    def no_loader():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_loader)
    ops.reset_launch_counts()
    q = vt.MFGaussian(7, device="cpu", dtype=dtype)
    vp = _case(1, 7, dtype, "cpu")[0].requires_grad_(True)
    x, log_q = q.sample_and_stl_log_density(vp, 5, torch.Generator().manual_seed(3))
    want_x, want_lq = ApproximationFamily.sample_and_stl_log_density(
        q, vp, 5, torch.Generator().manual_seed(3))
    assert torch.equal(x, want_x) and torch.equal(log_q, want_lq)
    (g,) = torch.autograd.grad(torch.sum(_model(x) - log_q), vp)
    (want_g,) = torch.autograd.grad(torch.sum(_model(want_x) - want_lq), vp)
    assert torch.equal(g, want_g)
    assert ops.launch_counts()["mf_stl"] == 0


_VP, _Z = torch.zeros(6, dtype=F64), torch.zeros(4, 3, dtype=F64)


@pytest.mark.parametrize("args,error,match", [
    ((_VP, _Z[0]), ValueError, "must be"),
    ((torch.zeros(5, dtype=F64), _Z), ValueError, "must be"),
    ((_VP, _Z, torch.zeros(4, 2, dtype=F64), None), ValueError, "g_x must be"),
    ((_VP, _Z, None, torch.zeros(3, dtype=F64)), ValueError, "g_lq must be"),
    ((_VP.int(), _Z.int()), TypeError, "float32 or float64"),
    ((_VP.half(), _Z.half()), TypeError, "float32 or float64"),
    ((_VP, _Z.float()), TypeError, "one dtype"),
    ((_VP, _Z, _Z.float(), None), TypeError, "one dtype"),
    # a wrong shape or type on a device the kernels never see is refused
    # for its shape or type, before the device is looked at
    ((_VP.to("meta"), _Z[0].to("meta")), ValueError, "must be"),
    ((_VP.to("meta"), _Z.float().to("meta")), TypeError, "one dtype"),
    ((_VP.to("meta"), _Z.to("meta")), ValueError, "CPU or on one CUDA device"),
])
def test_wrappers_reject_mismatched_shapes_and_types_before_the_device(args, error, match):
    if len(args) == 2:
        with pytest.raises(error, match=match):
            ops.mf_stl_forward(*args)
        args = (*args, None, torch.ones(args[1].shape[:1], dtype=args[1].dtype,
                                        device=args[1].device))
    with pytest.raises(error, match=match):
        ops.mf_stl_backward(*args)


@pytest.mark.parametrize("S,d", [(1, 1), (10, 5), (7, 33)])
@pytest.mark.parametrize("grads", ["both", "no_g_x", "no_g_lq"])
def test_plain_versions_are_the_composite_and_its_gradient(S, d, grads):
    """The plain forward gives the composite's draws bit for bit and its
    score to rounding; the plain backward gives the composite's gradient
    under any draws' gradient and any row weights, either of them absent."""
    vp, z, g_x, g_lq = _case(S, d, F64, "cpu", seed=S + d)
    g_x = None if grads == "no_g_x" else g_x
    g_lq = None if grads == "no_g_lq" else g_lq
    x, log_q = ops.mf_stl_forward_plain(vp, z)
    vp = vp.clone().requires_grad_(True)
    want_x, want_lq = _composite(vp, z)
    assert torch.equal(x, want_x.detach())
    torch.testing.assert_close(log_q, want_lq.detach(), rtol=1e-14, atol=1e-14 * d)
    outs = [t for t, g in ((want_x, g_x), (want_lq, g_lq)) if g is not None]
    (want,) = torch.autograd.grad(outs, vp, [g for g in (g_x, g_lq) if g is not None])
    torch.testing.assert_close(ops.mf_stl_backward_plain(vp.detach(), z, g_x, g_lq), want,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("weights", ["mean", "dreg"])
def test_autograd_function_gives_the_composites_gradient_and_hessian(weights):
    """Through ``_MFSTL`` (plain versions on the CPU): the loss, its
    gradient and a Hessian-vector product (``create_graph``) are the
    composite route's, under the mean's row weights and DReG's squared
    normalised weights."""
    S, d = 6, 9
    vp0, z, _, _ = _case(S, d, F64, "cpu", seed=4)
    v = torch.randn(2 * d, generator=torch.Generator().manual_seed(5), dtype=F64)

    def loss(x, log_q):
        lw = _model(x) - log_q
        if weights == "mean":
            return -torch.mean(lw)
        w_hat = torch.softmax(lw.detach(), dim=0)
        return -torch.sum(w_hat * w_hat * lw)

    results = []
    for route in (lambda p: _MFSTL.apply(p, z), lambda p: _composite(p, z)):
        vp = vp0.clone().requires_grad_(True)
        value = loss(*route(vp))
        (g,) = torch.autograd.grad(value, vp, create_graph=True)
        (hvp,) = torch.autograd.grad(g, vp, v)
        results.append((value.detach(), g.detach(), hvp))
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grads", ["both", "no_g_x", "no_g_lq"])
def test_gradient_function_differentiates_as_the_plain_version(grads):
    """``_MFSTLGrad`` (the kernel's gradient under ``create_graph``; the
    plain version on the CPU) has the plain version's value and, by its
    analytic backward, its vector-Jacobian product in ``var_param``, ``g_x``
    and ``g_lq``, either of the last two absent."""
    S, d = 5, 8
    vp0, z, gx0, glq0 = _case(S, d, F64, "cpu", seed=11)
    gx0 = None if grads == "no_g_x" else gx0
    glq0 = None if grads == "no_g_lq" else glq0
    cot = torch.randn(2 * d, generator=torch.Generator().manual_seed(12), dtype=F64)
    results = []
    for fn in (_MFSTLGrad.apply, ops.mf_stl_backward_plain):
        vp = vp0.clone().requires_grad_(True)
        gx = None if gx0 is None else gx0.clone().requires_grad_(True)
        glq = None if glq0 is None else glq0.clone().requires_grad_(True)
        grad = fn(vp, z, gx, glq)
        inputs = [t for t in (vp, gx, glq) if t is not None]
        results.append((grad.detach(), *torch.autograd.grad(grad, inputs, cot)))
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- the card


#: float32: each sum kept in float64 on the card, the plain version's sums
#: in float32; both are held against the float64 truth, the kernel within a
#: float32 rounding of each sum's scale
F32_REL = 2.0 ** -22


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,d", [(S, d) for S in (1, 10, 400) for d in (1, 5, 4099)]
                         + [(10, 478410)])
def test_mf_stl_kernels_match_plain(cuda, S, d, dtype):
    vp, z, g_x, g_lq = _case(S, d, dtype, cuda, seed=S * 7 + d)
    before = ops.launch_counts()["mf_stl"]
    x, log_q = ops.mf_stl_forward(vp, z)
    px, _ = ops.mf_stl_forward_plain(vp, z)
    assert ops.launch_counts()["mf_stl"] == before + 2
    # the draws are rounded as the plain version rounds them
    assert torch.equal(x, px)
    vp64, z64, gx64, glq64 = (t.double() for t in (vp, z, g_x, g_lq))
    _, truth = ops.mf_stl_forward_plain(vp64, z64)
    scale = 0.5 * (z64 * z64).sum(1) + vp64[d:].abs().sum() + d
    rel = 1e-13 if dtype == F64 else F32_REL
    assert bool(((log_q.double() - truth).abs() <= rel * scale).all())
    for gx, glq in ((g_x, g_lq), (None, g_lq), (g_x, None)):
        grad = ops.mf_stl_backward(vp, z, gx, glq)
        # the float64 truth by z / sigma (the plain version's (x - mu) /
        # sigma^2 cancels where sigma z is small beside mu), each column's
        # sum against the sum of its terms' sizes
        sigma = torch.exp(vp64[d:])
        G = torch.zeros_like(z64) if gx is None else gx64.clone()
        size = G.abs()
        if glq is not None:
            G -= glq64[:, None] * z64 / sigma
            size += (glq64[:, None] * z64 / sigma).abs()
        truth = torch.cat([G.sum(0), sigma * (G * z64).sum(0)])
        scale = torch.cat([size.sum(0), sigma * (size * z64.abs()).sum(0)])
        err = (grad.double() - truth).abs()
        assert bool((err <= rel * scale + 1e-300).all()), float((err / scale).max())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,d", [(10, 4099), (40, 478410)])
def test_mf_stl_step_replayed_from_a_graph_equals_eager(cuda, S, d, dtype):
    """A step's draw, score and gradient captured as one CUDA graph and
    replayed give the eager step's bits: the kernels' sums run in a fixed
    order."""
    vp, z, _, _ = _case(S, d, dtype, cuda)
    static_vp = vp.clone()

    def step():
        p = static_vp.detach().requires_grad_(True)
        with torch.enable_grad():
            x, log_q = _MFSTL.apply(p, z)
            (g,) = torch.autograd.grad(-torch.mean(_model(x) - log_q), p)
        return x.detach(), log_q.detach(), g

    want = step()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        step()  # warm-up on the side stream, as capture asks
    torch.cuda.current_stream(cuda).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for got, ref in zip(out, want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["exclusive_kl", "iwelbo"])
def test_mfgaussian_stl_on_the_card_matches_cpu(cuda, objective):
    """ExclusiveKL's STL step and IWELBO's DReG step of MFGaussian(300) in
    float64, card against CPU on the same injected draws: value and
    gradient to 1e-9; the card's draw launches the forward pair and the
    backward, whose S = 10 rows split in two at this d (then a second
    kernel adds the splits)."""
    d, S = 300, 10
    table = torch.randn(S, d, generator=torch.Generator().manual_seed(8), dtype=F64)

    class Table:
        def normal(self, generator, n_samples, width, dtype, device):
            return table[:n_samples, :width].to(device=device, dtype=dtype)

    vp = _case(1, d, F64, "cpu", seed=9)[0]
    out = []
    for dev in (cuda, "cpu"):
        q = vt.MFGaussian(d, base_sampler=Table(), device=dev, dtype=F64)
        model, _ = vt.zoo.logistic_regression(dim=d, n_data=64, device=dev, dtype=F64)
        obj = (vt.ExclusiveKL(q, model, S, use_path_deriv=True) if objective == "exclusive_kl"
               else vt.IWELBO(q, model, S, use_dreg=True))
        before = ops.launch_counts()["mf_stl"]
        value, grad = obj.value_and_grad(vp.to(dev), None)
        out.append((value.detach().cpu(), grad.cpu(), ops.launch_counts()["mf_stl"] - before))
    (val_c, grad_c, moved), (val, grad, stayed) = out
    assert moved == 4 and stayed == 0
    torch.testing.assert_close(val_c, val, rtol=1e-9, atol=0)
    err = float((grad_c - grad).abs().max()) / float(grad.abs().max())
    assert err <= 1e-9, err


def _hvp(obj, vp, v):
    """ExclusiveKL's own ``hessian_vector_product``; for IWELBO, the same
    reverse over reverse of its loss."""
    if isinstance(obj, vt.ExclusiveKL):
        return obj.hessian_vector_product(vp, v, None)
    p = vp.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(obj._loss(p, None), p, create_graph=True)
    (hvp,) = torch.autograd.grad(g, p, v)
    return hvp


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["exclusive_kl", "iwelbo"])
def test_mfgaussian_hessian_vector_product_on_the_card_matches_cpu(cuda, objective):
    """A Hessian-vector product (reverse over reverse, ``create_graph``) of
    ExclusiveKL's STL loss and IWELBO's DReG loss of MFGaussian(300) in
    float64, card against CPU on the same injected draws, to 1e-9: the
    card's first-order gradient comes from the kernels, and its analytic
    second order gives the composite's product. Six launches: the forward
    pair, then the split backward (two) for the gradient and again for
    the product's cotangent on the draws and scores."""
    d, S = 300, 10
    table = torch.randn(S, d, generator=torch.Generator().manual_seed(13), dtype=F64)

    class Table:
        def normal(self, generator, n_samples, width, dtype, device):
            return table[:n_samples, :width].to(device=device, dtype=dtype)

    vp = _case(1, d, F64, "cpu", seed=14)[0]
    v = torch.randn(2 * d, generator=torch.Generator().manual_seed(15), dtype=F64)
    out = []
    for dev in (cuda, "cpu"):
        q = vt.MFGaussian(d, base_sampler=Table(), device=dev, dtype=F64)
        model, _ = vt.zoo.logistic_regression(dim=d, n_data=64, device=dev, dtype=F64)
        obj = (vt.ExclusiveKL(q, model, S, use_path_deriv=True) if objective == "exclusive_kl"
               else vt.IWELBO(q, model, S, use_dreg=True))
        before = ops.launch_counts()["mf_stl"]
        hvp = _hvp(obj, vp.to(dev), v.to(dev))
        out.append((hvp.cpu(), ops.launch_counts()["mf_stl"] - before))
    (hvp_c, moved), (hvp, stayed) = out
    assert moved == 6 and stayed == 0
    err = float((hvp_c - hvp).abs().max()) / float(hvp.abs().max())
    assert err <= 1e-9, err
