"""viabel_torch.ops wrappers: dispatch, input checks and the CUDA kernels.

This file imports no JAX, so it also runs where only PyTorch is
installed. Tests marked ``cuda`` compare each kernel with its plain
version and skip without a card; on a machine with one, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest`` because tests/conftest.py configures JAX).
"""

import inspect

import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402
from viabel_torch import ops  # noqa: E402
from viabel_torch.families import _tri_solve  # noqa: E402
from viabel_torch.ops import _build  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels on the card")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the loader or a launch counter."""
    def no_loader():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_loader)
    ops.reset_launch_counts()
    ring = torch.randn(16, 5, dtype=torch.float64)
    GS, GQ = ops.ring_group_stats(ring, ring[-1], 4)
    PS, PQ = ops.ring_group_stats_plain(ring, ring[-1], 4)
    assert torch.equal(GS, PS) and torch.equal(GQ, PQ)
    theta = 0.1 * torch.randn(6, 6, dtype=torch.float64)
    B = torch.randn(6, 2, dtype=torch.float64)
    assert torch.equal(ops.stl_transpose_solve(theta, B),
                       ops.stl_transpose_solve_plain(theta, B))
    T = torch.tril(torch.randn(6, 6, dtype=torch.float64)) + 6 * torch.eye(6)
    for lower in (True, False):
        TT = T if lower else T.T
        assert torch.equal(ops.vmem_solve_triangular(TT, B, lower),
                           ops.vmem_solve_triangular_plain(TT, B, lower))
        assert torch.equal(_tri_solve(TT, B, lower),
                           ops.vmem_solve_triangular_plain(TT, B, lower))
    assert ops.launch_counts() == {"ring_group_stats": 0, "stl_transpose_solve": 0,
                                   "vmem_solve_triangular": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    ring = torch.randn(10, 5, dtype=torch.float64)
    with pytest.raises(ValueError):
        ops.ring_group_stats(ring, ring[-1], 4)  # 10 % 4 != 0
    with pytest.raises(ValueError):
        ops.ring_group_stats(ring, ring[-1, :3], 5)
    with pytest.raises(ValueError):
        ops.stl_transpose_solve(torch.zeros(4, 3, dtype=torch.float64),
                                torch.zeros(4, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.stl_transpose_solve(torch.zeros(4, 4, dtype=torch.float64),
                                torch.zeros(3, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.vmem_solve_triangular(torch.eye(4, 3, dtype=torch.float64),
                                  torch.zeros(4, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.vmem_solve_triangular(torch.eye(4, dtype=torch.float64),
                                  torch.zeros(3, 1, dtype=torch.float64))


#: every entry point that places tensors, with a call that names no device
ENTRY_POINTS = {
    "bbvi": lambda: vt.bbvi(2, log_density=vt.zoo.funnel()[0], n_iters=5),
    "ApproximationFamily": lambda: vt.ApproximationFamily(2, 4, True, True),
    "MFGaussian": lambda: vt.MFGaussian(2),
    "FullRankGaussian": lambda: vt.FullRankGaussian(2),
    "logistic_regression": lambda: vt.zoo.logistic_regression(dim=3, n_data=5),
    "correlated_gaussian": lambda: vt.zoo.correlated_gaussian(3),
    "diagonal_gaussian": lambda: vt.zoo.diagonal_gaussian([0.0], [1.0]),
    "gaussian_mixture": lambda: vt.zoo.gaussian_mixture(),
    "robust_regression": lambda: vt.zoo.robust_regression(),
    "eight_schools": lambda: vt.zoo.eight_schools(),
    "rmsprop_state_from_jax": lambda: vt.convert.rmsprop_state_from_jax(
        {"avg_grad_sq": [1.0], "t": 1}),
    "ring_from_jax": lambda: vt.convert.ring_from_jax([[[0.0]] * 8], 1),
}
_DEFAULTS_OF = {"bbvi": vt.bbvi, "ApproximationFamily": vt.ApproximationFamily,
                "MFGaussian": vt.MFGaussian, "FullRankGaussian": vt.FullRankGaussian,
                "rmsprop_state_from_jax": vt.convert.rmsprop_state_from_jax,
                "ring_from_jax": vt.convert.ring_from_jax}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Every entry point defaults to device="cuda"; without a card, a call
    that names no device raises instead of running on the CPU."""
    fn = _DEFAULTS_OF.get(name) or getattr(vt.zoo, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        ENTRY_POINTS[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(cuda, name):
    out = ENTRY_POINTS[name]()
    tensors = []
    if name == "bbvi":
        tensors = [out["opt_param"]]
    elif isinstance(out, vt.ApproximationFamily):
        tensors = [out.init_param()]
    elif isinstance(out, dict):
        tensors = [out["avg_grad_sq"]]
    elif torch.is_tensor(out):
        tensors = [out]
    else:  # a zoo target: evaluate it at zeros on the card
        model, dim = out[0], out[1]
        tensors = [model(torch.zeros((2, dim), device=cuda))]
    assert all(t.is_cuda for t in tensors)


def test_missing_nvcc_raises_with_the_paths_tried(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", "/nonexistent-default/nvcc")
    with pytest.raises(RuntimeError, match="nonexistent-cuda"):
        _build._find_nvcc()


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,G,dtype,offset", [
    (64, 1000, 8, "float64", 0), (40, 7, 8, "float32", 0), (40, 7, 8, "float64", 0),
    (600, 4096, 50, "float32", 0),
    (64, 1000, 8, "float32", 1)])  # a ring not on a 16-byte boundary
def test_ring_group_stats_kernel_matches_plain(cuda, R, D, G, dtype, offset):
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(R + D)
    flat = torch.randn(offset + R * D, generator=gen, device=cuda, dtype=dtype) + 10.0
    ring = flat[offset:].view(R, D)
    center = ring[-1]
    before = ops.launch_counts()["ring_group_stats"]
    GS, GQ = ops.ring_group_stats(ring, center, G)
    assert ops.launch_counts()["ring_group_stats"] == before + 1
    PS, PQ = ops.ring_group_stats_plain(ring, center, G)
    scale = float((ring - center).abs().max())
    # float64: rtol 1e-12 with a floor for near-zero sums; float32: sums of
    # `group` terms in another order
    rtol = 1e-12 if dtype == torch.float64 else 0.0
    eps = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(GS, PS, rtol=rtol, atol=eps * G * scale)
    torch.testing.assert_close(GQ, PQ, rtol=rtol, atol=eps * G * scale**2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,S", [(8, 3), (130, 5), (1000, 10), (1000, 400), (1536, 16)])
def test_stl_transpose_solve_kernel_matches_plain(cuda, d, S, dtype):
    gen = torch.Generator(cuda).manual_seed(d + S)
    if dtype == "float64":
        # tests/test_ops.py's recipe and bar for the Pallas kernel
        theta = torch.randn(d, d, generator=gen, device=cuda, dtype=torch.float64)
    else:
        theta = 0.1 * torch.randn(d, d, generator=gen, device=cuda)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=theta.dtype)
    before = ops.launch_counts()["stl_transpose_solve"]
    X = ops.stl_transpose_solve(theta, B)
    assert ops.launch_counts()["stl_transpose_solve"] == before + 1
    P = ops.stl_transpose_solve_plain(theta, B)
    if dtype == "float64":
        torch.testing.assert_close(X, P, rtol=1e-8, atol=1e-12)
    else:
        # float32 substitution in another order: max-norm relative error
        assert float((X - P).abs().max()) <= 1e-4 * float(P.abs().max())


@pytest.mark.cuda
def test_cuda_path_raises_when_the_loader_fails(cuda, monkeypatch):
    def broken_loader():
        raise RuntimeError("loader failed")

    monkeypatch.setattr(_build, "load_library", broken_loader)
    ring = torch.randn(8, 5, device=cuda)
    with pytest.raises(RuntimeError, match="loader failed"):
        ops.ring_group_stats(ring, ring[-1], 4)
    with pytest.raises(RuntimeError, match="loader failed"):
        ops.stl_transpose_solve(torch.zeros(4, 4, device=cuda),
                                torch.zeros(4, 1, device=cuda))
    with pytest.raises(RuntimeError, match="loader failed"):
        ops.vmem_solve_triangular(torch.eye(4, device=cuda),
                                  torch.zeros(4, 1, device=cuda))


TRI_SHAPES = [(8, 3, True), (130, 5, False), (300, 7, True), (1000, 10, False),
              (1000, 1, True), (1000, 4096, False), (1536, 16, True), (257, 33, False)]


def _triangle(d, lower, gen, device, dtype):
    """tests/test_ops.py's recipe: tril(randn) + d I, transposed for upper."""
    A = torch.tril(torch.randn(d, d, generator=gen, device=device, dtype=dtype))
    A = A + d * torch.eye(d, device=device, dtype=dtype)
    return A if lower else A.T.contiguous()


def _assert_solve_close(X, P, dtype):
    if dtype == torch.float64:
        torch.testing.assert_close(X, P, rtol=1e-8, atol=1e-12)
    else:
        # float32 substitution in another order: max-norm relative error
        assert float((X - P).abs().max()) <= 1e-4 * float(P.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,S,lower", TRI_SHAPES)
def test_vmem_solve_triangular_kernel_matches_plain(cuda, d, S, lower, dtype):
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(d + S)
    T = _triangle(d, lower, gen, cuda, dtype)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=dtype)
    P = ops.vmem_solve_triangular_plain(T, B, lower)
    before = ops.launch_counts()["vmem_solve_triangular"]
    X = ops.vmem_solve_triangular(T, B, lower)
    # a column-major right-hand side (the transposed view log_density passes)
    Bt = B.T.contiguous().T
    Xt = ops.vmem_solve_triangular(T, Bt, lower)
    assert ops.launch_counts()["vmem_solve_triangular"] == before + 2
    assert Xt.stride() == Bt.stride()  # X takes B's layout
    _assert_solve_close(X, P, dtype)
    _assert_solve_close(Xt, P, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("needs_T", [True, False])
def test_tri_solve_adjoint_matches_plain_autograd(cuda, lower, needs_T):
    """dB (and dT where asked for) through the kernel's adjoint against
    autograd through torch.linalg.solve_triangular, float64."""
    d, S = 300, 9
    gen = torch.Generator(cuda).manual_seed(7)
    T = _triangle(d, lower, gen, cuda, torch.float64).requires_grad_(needs_T)
    B = torch.randn(d, S, generator=gen, device=cuda,
                    dtype=torch.float64).requires_grad_(True)
    W = torch.randn(d, S, generator=gen, device=cuda, dtype=torch.float64)
    inputs = (T, B) if needs_T else (B,)
    before = ops.launch_counts()["vmem_solve_triangular"]
    got = torch.autograd.grad(torch.sum(W * torch.sin(_tri_solve(T, B, lower))), inputs)
    assert ops.launch_counts()["vmem_solve_triangular"] == before + 2
    want = torch.autograd.grad(torch.sum(W * torch.sin(
        ops.vmem_solve_triangular_plain(T, B, lower))), inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-8, atol=1e-12)
