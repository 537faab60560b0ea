"""viabel_torch.ops wrappers: dispatch, input checks and the CUDA kernels.

This file imports no JAX, so it also runs where only PyTorch is
installed. Tests marked ``cuda`` compare each kernel with its plain
version and skip without a card; on a machine with one, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest`` because tests/conftest.py configures JAX).
"""

import inspect
import math

import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402
from viabel_torch import ops  # noqa: E402
from viabel_torch.families import _tri_solve  # noqa: E402
from viabel_torch.ops import _build  # noqa: E402
from viabel_torch.ops.wlr import KERNEL_MAX_ROWS  # noqa: E402


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
    init, data = _wlr_case(4, 3, 2, torch.device("cpu"))
    settings = dict(num_warmup=6, num_samples=4, num_leapfrog=3)
    assert torch.equal(ops.wlr_hmc(init, torch.Generator().manual_seed(0), data, **settings),
                       ops.wlr_hmc_plain(init, torch.Generator().manual_seed(0), data,
                                         **settings))
    assert ops.launch_counts() == {"mf_stl": 0, "ring_group_stats": 0,
                                   "stl_transpose_solve": 0, "vmem_solve_triangular": 0,
                                   "wlr_hmc": 0}


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
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    init, data = _wlr_case(4, 3, 2, torch.device("cpu"))
    for d in (1, 4):  # the kernel has the d = 3 and d = 2 targets only
        with pytest.raises(ValueError, match="d = 3"):
            ops.wlr_hmc(torch.zeros(2, d, dtype=torch.float64), gen, data)
    y, x, w, rho = data
    with pytest.raises(ValueError, match="one length"):
        ops.wlr_hmc(init, gen, (y, x[:2], w, rho))
    with pytest.raises(ValueError, match="num_leapfrog"):
        ops.wlr_hmc(init, gen, data, num_leapfrog=0)
    assert torch.equal(gen.get_state(), state)  # a refused call draws nothing


def _wlr_case(N, d, C, device, seed=0):
    """A weighted-regression posterior of N rounds (log SKL on log lr) and
    C chain starts scattered around RAABBVI's, float64 on ``device``."""
    g = torch.Generator().manual_seed(100 * N + 10 * d + seed)
    x = math.log(0.1) + math.log(0.5) * torch.arange(N, dtype=torch.float64)
    y = 1.5 + 1.2 * x + 0.1 * torch.randn(N, generator=g, dtype=torch.float64)
    w = 1.0 / (1.0 + torch.arange(N - 1, -1, -1, dtype=torch.float64) ** 2 / 9.0) ** 0.25
    start = [math.log(4.0), float(y.mean()), 0.0] if d == 3 else [float(y.mean()), 0.0]
    init = (torch.tensor(start, dtype=torch.float64)
            + 0.3 * torch.randn((C, d), generator=g, dtype=torch.float64))
    return init.to(device), (y.to(device), x.to(device), w.to(device), 0.5)


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
    "opt_state_from_jax": lambda: vt.convert.opt_state_from_jax(
        {"avg_grad_sq": [1.0], "momentum": [0.5], "t": 1}),
    "ring_from_jax": lambda: vt.convert.ring_from_jax([[[0.0]] * 8], 1),
    "MFStudentT": lambda: vt.MFStudentT(2, 5.0),
    "MultivariateT": lambda: vt.MultivariateT(2, 5.0),
    "LRGaussian": lambda: vt.LRGaussian(2, 1),
}
_DEFAULTS_OF = {"bbvi": vt.bbvi, "ApproximationFamily": vt.ApproximationFamily,
                "MFGaussian": vt.MFGaussian, "FullRankGaussian": vt.FullRankGaussian,
                "MFStudentT": vt.MFStudentT, "MultivariateT": vt.MultivariateT,
                "LRGaussian": vt.LRGaussian,
                "rmsprop_state_from_jax": vt.convert.rmsprop_state_from_jax,
                "opt_state_from_jax": vt.convert.opt_state_from_jax,
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


def _assert_solve_close(X, P, dtype):
    if dtype == torch.float64:
        torch.testing.assert_close(X, P, rtol=1e-8, atol=1e-12)
    else:
        # float32 substitution in another order: max-norm relative error
        assert float((X - P).abs().max()) <= 1e-4 * float(P.abs().max())


#: every edge of the kernel's 32-row panels (d) and column tiles (S): on an
#: H100 (132 SMs) the launcher widens a tile from 1 to 2, 4 and 8 columns
#: past S = 33, 66 and 132, and halves the blocks a cluster (8, 4, 2) as the
#: tiles grow, the last switch past S = 264; one column past each switch
#: leaves a ragged last tile
STL_SHAPES = [(1, 1), (8, 3), (31, 16), (32, 17), (33, 1), (64, 40), (130, 5),
              (999, 10), (1000, 10), (1000, 33), (1000, 34), (1000, 40), (1000, 66),
              (1000, 67), (1000, 132), (1000, 133), (1000, 160), (1000, 264),
              (1000, 265), (1000, 400), (1000, 529), (1536, 16)]


def _stl_theta(d, dtype, gen, device):
    if dtype == torch.float64:
        # tests/test_ops.py's recipe and bar for the Pallas kernel
        return torch.randn(d, d, generator=gen, device=device, dtype=dtype)
    return 0.1 * torch.randn(d, d, generator=gen, device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,S", STL_SHAPES)
def test_stl_transpose_solve_kernel_matches_plain(cuda, d, S, dtype):
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(d + S)
    theta = _stl_theta(d, dtype, gen, cuda)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=dtype)
    before = ops.launch_counts()["stl_transpose_solve"]
    X = ops.stl_transpose_solve(theta, B)
    # a column-major right-hand side: the transposed draws the STL caller passes
    Bt = B.T.contiguous().T
    Xt = ops.stl_transpose_solve(theta, Bt)
    assert ops.launch_counts()["stl_transpose_solve"] == before + 2
    assert Xt.stride() == Bt.stride()  # X takes B's layout
    P = ops.stl_transpose_solve_plain(theta, B)
    _assert_solve_close(X, P, dtype)
    _assert_solve_close(Xt, P, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,S", [(64, 40), (999, 10), (1536, 16)])
def test_stl_transpose_solve_kernel_large_diagonal_spread(cuda, d, S, dtype):
    """theta's diagonal in [-3, 3]: the factor's diagonal spans exp(6) ~ 400."""
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(3 * d + S)
    theta = 0.01 * torch.randn(d, d, generator=gen, device=cuda, dtype=dtype)
    theta.diagonal().uniform_(-3.0, 3.0, generator=gen)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=dtype)
    _assert_solve_close(ops.stl_transpose_solve(theta, B),
                        ops.stl_transpose_solve_plain(theta, B), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [33, 64, 65, 224, 225, 512, 513, 1024, 1025, 1536])
@pytest.mark.parametrize("S", [37, 529])
def test_stl_transpose_solve_every_tile_width_matches_plain(cuda, d, S, dtype):
    """Each cluster the launcher picks from d: a block a panel or more (2 to 8
    blocks, doubling while each keeps two panels), and past 512 rows at least
    two, a block holding at most 16 panels (S = 529: more tiles than SMs);
    at 2 columns a tile (S = 37) and at 8 with a ragged last tile (S = 529).
    d = 512 at S = 529 puts 16 panels in one block, the most shared memory
    a block takes (78 KB in float64): their inverses stay in it."""
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(d + S)
    theta = _stl_theta(d, dtype, gen, cuda)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=dtype)
    _assert_solve_close(ops.stl_transpose_solve(theta, B),
                        ops.stl_transpose_solve_plain(theta, B), dtype)


@pytest.mark.cuda
def test_stl_transpose_solve_raises_on_what_the_kernel_does_not_take(cuda):
    theta = torch.zeros(4, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        # the launcher refuses an empty B; nothing falls back
        ops.stl_transpose_solve(theta, torch.zeros(4, 0, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.stl_transpose_solve(torch.zeros(4, 8, device=cuda)[:, :4],
                                torch.zeros(4, 1, device=cuda))


@pytest.mark.parametrize("d", [33, 1537])
def test_stl_whiten_takes_transposed_draws_without_a_copy(d, monkeypatch):
    """_stl_whiten_T hands the kernel the (d, S) transposed view of the
    (S, d) draws as it is, and gives the same score direction on a
    transposed, non-contiguous z as on a contiguous copy; d = 1537 is past
    the kernel's range and takes the library solve."""
    from viabel_torch import families
    gen = torch.Generator().manual_seed(d)
    theta = 0.1 * torch.randn(d, d, generator=gen, dtype=torch.float64)
    L = ops.trsm.cholesky_factor(theta)
    z = torch.randn(5, d, generator=gen, dtype=torch.float64)
    seen = []

    def spy(theta_, B):
        seen.append(B)
        return ops.stl_transpose_solve(theta_, B)

    monkeypatch.setattr(families, "stl_transpose_solve", spy)
    v = families._stl_whiten_T(theta, L, z)
    if d <= ops.KERNEL_MAX_DIM:
        assert seen[0].data_ptr() == z.data_ptr() and not seen[0].is_contiguous()
    z_t = z.T.contiguous().T  # the same draws, non-contiguous
    assert not z_t.is_contiguous()
    torch.testing.assert_close(families._stl_whiten_T(theta, L, z_t), v,
                               rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(v, torch.linalg.solve_triangular(L.T, z.T, upper=True).T,
                               rtol=1e-12, atol=1e-14)


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
    init, data = _wlr_case(4, 3, 2, cuda)
    with pytest.raises(RuntimeError, match="loader failed"):
        ops.wlr_hmc(init, torch.Generator(cuda).manual_seed(0), data)


TRI_SHAPES = [(8, 3, True), (130, 5, False), (300, 7, True), (1000, 10, False),
              (1000, 1, True), (1000, 4096, False), (1536, 16, True), (257, 33, False)]
# every edge of the kernel's 32-row panels (d) and column tiles (S), both ways
TRI_SHAPES += [(d, S, lower) for d, S in [(1, 1), (31, 16), (32, 17), (33, 1), (64, 40),
                                          (999, 10), (1000, 1000), (1025, 9)]
               for lower in (True, False)]


def _triangle(d, lower, gen, device, dtype):
    """tests/test_ops.py's recipe: tril(randn) + d I, transposed for upper."""
    A = torch.tril(torch.randn(d, d, generator=gen, device=device, dtype=dtype))
    A = A + d * torch.eye(d, device=device, dtype=dtype)
    return A if lower else A.T.contiguous()


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
@pytest.mark.parametrize("S", [37, 600])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d", [512, 513, 1024, 1025, 1536])
def test_vmem_solve_triangular_every_tile_width_matches_plain(cuda, d, dtype, lower, S):
    """Each (columns, rows a thread) the launcher picks from d, S and the
    type: at 37 columns the narrow tiles (2 columns at one and two rows a
    thread, and at three 8 in float32 and 2 in float64); at 600 the wide
    16-column tile in float32 up to 1024 rows. Both leave a ragged last
    tile in each."""
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(d + S)
    T = _triangle(d, lower, gen, cuda, dtype)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=dtype)
    _assert_solve_close(ops.vmem_solve_triangular(T, B, lower),
                        ops.vmem_solve_triangular_plain(T, B, lower), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("d,S", [(64, 40), (999, 4096)])
def test_vmem_solve_triangular_kernel_large_diagonal_spread(cuda, d, S, dtype, lower):
    """T_ii = exp(U[-3, 3]): the diagonal spans exp(6) ~ 400, read as it
    stands; the rest of the triangle is 0.01 randn."""
    dtype = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(5 * d + S)
    T = 0.01 * torch.randn(d, d, generator=gen, device=cuda, dtype=dtype)
    T.diagonal().uniform_(-3.0, 3.0, generator=gen).exp_()
    T = torch.tril(T) if lower else torch.triu(T)
    B = torch.randn(d, S, generator=gen, device=cuda, dtype=dtype)
    _assert_solve_close(ops.vmem_solve_triangular(T, B, lower),
                        ops.vmem_solve_triangular_plain(T, B, lower), dtype)


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


class TableNormal:
    """Base sampler handing out one fixed table of standard normals (made
    on the CPU) on whichever device the family asks for."""

    def __init__(self, table):
        self.table = table

    def normal(self, generator, n_samples, width, dtype, device):
        return self.table[:n_samples, :width].to(device=device, dtype=dtype)


#: f64, card against CPU: the same formulas, solves by substitution on
#: the card and by LAPACK on the CPU
PATH_RTOL = 1e-9


def _card_and_cpu(kind, d, device, seed=0):
    """The family, the logistic-regression model and a parameter near the
    family's start, on the card and on the CPU, in float64, with one table
    of injected draws."""
    gen = torch.Generator().manual_seed(seed)
    df = 10
    table = TableNormal(torch.randn(64, d + df, generator=gen, dtype=torch.float64))
    out = []
    for dev in (device, "cpu"):
        kw = dict(base_sampler=table, device=dev, dtype=torch.float64)
        approx = (vt.MultivariateT(d, df, **kw) if kind == "mvt"
                  else vt.FullRankGaussian(d, **kw))
        model, _ = vt.zoo.logistic_regression(dim=d, n_data=64, device=dev,
                                              dtype=torch.float64)
        out.append((approx, model))
    vp = out[1][0].init_param() + 0.05 * torch.randn(
        out[1][0].var_param_dim, generator=gen, dtype=torch.float64) / d ** 0.5
    return out, vp


def _assert_rel_close(got, want, rtol=PATH_RTOL):
    """Max-norm relative error of a card result against the CPU's."""
    got = got.detach().cpu()
    err = float((got - want.detach()).abs().max()) / float(want.detach().abs().max())
    assert err <= rtol, err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [130, 1000])
def test_multivariate_t_stl_hook_on_the_card_matches_cpu(cuda, d):
    """MultivariateT's fused STL log q (value, and gradient through the
    samples): one STL-solve launch, no triangular-solve launch."""
    ((card, model_c), (cpu, _)), vp = _card_and_cpu("mvt", d, cuda)
    w = torch.linspace(-1.0, 1.0, 7, dtype=torch.float64)
    results = []
    for approx, p in ((card, vp.to(cuda)), (cpu, vp)):
        p = p.clone().requires_grad_(True)
        before = ops.launch_counts()
        samples, log_q = approx.sample_and_stl_log_density(p, 7, None)
        f = torch.sum(w.to(p.device) * log_q) + 0.1 * torch.sum(samples**2)
        (g,) = torch.autograd.grad(f, p)
        after = ops.launch_counts()
        results.append((f, g, {k: after[k] - before[k] for k in after}))
    assert results[0][2] == {"mf_stl": 0, "ring_group_stats": 0, "stl_transpose_solve": 1,
                             "vmem_solve_triangular": 0, "wlr_hmc": 0}
    _assert_rel_close(results[0][0], results[1][0])
    _assert_rel_close(results[0][1], results[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "mvt"])
def test_alpha_divergence_on_the_card_matches_cpu(cuda, kind):
    """The CUBO value and gradient: log q forward (a lower solve) and its
    adjoint (an upper solve), two triangular-solve launches a step."""
    ((card, model_c), (cpu, model)), vp = _card_and_cpu(kind, 300, cuda, seed=1)
    before = ops.launch_counts()["vmem_solve_triangular"]
    val_c, grad_c = vt.AlphaDivergence(card, model_c, 10, alpha=2.0).value_and_grad(
        vp.to(cuda), None)
    assert ops.launch_counts()["vmem_solve_triangular"] == before + 2
    val, grad = vt.AlphaDivergence(cpu, model, 10, alpha=2.0).value_and_grad(vp, None)
    _assert_rel_close(val_c, val)
    _assert_rel_close(grad_c, grad)


@pytest.mark.cuda
@pytest.mark.parametrize("use_dreg", [True, False])
@pytest.mark.parametrize("kind", ["full", "mvt"])
def test_iwelbo_on_the_card_matches_cpu(cuda, kind, use_dreg):
    """DReG: one STL-solve launch a step; plain IWAE: two triangular-solve
    launches (forward and adjoint)."""
    ((card, model_c), (cpu, model)), vp = _card_and_cpu(kind, 300, cuda, seed=2)
    before = ops.launch_counts()
    val_c, grad_c = vt.IWELBO(card, model_c, 10, use_dreg=use_dreg).value_and_grad(
        vp.to(cuda), None)
    after = ops.launch_counts()
    moved = {k: after[k] - before[k] for k in after}
    assert moved == ({"mf_stl": 0, "ring_group_stats": 0, "stl_transpose_solve": 1,
                      "vmem_solve_triangular": 0, "wlr_hmc": 0} if use_dreg else
                     {"mf_stl": 0, "ring_group_stats": 0, "stl_transpose_solve": 0,
                      "vmem_solve_triangular": 2, "wlr_hmc": 0})
    val, grad = vt.IWELBO(cpu, model, 10, use_dreg=use_dreg).value_and_grad(vp, None)
    _assert_rel_close(val_c, val)
    _assert_rel_close(grad_c, grad)


@pytest.mark.cuda
def test_student_t_densities_on_the_card_match_cpu(cuda):
    """MultivariateT.log_density and multivariate_t_logpdf: one
    triangular-solve launch each."""
    ((card, _), (cpu, _)), vp = _card_and_cpu("mvt", 300, cuda, seed=3)
    x = torch.randn(50, 300, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    mu, cov = cpu.mean_and_cov(vp)
    for on_card, on_cpu in (
            (lambda: card.log_density(vp.to(cuda), x.to(cuda)),
             lambda: cpu.log_density(vp, x)),
            (lambda: vt.multivariate_t_logpdf(x.to(cuda), mu.to(cuda), cov.to(cuda),
                                              df=10.0),
             lambda: vt.multivariate_t_logpdf(x, mu, cov, df=10.0))):
        before = ops.launch_counts()["vmem_solve_triangular"]
        got = on_card()
        assert ops.launch_counts()["vmem_solve_triangular"] == before + 1
        _assert_rel_close(got, on_cpu())


class FixedChoice:
    """A resampling hook returning the same indices on every device."""

    def __init__(self, idx):
        self.idx = idx

    def choice(self, generator, p, n):
        return self.idx[:n].to(p.device)


@pytest.mark.cuda
@pytest.mark.parametrize("use_resampling,launches", [(False, 2), (True, 3)])
def test_dis_step_on_the_card_matches_cpu(cuda, use_resampling, launches):
    """One DISInclusiveKL step over FullRankGaussian(300), f64, card
    against CPU on the same draws and resampling indices: value, gradient
    and state to 1e-9. Kernel 3 launches twice without resampling (log q
    forward and its adjoint) and three times with it (the refresh's log q,
    then the resampled loss forward and adjoint)."""
    ((card, model_c), (cpu, model)), vp = _card_and_cpu("full", 300, cuda, seed=5)
    idx = torch.randint(0, 40, (20,), generator=torch.Generator().manual_seed(6))
    outs = []
    for approx, m, p in ((card, model_c, vp.to(cuda)), (cpu, model, vp)):
        obj = vt.DISInclusiveKL(approx, m, 40, ess_target=20,
                                temper_prior=vt.MFGaussian(300, device=p.device,
                                                           dtype=torch.float64),
                                temper_prior_params=torch.zeros(600, dtype=torch.float64),
                                use_resampling=use_resampling, resampler=FixedChoice(idx))
        before = ops.launch_counts()["vmem_solve_triangular"]
        value, grad, state = obj.value_and_grad_with_state(p, None, obj.init_obj_state(p))
        outs.append((value, grad, state, ops.launch_counts()["vmem_solve_triangular"]
                     - before))
    (val_c, grad_c, state_c, moved), (val, grad, state, _) = outs
    assert moved == launches
    _assert_rel_close(val_c, val)
    _assert_rel_close(grad_c, grad)
    assert state_c["step"].device.type == "cpu" and int(state_c["step"]) == 1
    for name in ("eps", "w_norm", "w_sum") if use_resampling else ("eps",):
        _assert_rel_close(state_c[name], state[name])
    assert bool(state_c["ok"]) and state_c["ok"].device == grad_c.device


@pytest.mark.cuda
def test_load_pytree_places_leaves_on_the_template_device(cuda, tmp_path):
    """Leaves come back on each template leaf's device and in its dtype;
    without a template, on the device asked for."""
    from viabel_torch.checkpoint import load_pytree, save_pytree
    tree = {"ring": torch.randn(4, 5, device=cuda), "t": 3,
            "gen": torch.Generator(cuda).manual_seed(1).get_state(),
            "host": torch.arange(3, dtype=torch.float64)}
    path = str(tmp_path / "state.npz")
    save_pytree(path, tree)
    like = {"ring": torch.zeros(4, 5, device=cuda, dtype=torch.float64), "t": 0,
            "gen": tree["gen"], "host": torch.zeros(3)}
    restored = load_pytree(path, like=like)
    assert restored["ring"].device.type == "cuda"
    assert restored["ring"].dtype == torch.float64
    torch.testing.assert_close(restored["ring"], tree["ring"].double())
    assert restored["host"].device.type == "cpu" and restored["host"].dtype == torch.float32
    assert restored["gen"].device.type == "cpu" and torch.equal(restored["gen"], tree["gen"])
    assert restored["t"] == 3
    flat = load_pytree(path, device=cuda)
    assert all(x.device.type == "cuda" for x in flat)


#: kernel against plain version, draw for draw, over runs short enough that
#: the sampler has not amplified the reassociated sums' last bits (at 24
#: leapfrog steps it takes a 1e-15 change past 1e-9 within tens of
#: iterations: tests/test_torch_wlr_hmc.py::test_hmc_sampler_amplifies_round_off):
#: two whole RAABBVI trajectories from C scattered starts, and every branch
#: of the schedule (dual averaging, Welford over 12 iterations, the metric
#: installed, dual averaging restarted, sampling at the averaged step) at
#: one leapfrog step
WLR_SETTINGS = {"trajectory": dict(num_warmup=0, num_samples=2, num_leapfrog=24),
                "schedule": dict(num_warmup=24, num_samples=4, num_leapfrog=1)}


def _kappa_and_c(draws):
    """The regression's (kappa, c) from ``(C, S, d)`` draws, as
    ``RAABBVI.weighted_linear_regression`` forms them."""
    flat = draws.reshape(-1, draws.shape[-1])
    if draws.shape[-1] == 2:
        return 1.0, math.exp(float(flat[:, 0].mean()))
    return float(torch.sigmoid(flat[:, 0]).mean()), math.exp(float(flat[:, 1].mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(WLR_SETTINGS))
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("d", [3, 2])
@pytest.mark.parametrize("N", [1, 4, 33])
def test_wlr_hmc_kernel_matches_plain(cuda, N, d, C, setting):
    """One launch; the same random numbers as the plain version (the
    generator ends in the same state); the draws within 1e-9 absolute and
    kappa and c within 1e-10 relative (float64, sums reassociated)."""
    init, data = _wlr_case(N, d, C, cuda)
    settings = WLR_SETTINGS[setting]
    gen = torch.Generator(cuda).manual_seed(N + d + C)
    state = gen.get_state()
    before = ops.launch_counts()["wlr_hmc"]
    K = ops.wlr_hmc(init, gen, data, **settings)
    assert ops.launch_counts()["wlr_hmc"] == before + 1
    after = gen.get_state()
    gen.set_state(state)
    P = ops.wlr_hmc_plain(init, gen, data, **settings)
    torch.cuda.synchronize()
    assert torch.equal(gen.get_state(), after)
    assert K.shape == P.shape == (C, settings["num_samples"], d) and K.is_cuda
    assert float((K - P).abs().max()) <= 1e-9
    for got, want in zip(_kappa_and_c(K), _kappa_and_c(P)):
        assert math.isclose(got, want, rel_tol=1e-10)


def _batch_mean_se(x, n_batches=20):
    means = x.reshape(n_batches, -1).mean(dim=1)
    return float(means.std() / math.sqrt(n_batches))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 2])
def test_wlr_hmc_kernel_full_run_matches_plain_in_distribution(cuda, d):
    """At RAABBVI's settings (4 chains, 500 + 500 iterations, 24 leapfrog
    steps) the chains part from the plain version's (the sampler amplifies
    round-off), so the whole run is held statistically: the posterior
    means of kappa (d = 3) and log c within 4 batch-means Monte Carlo
    standard errors of the plain version's on the card."""
    init, data = _wlr_case(4, d, 4, cuda)
    gen = torch.Generator(cuda).manual_seed(7)
    state = gen.get_state()
    K = ops.wlr_hmc(init, gen, data)
    gen.set_state(state)
    P = ops.wlr_hmc_plain(init, gen, data)
    assert K.shape == (4, 500, d) and torch.isfinite(K).all()
    cols = {"log_c": (lambda v: v[..., d - 2])}
    if d == 3:
        cols["kappa"] = lambda v: torch.sigmoid(v[..., 0])
    for name, fn in cols.items():
        a, b = fn(K).reshape(-1), fn(P).reshape(-1)
        se = math.hypot(_batch_mean_se(a), _batch_mean_se(b))
        assert abs(float(a.mean() - b.mean())) < 4 * se, name


@pytest.mark.cuda
def test_wlr_hmc_raises_on_what_the_kernel_does_not_take(cuda):
    init, (y, x, w, rho) = _wlr_case(4, 3, 2, cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    before = ops.launch_counts()["wlr_hmc"]
    with pytest.raises(TypeError):
        ops.wlr_hmc(init.float(), gen, (y.float(), x.float(), w.float(), rho))
    with pytest.raises(ValueError, match="contiguous"):
        ops.wlr_hmc(init, gen, (torch.stack([y, y], 1)[:, 0], x, w, rho))
    with pytest.raises(ValueError, match="contiguous"):
        ops.wlr_hmc(init.T.contiguous().T, gen, (y, x, w, rho))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.wlr_hmc(init, gen, (y.cpu(), x, w, rho))
    big = torch.zeros(KERNEL_MAX_ROWS + 1, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        ops.wlr_hmc(init, gen, (big, big, big, rho))
    assert ops.launch_counts()["wlr_hmc"] == before


class _TableNormal:
    """Base draws as consecutive rows of one seeded table, on any device."""

    def __init__(self, seed, rows, width):
        self.table = torch.randn((rows, width), dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(seed))
        self.pos = 0

    def normal(self, generator, n_samples, width, dtype, device):
        rows = self.table[self.pos:self.pos + n_samples, :width]
        self.pos += n_samples
        return rows.to(device=device, dtype=dtype)


@pytest.mark.cuda
def test_round_regression_runs_on_the_card(cuda, monkeypatch):
    """The cuda twin of tests/test_torch_wlr_hmc.py::
    test_regression_runs_on_the_generator_device: a regression handed a
    card generator launches the kernel once and leaves its fit on the
    card; RAABBVI.optimize on card tensors launches it once a regression
    and keeps a card generator's 16-byte state for its HMC."""
    helper = vt.RAABBVI(vt.RMSProp(0.1))
    x = [math.log(0.1 * 0.5 ** k) for k in range(4)]
    y = [1.5 + 1.2 * v for v in x]
    before = ops.launch_counts()["wlr_hmc"]
    fit, kappa, c = helper.weighted_linear_regression(
        y, x, generator=torch.Generator(cuda).manual_seed(0))
    assert ops.launch_counts()["wlr_hmc"] == before + 1
    assert fit["kappa"].is_cuda and 0 < kappa < 1 and c > 0
    calls = []
    real = vt.RAABBVI.weighted_linear_regression

    def counted(self, *args, **kwargs):
        calls.append(kwargs["generator"].device.type)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(vt.RAABBVI, "weighted_linear_regression", counted)
    model, _ = vt.zoo.logistic_regression(dim=4, n_data=40, device=cuda,
                                          dtype=torch.float64)
    approx = vt.FullRankGaussian(4, base_sampler=_TableNormal(1, 60000, 4), device=cuda,
                                 dtype=torch.float64)
    objective = vt.ExclusiveKL(approx, model, 4, use_path_deriv=True)
    before = ops.launch_counts()["wlr_hmc"]
    res = vt.RAABBVI(vt.RMSProp(0.1, diagnostics=True), W_min=50, k_check=50).optimize(
        360, objective, approx.init_param(), generator=torch.Generator(cuda).manual_seed(0))
    assert len(calls) >= 1 and set(calls) == {"cuda"}
    assert ops.launch_counts()["wlr_hmc"] - before == len(calls) == len(res["kappa_hist"])
    assert all(math.isfinite(k) for k in res["kappa_hist"])


@pytest.mark.cuda
def test_front_door_cov_norm_takes_the_eigensolve_on_the_card(cuda, monkeypatch):
    """q's (1000, 1000) float32 L Lᵀ, the front door's shape: its spectral
    norm comes from one symmetric eigensolve, within 1e-5 of the float64
    SVD norm."""
    from viabel_torch import diagnostics

    approx = vt.FullRankGaussian(1000, device=cuda, dtype=torch.float32)
    gen = torch.Generator(cuda).manual_seed(22)
    param = approx.init_param() + 0.05 * torch.randn(
        approx.var_param_dim, generator=gen, device=cuda)
    var = approx.mean_and_cov(param)[1]
    solves = []
    eigvalsh = torch.linalg.eigvalsh
    monkeypatch.setattr(torch.linalg, "eigvalsh",
                        lambda A, *args, **kwargs: solves.append(A.shape)
                        or eigvalsh(A, *args, **kwargs))
    norm = diagnostics._compute_norm_if_needed(var)
    exact = float(torch.linalg.matrix_norm(var.double(), ord=2))
    assert solves == [(1000, 1000)]
    assert norm.dtype == torch.float32 and norm.is_cuda
    assert abs(float(norm) - exact) <= 1e-5 * exact
