"""viabel_torch.ops wrappers: dispatch, input checks and the CUDA kernels.

This file imports no JAX, so it also runs where only PyTorch is
installed. Tests marked ``cuda`` compare each kernel with its plain
version and skip without a card; on a machine with one, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest`` because tests/conftest.py configures JAX).
"""

import pytest

torch = pytest.importorskip("torch")

from viabel_torch import ops  # noqa: E402
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
    assert ops.launch_counts() == {"ring_group_stats": 0, "stl_transpose_solve": 0}


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
