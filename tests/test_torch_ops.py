"""viabel_torch.ops against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version to the JAX Pallas kernel run in interpret mode, as
tests/test_ops.py runs it. The CUDA kernels themselves are compared with
the plain versions in tests/test_torch_kernels.py (skipped without a
card) and by ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from viabel_torch import ops  # noqa: E402
from viabel_torch.convert import ring_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("R,D,G", [(64, 1000, 8), (40, 7, 8)])
def test_ring_group_stats_plain_matches_pallas(R, D, G):
    """rtol 1e-12: the same float64 sums of `group` terms, in another order."""
    from viabel_tpu.ops.dispatch import set_pallas_enabled
    from viabel_tpu.ops.ringstats import ring_group_stats as jax_ring_group_stats
    from viabel_tpu.utils import pack_rows
    rng = np.random.RandomState(5)
    packed = pack_rows(jnp.asarray(rng.randn(R, D) + 10.0))
    set_pallas_enabled(True)
    try:
        GS_j, GQ_j = jax_ring_group_stats(packed, packed[-1], G)
    finally:
        set_pallas_enabled(None)
    ring = ring_from_jax(packed, D, device="cpu")
    GS, GQ = ops.ring_group_stats(ring, ring[-1], G)
    np.testing.assert_allclose(GS.numpy(), ring_from_jax(GS_j, D, device="cpu").numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(GQ.numpy(), ring_from_jax(GQ_j, D, device="cpu").numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("d,S", [(8, 3), (130, 5)])
def test_stl_transpose_solve_plain_matches_pallas(d, S):
    """rtol 1e-8, the accuracy bar of tests/test_ops.py for the Pallas
    kernel's Newton-inverted blocks against a direct solve."""
    from viabel_tpu.ops.trsm import stl_transpose_solve as jax_stl
    rng = np.random.RandomState(14)
    theta = rng.randn(d, d)
    B = rng.randn(d, S)
    want = np.asarray(jax_stl(jnp.asarray(theta), jnp.asarray(B)))
    got = ops.stl_transpose_solve(torch.as_tensor(theta), torch.as_tensor(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)
