"""The port's C++ model bridge (``viabel_torch.external``) against the JAX
package's, in float64 on the CPU.

Both bridges call the same C code (each package compiles its own copy of
``viabel_models.cpp``), so log densities and gradients must agree bit for
bit; a bbvi run through a native model matches the JAX run with injected
draws (see tests/test_torch_faso.py).
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.faso as jfaso  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
from test_torch_faso import StreamNormal, TorchStreamNormal  # noqa: E402
from viabel_torch.external import CModel, bridge  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [("std_normal", 4), ("robust_regression", None), ("funnel", None)]


@pytest.fixture(scope="module")
def jax_cmodel():
    from viabel_tpu.external import CModel as JaxCModel
    return JaxCModel


@pytest.mark.parametrize("name,dim", CASES)
def test_cmodel_matches_jax_cmodel(jax_cmodel, name, dim):
    """Log density and gradient of each native model equal the JAX
    bridge's exactly (the same C code); the output keeps the input's
    dtype."""
    model_j, model_t = jax_cmodel(name, dim=dim), CModel(name, dim=dim)
    assert model_t.dim == model_j.dim
    x = np.random.RandomState(0).randn(7, model_t.dim)
    xt = torch.as_tensor(x).requires_grad_(True)
    lp_t = model_t(xt)
    (g_t,) = torch.autograd.grad(lp_t.sum(), xt)
    lp_j = model_j(jnp.asarray(x))
    g_j = jax.grad(lambda z: jnp.sum(model_j(z)))(jnp.asarray(x))
    np.testing.assert_array_equal(lp_t.detach().numpy(), np.asarray(lp_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert lp_t.dtype == torch.float64 and lp_t.shape == (7,)
    lp32 = model_t(xt.detach().float())
    assert lp32.dtype == torch.float32
    np.testing.assert_allclose(lp32.numpy(), np.asarray(lp_j), rtol=1e-5)


@pytest.mark.parametrize("name,dim", CASES)
def test_cmodel_backward_scales_by_the_cotangent(jax_cmodel, name, dim):
    """The backward is one batched gradient call times the cotangent, as
    the JAX bridge's custom VJP (rtol 1e-14); a single point (1-D input)
    gives a scalar."""
    model_j, model_t = jax_cmodel(name, dim=dim), CModel(name, dim=dim)
    rng = np.random.RandomState(1)
    x, w = rng.randn(5, model_t.dim), rng.randn(5)
    xt = torch.as_tensor(x).requires_grad_(True)
    (g_t,) = torch.autograd.grad(model_t(xt), xt, grad_outputs=torch.as_tensor(w))
    _, vjp = jax.vjp(model_j, jnp.asarray(x))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(vjp(jnp.asarray(w))[0]),
                               rtol=1e-14, atol=0)
    assert model_t(torch.as_tensor(x[0])).shape == ()


def test_cmodel_matches_the_ports_zoo():
    """The native models against the port's own zoo counterparts."""
    x = torch.as_tensor(np.random.RandomState(2).randn(6, 2)).requires_grad_(True)
    for name, zoo_model in (("robust_regression", vt.zoo.robust_regression(device="cpu",
                                                                           dtype=torch.float64)),
                            ("funnel", vt.zoo.funnel())):
        native, ref = CModel(name)(x), zoo_model[0](x)
        torch.testing.assert_close(native, ref, rtol=1e-12, atol=1e-12)
        g_native = torch.autograd.grad(native.sum(), x)[0]
        g_ref = torch.autograd.grad(ref.sum(), x)[0]
        torch.testing.assert_close(g_native, g_ref, rtol=1e-10, atol=1e-12)


def test_cmodel_errors_match_jax(jax_cmodel):
    """JAX's ValueErrors: an unknown name, and an any-dimension model
    without ``dim``."""
    for kw in (dict(name="not_a_model"), dict(name="std_normal")):
        with pytest.raises(ValueError) as exc_j:
            jax_cmodel(**kw)
        with pytest.raises(ValueError) as exc_t:
            CModel(**kw)
        assert str(exc_t.value) == str(exc_j.value)


def test_native_build_uses_the_ports_copy(tmp_path, monkeypatch):
    """The library builds from the port's own source into the port's
    build directory, keyed by the source's md5; clear_native_cache removes
    it there and nothing else. The port's copy equals the JAX package's
    below the header comment."""
    assert bridge._CPP_SOURCE.startswith(os.path.join(REPO, "viabel_torch"))
    mine = open(bridge._CPP_SOURCE).read()
    theirs = open(os.path.join(REPO, "viabel_tpu/external/cpp/viabel_models.cpp")).read()
    assert mine[mine.index("#include"):] == theirs[theirs.index("#include"):]
    monkeypatch.setattr(bridge, "BUILD_DIR", tmp_path)
    keep = tmp_path / "libviabel_kernels-0.so"
    keep.write_bytes(b"")
    path = bridge.build_native_library()
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    assert bridge.build_native_library() == path  # cached
    assert CModel("funnel", library_path=path).dim == 2
    bridge.clear_native_cache()
    assert not os.path.exists(path) and keep.exists()


def test_build_without_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(bridge, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(bridge.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        bridge.build_native_library()


@pytest.fixture
def fixed_clocks(monkeypatch):
    class FixedTimer:
        interval = 1e-9

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    for mod in (jfaso, tfaso):
        monkeypatch.setattr(mod, "Timer", FixedTimer)


def test_bbvi_through_cmodel_matches_jax(jax_cmodel, fixed_clocks):
    """bbvi's FASO route on CModel("robust_regression") with a
    FullRankGaussian STL objective and injected draws: the decisions are
    equal and opt_param agrees to rtol 1e-8."""
    table = np.random.RandomState(0).randn(20000, 2)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    obj_j = vj.ExclusiveKL(vj.FullRankGaussian(2, base_sampler=smp_j),
                           jax_cmodel("robust_regression"), 4, use_path_deriv=True)
    obj_t = vt.ExclusiveKL(vt.FullRankGaussian(2, base_sampler=smp_t, device="cpu",
                                               dtype=torch.float64),
                           CModel("robust_regression"), 4, use_path_deriv=True)
    kw = dict(n_iters=600, fixed_lr=True, learning_rate=0.05,
              RMS_kwargs=dict(diagnostics=False), FASO_kwargs=dict(W_min=50, k_check=50))
    res_j = vj.bbvi(2, objective=obj_j, **kw)
    res_t = vt.bbvi(2, objective=obj_t, **kw)
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    assert res_t["k_stopped"] is not None
    assert smp_t.pos == smp_j.pos
    np.testing.assert_allclose(res_t["opt_param"].numpy(), np.asarray(res_j["opt_param"]),
                               rtol=1e-8, atol=1e-12)
