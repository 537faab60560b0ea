"""The restart branches of ``bbvi(standardize=True)`` and
``bbvi(init_method="pathfinder")`` in the port against the JAX package, in
float64 on the CPU.

The objective's draws are injected as in tests/test_torch_multistart.py;
the pilot's family draws from one table too (as in
tests/test_torch_standardize.py), and Pathfinder's draws are recomputed
from the JAX keys (as in tests/test_torch_pathfinder.py).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.convenience as jconv  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.convenience as tconv  # noqa: E402
from test_torch_multistart import (StreamNormal, TorchStreamNormal, close,  # noqa: E402
                                   fixed_clocks, inits, objectives)
from test_torch_pathfinder import DrawTable, _jax_path_draws  # noqa: E402

__all__ = ["fixed_clocks"]  # a fixture, used by name
D = 3
B = 3
RUN = dict(W_min=50, k_check=50, max_history=400)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def injected_pilot(monkeypatch):
    """Both packages' pilot family draws consecutive rows of one table of
    normals (fresh draws each step: with one fixed block the pilot's
    RMSProp settles where its normalized steps amplify round-off)."""
    table = np.random.RandomState(9).randn(20000, D)
    monkeypatch.setattr(jconv, "MFGaussian",
                        functools.partial(vj.MFGaussian, base_sampler=StreamNormal(table)))
    monkeypatch.setattr(tconv, "MFGaussian", functools.partial(
        vt.MFGaussian, base_sampler=TorchStreamNormal(table)))


def test_bbvi_standardize_restarts_match_jax(fixed_clocks, injected_pilot):
    """standardize=True with num_restarts: one pilot, every restart run on
    the standardized target and folded back to the user's space; explicit
    inits are unfolded first. opt_params, the ELBOs (pilot space) and the
    best restart match JAX's."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D)
    x0 = inits(2, dim=D)
    kw = dict(n_iters=200, adaptive=True, fixed_lr=True, learning_rate=0.05,
              FASO_kwargs=RUN, pilot_kwargs=dict(n_iters=60, num_mc_samples=8),
              standardize=True)
    results = {}
    for name, inputs in (("tiled", dict(num_restarts=2)),
                         ("explicit", dict(init_var_params=x0))):
        if name == "explicit":
            (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D, seed=3)
        res_j = vj.bbvi(D, objective=obj_j, key=jax.random.PRNGKey(0),
                        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                           for k, v in inputs.items()}, **kw)
        res_t = vt.bbvi(D, objective=obj_t, **inputs, **kw)
        results[name] = res_t
        assert smp_t.pos == smp_j.pos
        assert res_t["best_restart"] == res_j["best_restart"]
        close(res_t["opt_params"], res_j["opt_params"])
        close(res_t["restart_elbos"], res_j["restart_elbos"])
        close(res_t["init_var_params"], res_j["init_var_params"])
        assert torch.equal(res_t["opt_param"], res_t["opt_params"][res_t["best_restart"]])
        assert obj_t.model is not res_t["standardization"]["spec"]
    # restart 0 started at the user's x0[0], unfolded into pilot space
    p_mu, p_scale = results["explicit"]["standardization"]["affine"]
    approx = results["explicit"]["objective"].approx
    close(approx.fold_affine(results["explicit"]["init_var_params"][0], p_mu, p_scale),
          x0[0], rtol=1e-12)


def test_bbvi_pathfinder_restarts_match_jax(fixed_clocks):
    """init_method="pathfinder" with num_restarts: one Pathfinder path a
    restart (per_path), its Gaussian as the restart's init; JAX's path
    draws are recomputed from its keys and injected."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D)
    starts = 2.0 * np.random.RandomState(6).randn(B, D)
    pf = dict(init_point=starts, max_iters=8, history=3, n_elbo_draws=10)
    key = jax.random.PRNGKey(4)
    kw = dict(n_iters=200, num_restarts=B, adaptive=True, fixed_lr=True,
              learning_rate=0.05, FASO_kwargs=RUN, init_method="pathfinder")
    res_j = vj.bbvi(D, objective=obj_j, key=key,
                    pathfinder_kwargs={**pf, "init_point": jnp.asarray(starts)}, **kw)
    _, pf_key = jax.random.split(key)
    _, key_paths = jax.random.split(pf_key)
    draws = [_jax_path_draws(k, 9, 10, 1, D) for k in jax.random.split(key_paths, B)]
    table = np.concatenate([np.concatenate([e for e, _ in draws]),
                            np.concatenate([f for _, f in draws])])
    sampler = DrawTable(table)
    res_t = vt.bbvi(D, objective=obj_t, pathfinder_kwargs={
        **pf, "init_point": torch.as_tensor(starts), "base_sampler": sampler}, **kw)
    assert sampler.pos == table.shape[0] and smp_t.pos == smp_j.pos
    close(res_t["init_var_params"], res_j["init_var_params"])
    assert res_t["k_stopped"] == res_j["k_stopped"]
    assert res_t["best_restart"] == res_j["best_restart"]
    close(res_t["opt_params"], res_j["opt_params"])
