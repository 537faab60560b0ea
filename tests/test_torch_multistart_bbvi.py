"""``bbvi``'s multistart leg in the port against the JAX package, in
float64 on the CPU: the three routes (adaptive -> lockstep
``multistart_raabbvi``, ``fixed_lr`` -> ``multistart_faso``, plain ->
``multistart_optimize``), explicit ``init_var_params`` with an lr grid,
``init_jitter`` and every ``ValueError``. The restart branches of
``standardize=True`` and ``init_method="pathfinder"`` are in
tests/test_torch_multistart_init.py.

Draws are injected as in tests/test_torch_multistart.py. The regression's
HMC is stubbed on both sides (tests/test_torch_multistart_raabbvi.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_torch as vt  # noqa: E402
from test_torch_multistart import F64, close, fixed_clocks, inits, objectives  # noqa: E402
from test_torch_multistart_raabbvi import fixed_regression  # noqa: E402

__all__ = ["fixed_clocks", "fixed_regression"]  # fixtures, used by name
D = 3
B = 3
RUN = dict(W_min=50, k_check=50, max_history=400)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROUTES = {
    "raabbvi": dict(adaptive=True, fixed_lr=False, RAABBVI_kwargs=dict(iters0=10, **RUN),
                    multistart_kwargs=dict(verbose=False)),
    "faso": dict(adaptive=True, fixed_lr=True, FASO_kwargs=RUN),
    "optimize": dict(adaptive=False, fixed_lr=True),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_bbvi_multistart_route_matches_jax(fixed_clocks, fixed_regression, route):
    """bbvi(num_restarts=3) on each route: the restarts' optima to rtol
    1e-8, the selection's ELBOs (common draws) and the best restart equal;
    opt_param is the best row, and the default escalation is armed on the
    adaptive routes."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D)
    kw = dict(n_iters=600, learning_rate=0.05, num_restarts=B, **ROUTES[route])
    res_j = vj.bbvi(D, objective=obj_j, key=jax.random.PRNGKey(0), **kw)
    res_t = vt.bbvi(D, objective=obj_t, generator=torch.Generator().manual_seed(0), **kw)
    assert smp_t.pos == smp_j.pos
    assert res_t["best_restart"] == res_j["best_restart"]
    close(res_t["opt_params"], res_j["opt_params"])
    close(res_t["restart_elbos"], res_j["restart_elbos"])
    assert torch.equal(res_t["opt_param"], res_t["opt_params"][res_t["best_restart"]])
    assert res_t["objective"] is obj_t and res_t["init_var_params"].shape == (B, D + D * D)
    if route != "optimize":
        np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                      res_j["mc_escalation_history"])
        assert obj_t.num_mc_samples == obj_j.num_mc_samples


def test_bbvi_init_var_params_and_lr_grid_match_jax(fixed_clocks):
    """Explicit (B, D) inits with a per-restart lr grid on the fixed_lr
    route; the displaced, barely moving restart loses the selection."""
    (obj_j, smp_j), (obj_t, smp_t) = objectives(4, dim=D)
    x0 = inits(2, dim=D)
    x0[1, :D] += 8.0
    kw = dict(n_iters=400, adaptive=True, fixed_lr=True, FASO_kwargs=RUN,
              learning_rate=np.array([0.05, 1e-6]))
    res_j = vj.bbvi(D, objective=obj_j, init_var_params=jnp.asarray(x0),
                    key=jax.random.PRNGKey(0), **kw)
    res_t = vt.bbvi(D, objective=obj_t, init_var_params=torch.as_tensor(x0), **kw)
    assert res_t["best_restart"] == res_j["best_restart"] == 0
    assert res_t["k_stopped"] == res_j["k_stopped"]
    close(res_t["opt_params"], res_j["opt_params"])
    close(res_t["restart_elbos"], res_j["restart_elbos"])


def test_bbvi_init_jitter():
    """Restart 0 keeps the base init exactly; the others are spread."""
    model, _ = vt.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **F64)
    res = vt.bbvi(2, log_density=model, num_mc_samples=10, n_iters=50, adaptive=False,
                  fixed_lr=True, num_restarts=3, init_jitter=0.5, device="cpu",
                  dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    x0 = res["init_var_params"]
    assert torch.equal(x0[0], vt.MFGaussian(2, **F64).init_param())
    assert not torch.allclose(x0[1], x0[0]) and not torch.allclose(x0[2], x0[1])


_MODEL_J = vj.zoo.diagonal_gaussian(np.zeros(2), np.ones(2))[0]
_MODEL_T = vt.zoo.diagonal_gaussian(np.zeros(2), np.ones(2), **F64)[0]


@pytest.mark.parametrize("kwargs", [
    dict(num_restarts=2, progress_callback=print),
    dict(num_restarts=3, init_var_params=np.zeros((2, 4))),
    dict(init_var_params=np.zeros(4)),
    dict(learning_rate=np.array([0.1, 0.2])),
    dict(num_restarts=2, adaptive=False, fixed_lr=True, learning_rate=np.array([0.1, 0.2])),
    dict(num_restarts=3, learning_rate=np.array([0.1, 0.2])),
    dict(num_restarts=0),
    dict(num_restarts=2, adaptive=False),
    dict(init_jitter=0.5),
    dict(init_jitter=0.5, init_var_params=np.zeros((2, 4))),
    dict(init_method="pathfinder", init_var_params=np.zeros((2, 4))),
], ids=["progress_callback", "disagreeing_B", "one_dim_inits", "lr_array_single",
        "lr_array_plain", "lr_array_length", "zero_restarts", "decaying_plain",
        "jitter_single", "jitter_explicit", "pathfinder_explicit"])
def test_bbvi_multistart_value_errors_match_jax(kwargs):
    """Each of the multistart leg's ValueErrors, with JAX's message."""
    conv_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) and k == "init_var_params"
              else v for k, v in kwargs.items()}
    with pytest.raises(ValueError) as exc_j:
        vj.bbvi(2, log_density=_MODEL_J, n_iters=5, **conv_j)
    with pytest.raises(ValueError) as exc_t:
        vt.bbvi(2, log_density=_MODEL_T, n_iters=5, device="cpu", dtype=torch.float64,
                **kwargs)
    assert str(exc_t.value) == str(exc_j.value)
