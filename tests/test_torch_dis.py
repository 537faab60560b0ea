"""The port's DISInclusiveKL and the objective-state protocol against the
JAX package.

Both packages draw the same base normals through the families'
``base_sampler`` hook (a numpy table, handed out in order; on the JAX side
through ``pure_callback`` inside the jitted step). The resampling draw is
``jax.random.choice`` on the JAX side, whose stream torch cannot
reproduce: the JAX indices are recomputed from the step's key and
injected into the port through the objective's ``resampler`` hook. All in
float64 on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import viabel_tpu as vj  # noqa: E402
import viabel_tpu.faso as jfaso  # noqa: E402
import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
from viabel_torch.convert import obj_state_from_jax  # noqa: E402

D = 3
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StreamNormal:
    """Consecutive rows of one numpy table of standard normals; the JAX
    hook hands them out through ``pure_callback``."""

    def __init__(self, table):
        self.table, self.pos = table, 0

    def take(self, n, width):
        rows = self.table[self.pos:self.pos + n, :width]
        assert rows.shape[0] == n, "draw table exhausted"
        self.pos += n
        return rows

    def normal(self, key, n_samples, width, dtype):
        return jax.pure_callback(
            lambda _key: self.take(n_samples, width).astype(dtype),
            jax.ShapeDtypeStruct((n_samples, width), dtype), key)


class TorchStreamNormal(StreamNormal):
    def normal(self, generator, n_samples, width, dtype, device):
        return torch.as_tensor(self.take(n_samples, width), dtype=dtype, device=device)


class InjectedChoice:
    """The port's resampling hook, handing out given index rows in order."""

    def __init__(self, rows):
        self.rows = list(rows)

    def choice(self, generator, p, n):
        idx = torch.as_tensor(np.array(self.rows.pop(0)), dtype=torch.long)
        assert idx.shape == (n,)
        return idx


def _pair(S=20, ess_target=10, table_seed=0, jax_kw=None, **kw):
    """DIS over FullRankGaussian(D) on logistic_regression in both
    packages, with an MFGaussian temper prior at zero parameters."""
    table = np.random.RandomState(table_seed).randn(200000, D)
    smp_j, smp_t = StreamNormal(table), TorchStreamNormal(table)
    model_j, _ = vj.zoo.logistic_regression(dim=D, n_data=40)
    model_t, _ = vt.zoo.logistic_regression(dim=D, n_data=40, **F64)
    prior_params = np.zeros(2 * D)
    obj_j = vj.DISInclusiveKL(vj.FullRankGaussian(D, base_sampler=smp_j), model_j, S,
                              ess_target=ess_target, temper_prior=vj.MFGaussian(D),
                              temper_prior_params=prior_params, **kw, **(jax_kw or {}))
    obj_t = vt.DISInclusiveKL(vt.FullRankGaussian(D, base_sampler=smp_t, **F64), model_t,
                              S, ess_target=ess_target,
                              temper_prior=vt.MFGaussian(D, **F64),
                              temper_prior_params=prior_params, **kw)
    return (obj_j, smp_j), (obj_t, smp_t)


def _start(seed=3):
    """A full-rank parameter near the family's start (all zeros: mu = 0,
    L = I)."""
    return 0.3 * np.random.RandomState(seed).randn(D + D * D)


def _close(got, want, rtol=1e-10, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("eps_guess", [1.0, 0.7, 0.05])
def test_eps_and_weights_match_jax(eps_guess):
    """The 50-step bisection, its endpoint handling and the final weights,
    on the same inputs, to rtol 1e-10."""
    (obj_j, _), (obj_t, _) = _pair(S=40, ess_target=12)
    rng = np.random.RandomState(4)
    samples = rng.randn(40, D)
    log_p = -0.5 * np.sum(samples**2, axis=1) * 3.0 + rng.randn(40)
    log_q = -0.5 * np.sum(samples**2, axis=1) + 0.1 * rng.randn(40)
    eps_j, ess_j, w_j = obj_j._eps_and_weights(eps_guess, jnp.asarray(samples),
                                               jnp.asarray(log_p), jnp.asarray(log_q))
    eps_t, ess_t, w_t = obj_t._eps_and_weights(torch.tensor(eps_guess, dtype=torch.float64),
                                               torch.as_tensor(samples),
                                               torch.as_tensor(log_p),
                                               torch.as_tensor(log_q))
    _close(eps_t, eps_j)
    _close(ess_t, ess_j)
    _close(w_t, w_j)
    assert 0.0 <= float(eps_t) <= eps_guess


def test_clip_weights_match_jax_where_the_clip_bites():
    """tau = 0.05 over 100 heavy-tailed weights: the 16 proportional
    passes bring every share to within 1e-6 of tau (the passes stop
    there, they do not iterate to the exact cap) and keep the total, as
    in JAX."""
    (obj_j, _), (obj_t, _) = _pair(S=100, ess_target=10, w_clip_threshold=0.05)
    w = np.exp(3.0 * np.random.RandomState(5).randn(100))
    assert w.max() / w.sum() > 0.05  # the clip has work to do
    got = obj_t._clip_weights(torch.as_tensor(w))
    want = obj_j._clip_weights(jnp.asarray(w))
    _close(got, want)
    assert float(got.max() / got.sum()) <= 0.05 * (1 + 1e-6)
    np.testing.assert_allclose(float(got.sum()), w.sum(), rtol=1e-12)
    # the default threshold, 10, leaves the weights alone
    (_, _), (obj_d, _) = _pair(S=100)
    assert torch.equal(obj_d._clip_weights(torch.as_tensor(w)), torch.as_tensor(w))


def test_refresh_matches_jax():
    """One refresh on the same draws: the samples, log q, the clipped
    weights and eps."""
    (obj_j, smp_j), (obj_t, smp_t) = _pair(S=30, ess_target=8, w_clip_threshold=0.2)
    vp = _start()
    s_j, lq_j, w_j, eps_j = obj_j._refresh(jnp.asarray(vp), jax.random.PRNGKey(0), 1.0)
    s_t, lq_t, w_t, eps_t = obj_t._refresh(torch.as_tensor(vp), None,
                                           torch.tensor(1.0, dtype=torch.float64))
    assert smp_t.pos == smp_j.pos == 30
    for got, want in ((s_t, s_j), (lq_t, lq_j), (w_t, w_j), (eps_t, eps_j)):
        _close(got.detach(), want)


def _jax_choice_rows(key, new_state, batch, S):
    """The indices JAX's resampling step drew: its refresh/resample key
    split and ``jax.random.choice`` on the weights it used."""
    _, key_resample = jax.random.split(key)
    return np.asarray(jax.random.choice(key_resample, S, shape=(batch,),
                                        p=new_state["w_norm"]))


@pytest.mark.parametrize("mode", ["no_resampling", "resampling", "resampling_every_2"])
def test_steps_match_jax(mode):
    """Two steps of each mode from the same start: the value, the gradient
    and every entry of the new state, to rtol 1e-10. ``resampling_every_2``
    refreshes at step 0 and reads the cache at step 1."""
    kw = {"no_resampling": dict(use_resampling=False),
          "resampling": dict(use_resampling=True),
          "resampling_every_2": dict(use_resampling=True, num_resampling_batches=2)}[mode]
    S, ess = 24, 8
    (obj_j, smp_j), (obj_t, smp_t) = _pair(S=S, ess_target=ess, **kw)
    vp_j = jnp.asarray(_start())
    vp_t = torch.as_tensor(_start())
    state_j = obj_j.init_obj_state(vp_j)
    state_t = obj_t.init_obj_state(vp_t)
    choices = InjectedChoice([])
    obj_t._resampler = choices
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        val_j, grad_j, state_j = obj_j.value_and_grad_with_state(vp_j, key, state_j)
        if kw["use_resampling"]:
            batch = obj_j._resampling_batch_size
            choices.rows.append(_jax_choice_rows(key, state_j, batch, S))
        val_t, grad_t, state_t = obj_t.value_and_grad_with_state(vp_t, None, state_t)
        _close(val_t, val_j)
        _close(grad_t, grad_j)
        assert set(state_t) == set(state_j)
        for name in state_j:
            _close(state_t[name], state_j[name])
        assert state_t["step"].device.type == "cpu"
        assert smp_t.pos == smp_j.pos
        # the next step starts from a moved parameter
        vp_j = vp_j - 0.05 * grad_j
        vp_t = vp_t - 0.05 * grad_t
    assert not choices.rows
    # the cache was refreshed once every num_resampling_batches steps
    assert smp_t.pos == S * (1 if mode == "resampling_every_2" else 2)


def test_rmsprop_trajectory_matches_jax():
    """400 RMSProp steps in the no-resampling mode, per-step parameters
    and values against the JAX scan, to rtol 1e-8."""
    (obj_j, smp_j), (obj_t, smp_t) = _pair(use_resampling=False)
    res_j = vj.RMSProp(0.05, diagnostics=True).optimize(400, obj_j, jnp.asarray(_start()))
    res_t = vt.RMSProp(0.05, diagnostics=True).optimize(400, obj_t,
                                                        torch.as_tensor(_start()))
    assert smp_t.pos == smp_j.pos == 400 * 20
    np.testing.assert_allclose(res_t["variational_param_history"].numpy(),
                               np.asarray(res_j["variational_param_history"]),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res_t["value_history"].numpy(),
                               np.asarray(res_j["value_history"]), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(res_t["opt_param"].numpy(), np.asarray(res_j["opt_param"]),
                               rtol=1e-8, atol=1e-12)


@pytest.fixture
def fixed_clocks(monkeypatch):
    """A negligible fake MCSE cost in both packages (the recheck growth sits
    at its floor), as tests/test_torch_faso.py stubs it."""

    class FixedTimer:
        interval = 1e-9

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class FakeClock:
        t = 0.0

        @classmethod
        def now(cls):
            cls.t += 1.0
            return cls.t

    for mod in (jfaso, tfaso):
        monkeypatch.setattr(mod, "Timer", FixedTimer)
        monkeypatch.setattr(mod, "_now", FakeClock.now)


def test_faso_run_matches_jax(fixed_clocks):
    """FASO over DIS in the no-resampling mode: the objective state rides
    the segment loop and is checked at every boundary; the decisions are
    equal and opt_param agrees to rtol 1e-8."""
    (obj_j, smp_j), (obj_t, smp_t) = _pair(use_resampling=False)
    kw = dict(W_min=50, k_check=50, mcse_threshold=0.2, max_history=300)
    res_j = vj.FASO(vj.RMSProp(0.05), **kw).optimize(700, obj_j, jnp.asarray(_start()))
    res_t = tfaso.FASO(vt.RMSProp(0.05), **kw).optimize(700, obj_t,
                                                        torch.as_tensor(_start()))
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    assert res_t["k_conv"] is not None
    assert smp_t.pos == smp_j.pos
    np.testing.assert_allclose(res_t["opt_param"].numpy(), np.asarray(res_j["opt_param"]),
                               rtol=1e-8, atol=1e-12)
    rs_j, rs_t = res_j["resume_state"], res_t["resume_state"]
    for name, value in rs_j["obj_state"].items():
        _close(rs_t["obj_state"][name], value, rtol=1e-8, atol=1e-12)


def test_escalation_resizes_the_state_as_jax_does(fixed_clocks):
    """A stalled gate (rhat_threshold 1.005) climbs the mc_escalation
    ladder: each rung resizes the DIS state (eps and ok carried, the
    cache rebuilt), and the escalation record, S and opt_param equal
    JAX's."""
    (obj_j, smp_j), (obj_t, smp_t) = _pair(S=8, ess_target=4, use_resampling=False)
    kw = dict(W_min=50, k_check=50, rhat_threshold=1.005, max_history=300,
              mc_escalation=2.0, mc_max_samples=32)
    res_j = vj.FASO(vj.RMSProp(0.05), **kw).optimize(800, obj_j, jnp.asarray(_start()))
    res_t = tfaso.FASO(vt.RMSProp(0.05), **kw).optimize(800, obj_t,
                                                        torch.as_tensor(_start()))
    np.testing.assert_array_equal(res_t["mc_escalation_history"],
                                  res_j["mc_escalation_history"])
    assert len(res_t["mc_escalation_history"]) >= 1
    assert obj_t.num_mc_samples == obj_j.num_mc_samples > 8
    assert smp_t.pos == smp_j.pos
    for name in ("k_conv", "k_Rhat", "k_stopped"):
        assert res_t[name] == res_j[name], name
    np.testing.assert_allclose(res_t["opt_param"].numpy(), np.asarray(res_j["opt_param"]),
                               rtol=1e-8, atol=1e-12)


def test_resize_obj_state_matches_jax():
    """resize_obj_state in the resampling mode: eps and ok carry over, the
    cache is rebuilt at the new count and the refresh clock zeroes."""
    (obj_j, _), (obj_t, _) = _pair(S=12, ess_target=6)
    vp = _start()
    state_j = {**obj_j.init_obj_state(jnp.asarray(vp)),
               "eps": jnp.asarray(0.3), "ok": jnp.asarray(False), "step": jnp.asarray(7)}
    state_t = obj_state_from_jax(state_j, obj_t.approx)
    obj_j.num_mc_samples = 30
    obj_t.num_mc_samples = 30
    new_j = obj_j.resize_obj_state(state_j, jnp.asarray(vp))
    new_t = obj_t.resize_obj_state(state_t, torch.as_tensor(vp))
    assert set(new_t) == set(new_j)
    for name in new_j:
        assert tuple(new_t[name].shape) == tuple(np.shape(new_j[name])), name
        _close(new_t[name], new_j[name])
    assert new_t["samples"].shape == (30, D) and int(new_t["step"]) == 0


def test_check_obj_state_raises_as_jax_does():
    """A state whose degeneracy flag is down raises the JAX package's
    ValueError; a healthy one passes; a stateless objective's check is a
    no-op."""
    (obj_j, _), (obj_t, _) = _pair()
    bad_j = {**obj_j.init_obj_state(jnp.zeros(D + D * D)), "ok": jnp.asarray(False)}
    bad_t = {**obj_t.init_obj_state(torch.zeros(D + D * D, dtype=torch.float64)),
             "ok": torch.tensor(False)}
    messages = []
    for obj, bad in ((obj_j, bad_j), (obj_t, bad_t)):
        with pytest.raises(ValueError) as err:
            obj.check_obj_state(bad)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "Non-finite importance weights" in messages[1]
    obj_t.check_obj_state(obj_t.init_obj_state(torch.zeros(D + D * D,
                                                           dtype=torch.float64)))
    kl = vt.ExclusiveKL(vt.MFGaussian(D, **F64), obj_t.model, 4)
    assert kl.init_obj_state(torch.zeros(2 * D, dtype=torch.float64)) == {}
    kl.check_obj_state({})


@pytest.mark.parametrize("use_resampling", [True, False])
def test_degenerate_weights_raise_at_the_end_of_optimize(use_resampling):
    """A log density that overflows makes the weights non-finite; in both
    modes the run records it and raises at the end, as in the JAX
    package (tests/test_objectives.py::test_DIS_degenerate_weights_raise)."""
    def model(s):
        return torch.exp(1e4 * torch.sum(s**2, dim=-1))

    approx = vt.MFGaussian(2, **F64)
    obj = vt.DISInclusiveKL(approx, model, 50, ess_target=25,
                            temper_prior=vt.MFGaussian(2, **F64),
                            temper_prior_params=np.zeros(4),
                            use_resampling=use_resampling)
    with pytest.raises(ValueError, match="Non-finite importance weights"):
        vt.RMSProp(0.1).optimize(5, obj, torch.zeros(4, dtype=torch.float64),
                                 generator=torch.Generator().manual_seed(0))


def test_direct_calls_mirror_the_state():
    """value_and_grad keeps the state on the object (initialised on the
    first call, checked every call) and forgets it when the sample count
    changes."""
    (_, _), (obj_t, _) = _pair()
    vp = torch.as_tensor(_start())
    obj_t.value_and_grad(vp, None)
    obj_t.value_and_grad(vp, None)
    assert int(obj_t._obj_state["step"]) == 2
    obj_t.set_num_mc_samples(10)
    assert obj_t._obj_state is None
    obj_t.value_and_grad(vp, None)
    assert obj_t._obj_state["samples"].shape == (10, D)


class ValueAndGradOnly:
    """An objective with nothing of the protocol but value_and_grad and
    update, as the JAX package's duck typing allows."""

    def __init__(self):
        self.calls = 0

    def value_and_grad(self, vp, generator):
        self.calls += 1
        return 0.5 * torch.sum(vp * vp), vp.clone()

    def update(self, vp, direction):
        return vp - direction


def test_objectives_without_the_protocol_still_run():
    obj = ValueAndGradOnly()
    res = vt.RMSProp(0.1).optimize(30, obj, torch.ones(3, dtype=torch.float64))
    assert obj.calls == 30 and res["value_history"].shape == (30,)
