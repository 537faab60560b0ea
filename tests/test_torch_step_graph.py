"""FASO's steps replayed from CUDA graphs (``optimizers._GraphedStep``)
against the same steps run eagerly.

This file imports no JAX. Tests marked ``cuda`` capture real graphs and
skip without a card; on a machine with one, run them with

    python -m pytest tests/test_torch_step_graph.py --noconftest -q

On the CPU, every route that the rule leaves out is shown to choose the
eager loop, and the replay's bookkeeping (static buffers, the rule's host
counter, the learning rate, one graph a sample count, the carry handed
back) is rehearsed with a stand-in capture whose "replay" runs the
recorded step eagerly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import viabel_torch as vt  # noqa: E402
import viabel_torch.faso as tfaso  # noqa: E402
from viabel_torch import ops, optimizers  # noqa: E402
from viabel_torch.optimizers import _GraphedStep  # noqa: E402

D, N_DATA, K = 12, 64, 20


class EagerRMSProp(vt.RMSProp):
    """RMSProp that states nothing about replay, so its steps run eagerly:
    the reference of every comparison here."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests rehearse the bookkeeping")
    return torch.device("cuda")


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Graphs on the CPU: every route passes the rule, and a "capture"
    returns the recorded step itself, which each replay runs eagerly."""
    monkeypatch.setattr(tfaso, "graph_refusal", lambda *args: None)
    monkeypatch.setattr(_GraphedStep, "_record", lambda self, body: body)


def problem(device, dtype, dim=D, model=None):
    """The flagship's route at a small d: logistic regression, a full-rank
    Gaussian, the STL ExclusiveKL at S = 10."""
    base, _ = vt.zoo.logistic_regression(dim=dim, n_data=N_DATA, seed=3, device=device,
                                         dtype=dtype)
    approx = vt.FullRankGaussian(dim, device=device, dtype=dtype)
    objective = vt.ExclusiveKL(approx, model(base) if model else base, 10,
                               use_path_deriv=True)
    return objective, approx.init_param()


def fit(sgo_class, device, dtype, model=None, keep=None):
    """FASO over three segments of ``K`` steps: S escalates from 10 to 40
    after the first, and the third runs on in a second call from the
    first's resume state at half the learning rate. ``keep(res)`` sees the
    first call's results before the second call runs."""
    objective, init = problem(device, dtype, model=model)
    gen = torch.Generator(device).manual_seed(11)
    faso = vt.FASO(sgo_class(0.01), W_min=K, k_check=K, max_history=4 * K)

    def escalate(k, loss):
        if k == K:
            objective.num_mc_samples = 40

    ops.reset_launch_counts()
    first = faso.optimize(2 * K, objective, init, generator=gen, progress_callback=escalate)
    if keep is not None:
        keep(first)
    second = faso.optimize(3 * K, objective, init, generator=gen, learning_rate=0.005,
                           resume_state=first["resume_state"])
    return {"first": first, "second": second, "generator": gen.get_state(),
            "launches": ops.launch_counts(), "graphed": faso._graphed}


def assert_same_run(got, ref):
    for call in ("first", "second"):
        g, r = got[call], ref[call]
        assert torch.equal(g["value_history"], r["value_history"])
        assert torch.equal(g["opt_param"], r["opt_param"])
        gs, rs = g["resume_state"], r["resume_state"]
        for key in ("var_param", "ring"):
            assert torch.equal(gs[key], rs[key]), key
        assert torch.equal(gs["opt_state"]["avg_grad_sq"], rs["opt_state"]["avg_grad_sq"])
        assert gs["opt_state"]["t"] == rs["opt_state"]["t"]
        assert torch.equal(gs["generator_state"], rs["generator_state"])
    assert torch.equal(got["generator"], ref["generator"])
    assert got["launches"] == ref["launches"]


#: replays over the three segments: two warm-up steps at S = 10 and two at
#: S = 40, every other step replayed
REPLAYS = 3 * K - 4


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graphed_faso_equals_eager_bit_for_bit(cuda, dtype):
    ref = fit(EagerRMSProp, cuda, dtype)
    got = fit(vt.RMSProp, cuda, dtype)
    assert ref["graphed"] is None
    assert got["graphed"].replays == REPLAYS and sorted(got["graphed"].graphs) == [10, 40]
    assert got["launches"]["stl_transpose_solve"] == 3 * K
    assert_same_run(got, ref)


@pytest.mark.cuda
def test_returned_carry_is_not_changed_by_later_replays(cuda):
    held = {}

    def keep(res):
        held["res"] = res
        held["copies"] = [t.clone() for t in carry(res)]

    fit(vt.RMSProp, cuda, torch.float32, keep=keep)
    for kept, copy in zip(carry(held["res"]), held["copies"]):
        assert torch.equal(kept, copy)


@pytest.mark.cuda
def test_host_reading_model_falls_back_to_eager(cuda):
    def reads_back(base):
        def model(x):
            if not float(x.detach().sum()) < float("inf"):  # a read on the host
                raise ValueError("a draw that is not finite")
            return base(x)
        return model

    ref = fit(EagerRMSProp, cuda, torch.float32, model=reads_back)
    got = fit(vt.RMSProp, cuda, torch.float32, model=reads_back)
    assert got["graphed"].failed and got["graphed"].replays == 0
    assert_same_run(got, ref)
    torch.randn(3, device=cuda)  # the default generator draws too


# -- on the CPU: the rehearsal ------------------------------------------------

def carry(res):
    """What a run hands back that a later replay could overwrite if it
    were a static buffer."""
    rs = res["resume_state"]
    return [rs["var_param"], rs["opt_state"]["avg_grad_sq"], res["opt_param"],
            res["opt_state"]["avg_grad_sq"]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rehearsed_replays_equal_eager_steps(dtype, request):
    ref = fit(EagerRMSProp, "cpu", dtype)
    request.getfixturevalue("stand_in_capture")
    got = fit(vt.RMSProp, "cpu", dtype)
    assert got["graphed"].replays == REPLAYS and sorted(got["graphed"].graphs) == [10, 40]
    assert_same_run(got, ref)


def test_rehearsed_carry_is_a_copy(stand_in_capture):
    held = {}

    def keep(res):
        held["res"] = res
        held["copies"] = [t.clone() for t in carry(res)]

    out = fit(vt.RMSProp, "cpu", torch.float64, keep=keep)
    static = out["graphed"].var_param
    for kept, copy in zip(carry(held["res"]), held["copies"]):
        assert kept.data_ptr() != static.data_ptr()
        assert torch.equal(kept, copy)


def test_a_failed_capture_leaves_the_run_eager(monkeypatch):
    ref = fit(EagerRMSProp, "cpu", torch.float64)
    monkeypatch.setattr(tfaso, "graph_refusal", lambda *args: None)
    monkeypatch.setattr(_GraphedStep, "_record", lambda self, body: None)
    got = fit(vt.RMSProp, "cpu", torch.float64)
    assert got["graphed"].failed and got["graphed"].replays == 0
    assert_same_run(got, ref)


def test_a_fresh_rule_state_steps_eagerly_first(stand_in_capture):
    """A graph records a step past the rule's first: a carry at the first
    step (RMSProp's t = 0, the seeding step) runs eagerly even where the
    graph of its sample count exists."""
    objective, init = problem("cpu", torch.float64)
    gen = torch.Generator()
    faso = vt.FASO(vt.RMSProp(0.01), W_min=K, k_check=K, max_history=4 * K)
    runs = [faso.optimize(K, objective, init, generator=gen.manual_seed(5)) for _ in range(2)]
    assert faso._graphed.replays == 2 * K - 3  # two warm-up steps, then one first step
    ref = vt.FASO(EagerRMSProp(0.01), W_min=K, k_check=K, max_history=4 * K).optimize(
        K, objective, init, generator=torch.Generator().manual_seed(5))
    for res in runs:
        assert torch.equal(res["value_history"], ref["value_history"])
        assert torch.equal(res["resume_state"]["var_param"], ref["resume_state"]["var_param"])


# -- on the CPU: the routes the rule leaves out ------------------------------

def _route(name):
    """``(FASO, objective, init)`` of the flagship route changed in one
    respect, on the CPU in float64."""
    f64 = dict(device="cpu", dtype=torch.float64)
    model, _ = vt.zoo.logistic_regression(dim=4, n_data=N_DATA, seed=3, **f64)
    approx = vt.FullRankGaussian(4, **f64)
    sgo_class, fkw = vt.RMSProp, {}
    objective = vt.ExclusiveKL(approx, model, 10, use_path_deriv=True)
    if name == "diagnostics":
        sgo = vt.RMSProp(0.01, diagnostics=True)
    elif name == "averaged_rule":
        sgo_class = vt.AveragedRMSProp
    elif name == "mesh":
        fkw["mesh"] = object()
    elif name == "estimator_state":
        objective = vt.DISInclusiveKL(approx, model, 20, ess_target=10,
                                      temper_prior=vt.MFGaussian(4, **f64),
                                      temper_prior_params=np.zeros(8))
    elif name == "hessian":
        approx = vt.MFGaussian(4, **f64)
        objective = vt.ExclusiveKL(approx, model, 10, hessian_approx_method="mean_only")
    elif name == "base_sampler":
        approx = vt.FullRankGaussian(4, base_sampler=vt.AntitheticNormal(), **f64)
        objective = vt.ExclusiveKL(approx, model, 10, use_path_deriv=True)
    elif name == "subsampled":
        X = torch.randn(N_DATA, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(2))

        def log_lik(beta, X):
            return -0.5 * torch.sum((beta @ X.T) ** 2, dim=-1)

        model = vt.SubsampledModel(lambda beta: -0.5 * torch.sum(beta**2, dim=-1), log_lik,
                                   X, 16)
        objective = vt.ExclusiveKL(approx, model, 10, use_path_deriv=True)
    elif name == "unstated_objective":
        objective = UnstatedKL(approx, model, 10, use_path_deriv=True)
    elif name == "tempered":
        objective = vt.ExclusiveKL(approx, vt.TemperedModel(model, 0.5), 10,
                                   use_path_deriv=True)
    elif name == "standardized_tempered":
        std_model, _, _ = vt.pilot_standardize(4, vt.TemperedModel(model, 0.5), n_iters=20,
                                               device="cpu", dtype=torch.float64)
        objective = vt.ExclusiveKL(approx, std_model, 10, use_path_deriv=True)
    if name != "diagnostics":
        sgo = sgo_class(0.01)
    faso = vt.FASO(sgo, W_min=K, k_check=K, max_history=4 * K, **fkw)
    return faso, objective, objective.approx.init_param()


class UnstatedKL(vt.ExclusiveKL):
    """An objective that states nothing about replay, as a new subclass
    with host code of its own would."""


REFUSED = {
    "cpu": "CUDA device",
    "diagnostics": "diagnostics mode",
    "mesh": "split over a mesh",
    "estimator_state": "estimator state",
    "averaged_rule": "AveragedRMSProp",
    "hessian": "hessian_approx_method",
    "base_sampler": "base_sampler",
    "subsampled": "SubsampledModel",
    "unstated_objective": "UnstatedKL",
    "tempered": "TemperedModel",
    "standardized_tempered": "TransformedModel",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_rule_names_why_a_route_stays_eager(name):
    faso, objective, init = _route(name)
    obj_state = optimizers._obj_init_state(objective, init)
    reason = optimizers.graph_refusal(faso._sgo, objective, init, obj_state, faso._mesh)
    assert reason is not None and REFUSED[name] in reason
    assert faso._graphed_step(objective, init, obj_state, torch.Generator()) is None


def _segment_as_before(self, objective, var_param, opt_state, obj_state, generator,
                       ring, t, lr, steps, diagnostics, cols=slice(None)):
    """``FASO._run_segment`` as it was before graphs: the eager loop."""
    R = ring.shape[0]
    values, grads, dirs = [], [], []
    for _ in range(steps):
        var_param, opt_state, obj_state, value, direction, grad = self._sgo.step(
            objective, var_param, opt_state, obj_state, generator, lr)
        ring[t % R] = var_param[cols]
        t += 1
        values.append(value)
        if diagnostics:
            grads.append(grad)
            dirs.append(direction)
    outs = (torch.stack(values),)
    if diagnostics:
        outs += (torch.stack(grads).cpu().numpy(), torch.stack(dirs).cpu().numpy())
    return var_param, opt_state, obj_state, t, outs


@pytest.mark.parametrize("name", sorted(set(REFUSED) - {"mesh"}))
def test_routes_left_out_run_the_eager_loop_unchanged(name, monkeypatch):
    def run():
        faso, objective, init = _route(name)
        return faso.optimize(2 * K, objective, init, generator=torch.Generator().manual_seed(7))

    ref = run()
    with monkeypatch.context() as m:
        m.setattr(tfaso.FASO, "_run_segment", _segment_as_before)
        before = run()

    def no_helper(*args, **kwargs):
        raise AssertionError("a route the rule leaves out built a graph helper")

    monkeypatch.setattr(_GraphedStep, "__init__", no_helper)
    got = run()
    for res in (ref, got):
        assert torch.equal(res["value_history"], before["value_history"])
        assert torch.equal(res["resume_state"]["var_param"],
                           before["resume_state"]["var_param"])


def test_the_objects_a_duck_typed_objective_holds_are_not_asked():
    """An objective outside the objective classes states nothing, so its
    steps stay eager whatever it holds."""
    _, objective, init = _route("cpu")

    class Wrapper:
        def __init__(self, inner):
            self.approx, self.model = inner.approx, inner.model
            self.value_and_grad, self.update = inner.value_and_grad, inner.update

    reason = optimizers.graph_refusal(vt.RMSProp(0.01), Wrapper(objective), init, {})
    assert "Wrapper states nothing" in reason


@pytest.mark.parametrize("kind", ["objective", "family", "model"])
def test_every_part_states_whether_it_replays(kind):
    from viabel_torch.external import CModel
    from viabel_torch.parallel.sharded import ShardedExclusiveKL
    from viabel_torch.transforms import TransformedModel
    classes = {
        "objective": {vt.ExclusiveKL: True, vt.IWELBO: True, vt.AlphaDivergence: True,
                      vt.DISInclusiveKL: False, ShardedExclusiveKL: False, UnstatedKL: False},
        "family": {vt.MFGaussian: True, vt.MFStudentT: True, vt.FullRankGaussian: True,
                   vt.MultivariateT: True, vt.LRGaussian: True, vt.NeuralNet: True,
                   vt.NVPFlow: True},
        "model": {vt.Model: True, TransformedModel: True, vt.TemperedModel: False,
                  vt.SubsampledModel: False, CModel: False},
    }[kind]
    assert {cls: cls.graph_safe for cls in classes} == classes


def test_a_family_with_a_sampler_under_a_flow_is_refused():
    f64 = dict(device="cpu", dtype=torch.float64)
    prior = vt.MFGaussian(4, base_sampler=vt.AntitheticNormal(), **f64)
    flow = vt.NVPFlow([[2, 8], [8, 2]], [[2, 8], [8, 2]], torch.tensor([[1., 1, 0, 0]]),
                      prior, torch.zeros(8, dtype=torch.float64), 4)
    assert "base_sampler" in flow.graph_refusal()
    assert vt.NVPFlow([[2, 8], [8, 2]], [[2, 8], [8, 2]], torch.tensor([[1., 1, 0, 0]]),
                      vt.MFGaussian(4, **f64), torch.zeros(8, dtype=torch.float64),
                      4).graph_refusal() is None


def test_every_rule_states_whether_it_replays():
    safe = {cls.__name__: cls.graph_safe for cls in (
        vt.StochasticGradientOptimizer, vt.RMSProp, vt.AveragedRMSProp, vt.Adam,
        vt.AveragedAdam, vt.Adagrad, vt.WindowedAdagrad, EagerRMSProp)}
    assert safe == {"StochasticGradientOptimizer": True, "RMSProp": True,
                    "AveragedRMSProp": False, "Adam": False, "AveragedAdam": False,
                    "Adagrad": False, "WindowedAdagrad": False, "EagerRMSProp": False}
