"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that breaks one thing in the program
while it is open. ``control.py`` reads them on the card and the tests on
the CPU.

- ``state_unchanged``: a step that returns its state unchanged (the step
  rule's update is dropped; loss and gradient are still computed).
- ``half_batch``: half of the batch left out, the mean taken over the
  rest: the objective draws and averages S // 2 samples; the front door
  keeps the first half of its draws.
- ``answer_altered``: an answer altered where it is produced, by 1%: the
  step's loss and FASO's R-hat statistic; the front door's khat.

One card holds the whole state, so no fault leaves an exchange between
cards out.
"""

from contextlib import contextmanager

ALTERATION = 1.01


@contextmanager
def _patched(owner, name, make):
    saved = getattr(owner, name)
    setattr(owner, name, make(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


@contextmanager
def state_unchanged():
    from viabel_torch.optimizers import StochasticGradientOptimizer

    def make(step):
        def wrapped(self, objective, var_param, *args, **kwargs):
            out = step(self, objective, var_param, *args, **kwargs)
            return (var_param,) + tuple(out[1:])
        return wrapped

    with _patched(StochasticGradientOptimizer, "step", make):
        yield


@contextmanager
def half_batch():
    from viabel_torch import convenience
    from viabel_torch.objectives import ExclusiveKL

    def make_loss(loss):
        def wrapped(self, var_param, generator, num_samples=None):
            return loss(self, var_param, generator,
                        max(1, (num_samples or self.num_mc_samples) // 2))
        return wrapped

    def make_weights(fn):
        def wrapped(var_param, model, approx, n_samples, generator):
            samples, log_weights = fn(var_param, model, approx, n_samples, generator)
            half = samples.shape[0] // 2
            return samples[:half], log_weights[:half]
        return wrapped

    with _patched(ExclusiveKL, "_loss", make_loss), \
            _patched(convenience, "samples_and_log_weights", make_weights):
        yield


@contextmanager
def answer_altered():
    from viabel_torch import convenience, faso
    from viabel_torch.objectives import ExclusiveKL

    def make_value(fn):
        def wrapped(self, var_param, generator):
            value, grad = fn(self, var_param, generator)
            return value * ALTERATION, grad
        return wrapped

    def make_rhat(fn):
        def wrapped(*args, **kwargs):
            return fn(*args, **kwargs) * ALTERATION
        return wrapped

    def make_psis(fn):
        def wrapped(log_weights, *args, **kwargs):
            smoothed, khat = fn(log_weights, *args, **kwargs)
            return smoothed, khat * ALTERATION
        return wrapped

    with _patched(ExclusiveKL, "value_and_grad", make_value), \
            _patched(faso, "split_rhat_ring_windows", make_rhat), \
            _patched(convenience, "psislw", make_psis):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
