"""Operations and bytes of one sticking-the-landing step of a RealNVP flow
(``reference/family_RealNVP.py``) on Bayesian logistic regression, counted
from the shapes whatever implements them (``roofline.py``'s yardstick).

A coupling runs a ``t`` and an ``s`` net of layers ``(m, n)``. At S draws
a layer's forward product is ``(S, m) x (m, n)``: ``2 S m n`` operations.
The step needs four passes through the ``2 K`` nets:

- ``g`` forward (the draws);
- ``g``'s weight gradients;
- ``g``'s input gradients, but for the first coupling's first layers,
  whose input (the masked base normals) carries none;
- ``f``'s input gradients: log q of the draws at parameters held fixed,
  taken back to the draws (no weight gradient).

``f``'s forward pass runs, at parameters held fixed and on the same
inputs, the products that ``g``'s forward has just run, so it is not
counted: a step that skips it does less of what the step does not need.

A product's bytes are its two inputs read once and its output written
once.
"""

from . import roofline

_SIZE = {"float32": 4, "float64": 8}


def layer_shapes(d, hidden):
    widths = [int(d), *(int(h) for h in hidden), int(d)]
    return list(zip(widths[:-1], widths[1:]))


def var_param_dim(d, n_couplings, hidden):
    return 2 * int(n_couplings) * sum(m * n + n for m, n in layer_shapes(d, hidden))


def matmuls(S, d, n_couplings, hidden):
    """Every matrix product of a step as ``(rows, inner, cols)``: an
    ``(rows, inner) x (inner, cols)`` product."""
    S = int(S)
    shapes = layer_shapes(d, hidden)
    nets = 2 * int(n_couplings)
    out = []
    for net in range(nets):
        for idx, (m, n) in enumerate(shapes):
            forward = (S, m, n)
            weight_grad = (m, S, n)
            input_grad = (S, n, m)
            out += [forward, weight_grad, input_grad]  # g: forward, weight grad; f: input grad
            # g's input grad, but for the first coupling's first layers, which read
            # the base normals
            if not (net < 2 and idx == 0):
                out.append(input_grad)
    return out


def matmul_flops(S, d, n_couplings, hidden):
    """The flow's matrix-product operations in one step at S draws."""
    return sum(2 * r * k * c for r, k, c in matmuls(S, d, n_couplings, hidden))


def matmul_bound_s(S, d, n_couplings, hidden, dtype):
    """The least device time of the flow's matrix products in one step at S
    draws: each product bound by the larger of its bytes and its
    operations."""
    size = _SIZE[dtype]
    return sum(roofline.bound_s((r * k + k * c + r * c) * size, 2 * r * k * c, dtype)
               for r, k, c in matmuls(S, d, n_couplings, hidden))


def model_matmul_bound_s(S, d, n, dtype):
    """The least device time of the logistic model's two products at S
    draws: the ``(S, d) x (d, n)`` logits and the ``(S, n) x (n, d)``
    gradient back to the draws."""
    size = _SIZE[dtype]
    return sum(roofline.bound_s((r * k + k * c + r * c) * size, 2 * r * k * c, dtype)
               for r, k, c in ((S, d, n), (S, n, d)))


def step_flops(S, d, n, n_couplings, hidden):
    """One step: the flow's products, the model and its gradient
    (``roofline.logistic_regression_flops``) and RMSProp at six operations
    a parameter."""
    return (matmul_flops(S, d, n_couplings, hidden) + roofline.logistic_regression_flops(S, d, n)
            + 6 * var_param_dim(d, n_couplings, hidden))
