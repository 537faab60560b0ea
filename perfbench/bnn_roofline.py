"""Operations and bytes of one sticking-the-landing step of a mean-field
Gaussian over a Bayesian neural-network classifier
(``reference/model_bnn_classifier.py``), counted from the shapes whatever
implements them (``roofline.py``'s yardstick).

At S draws every layer ``(m, k)`` runs S networks over the same ``n``
rows, a product ``(n, m) x (m, k)`` a draw with that draw's weights. The
step needs, a layer:

- the forward product ``h_{l-1} W_l``: ``2 S n m k`` operations; the
  first layer's input is the data, one ``(n, m)`` matrix that every draw
  shares;
- the weight gradient ``h_{l-1}^T G_l``, ``(m, n) x (n, k)`` a draw;
- the input gradient ``G_l W_l^T``, ``(n, k) x (k, m)`` a draw, but for
  the first layer, whose input (the data) carries none.

A product's bytes are its inputs read once and its output written once:
the shared data once for all draws, every other operand once a draw.
"""

from . import roofline

_SIZE = {"float32": 4, "float64": 8}


def layer_shapes(in_dim, hidden, classes):
    widths = [int(in_dim), *(int(h) for h in hidden), int(classes)]
    return list(zip(widths[:-1], widths[1:]))


def var_param_dim(in_dim, hidden, classes):
    """The mean-field family's parameters: a mean and a log scale a
    weight."""
    return 2 * sum(m * k + k for m, k in layer_shapes(in_dim, hidden, classes))


def matmuls(S, n, in_dim, hidden, classes):
    """Every matrix product of a step as ``(operations, elements read and
    written)``."""
    S, n = int(S), int(n)
    out = []
    for i, (m, k) in enumerate(layer_shapes(in_dim, hidden, classes)):
        inputs = n * m if i == 0 else S * n * m  # the data, or each draw's activations
        flops = 2 * S * n * m * k
        out.append((flops, inputs + S * m * k + S * n * k))  # forward
        out.append((flops, inputs + S * n * k + S * m * k))  # weight gradient
        if i > 0:
            out.append((flops, S * n * k + S * m * k + S * n * m))  # input gradient
    return out


def matmul_flops(S, n, in_dim, hidden, classes):
    """The network's matrix-product operations in one step at S draws."""
    return sum(f for f, _ in matmuls(S, n, in_dim, hidden, classes))


def matmul_bound_s(S, n, in_dim, hidden, classes, dtype):
    """The least device time of the network's products in one step at S
    draws: each product bound by the larger of its bytes and its
    operations."""
    size = _SIZE[dtype]
    return sum(roofline.bound_s(elems * size, flops, dtype)
               for flops, elems in matmuls(S, n, in_dim, hidden, classes))


def step_flops(S, n, in_dim, hidden, classes):
    """One step: the network's products and RMSProp at six operations a
    parameter."""
    return (matmul_flops(S, n, in_dim, hidden, classes)
            + 6 * var_param_dim(in_dim, hidden, classes))
