"""A Bayesian neural-network classifier with synthetic data (the zoo's
model): the posterior over every weight and bias of a ReLU multilayer
perceptron with a softmax output (Blundell, Cornebise, Kavukcuoglu and
Wierstra, "Weight Uncertainty in Neural Networks", ICML 2015,
arXiv:1505.05424, section 5.1).

Layers ``(m_l, n_l)`` run ``in_dim -> hidden... -> classes``; ``theta``
holds, layer by layer, ``W_l`` (``m_l * n_l``, row-major) then ``b_l``.
With ``h_0 = x``, ``h_l = relu(h_{l-1} W_l / sqrt(m_l) + b_l)`` for the
hidden layers and the logits ``f = h_{L-1} W_L / sqrt(m_L) + b_L``;

    log p(y | theta) = sum_i log_softmax(f_i)[y_i],
    log p(theta) = sum_j log N(theta_j; 0, 1).

The data are drawn from ``numpy.random.RandomState(seed)`` in this order:
``x = rand(n_data, in_dim)``, the teacher ``theta* = randn(d)``, then
``u = rand(n_data)`` and ``y_i`` the number of classes ``k`` whose
cumulative softmax probability at the teacher is below ``u_i`` (at most
``classes - 1``). The data are kept in float64 and cast to the
reference's dtype. Draws are taken in blocks, each block's networks as
batched products with every draw's own weights. Matrix products run at
the precision the caller set: float64 for the check (TF32 never touches
a float64 product), TF32 in float32 where the control asks for it.
"""

import math

import numpy as np
import torch

_BLOCK = 100


def layers(in_dim, hidden, classes):
    widths = [int(in_dim), *(int(h) for h in hidden), int(classes)]
    return list(zip(widths[:-1], widths[1:]))


def dimension(in_dim, hidden, classes):
    return sum(m * n + n for m, n in layers(in_dim, hidden, classes))


def _teacher_logits(theta, x, shapes):
    h, at = x, 0
    for i, (m, n) in enumerate(shapes):
        W = theta[at:at + m * n].reshape(m, n)
        b = theta[at + m * n:at + m * n + n]
        at += m * n + n
        h = (h @ W) / math.sqrt(m) + b
        if i + 1 < len(shapes):
            h = np.maximum(h, 0.0)
    return h


def data(n_data, in_dim, hidden, classes, seed):
    shapes = layers(in_dim, hidden, classes)
    rng = np.random.RandomState(seed)
    x = rng.rand(n_data, int(in_dim))
    teacher = rng.randn(dimension(in_dim, hidden, classes))
    f = _teacher_logits(teacher, x, shapes)
    e = np.exp(f - np.max(f, axis=1, keepdims=True))
    cdf = np.cumsum(e / np.sum(e, axis=1, keepdims=True), axis=1)
    u = rng.rand(n_data)
    y = np.minimum(np.sum(cdf < u[:, None], axis=1), int(classes) - 1)
    return x, y


def build(n_data, in_dim, hidden, classes, data_seed, dtype, device):
    shapes = layers(in_dim, hidden, classes)
    d = dimension(in_dim, hidden, classes)
    x_np, y_np = data(n_data, in_dim, hidden, classes, data_seed)
    x = torch.as_tensor(x_np, dtype=dtype, device=device)
    y = torch.as_tensor(y_np, dtype=torch.long, device=device)
    log_norm = 0.5 * d * math.log(2.0 * math.pi)

    def block(theta):
        B, h, at = theta.shape[0], x, 0
        for i, (m, n) in enumerate(shapes):
            W = theta[:, at:at + m * n].reshape(B, m, n)
            b = theta[:, at + m * n:at + m * n + n]
            at += m * n + n
            h = torch.matmul(h, W) / math.sqrt(m) + b[:, None, :]
            if i + 1 < len(shapes):
                h = torch.relu(h)
        logp = torch.log_softmax(h, dim=2)
        loglik = torch.sum(torch.gather(logp, 2, y.expand(B, -1)[:, :, None]), dim=(1, 2))
        return loglik - 0.5 * torch.sum(theta * theta, dim=1) - log_norm

    def log_density(theta):
        return torch.cat([block(theta[s:s + _BLOCK]) for s in range(0, theta.shape[0], _BLOCK)])

    return log_density
