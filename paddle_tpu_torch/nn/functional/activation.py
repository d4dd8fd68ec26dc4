"""Activations (the JAX package's ``nn/functional/activation.py``): the
27 ops it registers, from ``relu`` through ``maxout``, each on plain
torch tensors (a ``Tensor`` in gives a ``Tensor`` out through torch's
own dispatch). ``nn/functional/__init__.py`` registers them in the op
registry under the JAX names; the registry's wrappers dispatch, these
functions do not. Formulas follow the JAX ones where torch's built-in
differs in a parameter (``selu``'s scale and alpha, ``hardsigmoid``'s
slope and offset, ``prelu``'s channel axis). ``gumbel_softmax`` draws
its noise from the device's seeded generator (or ``generator``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import random as random_mod

__all__ = [
    "relu", "relu6", "sigmoid", "log_sigmoid", "tanh", "tanh_act", "silu",
    "swish", "mish", "gelu", "elu", "selu", "celu", "leaky_relu", "prelu",
    "hardtanh", "hardshrink", "softshrink", "hardsigmoid", "hardswish",
    "softplus", "softsign", "tanhshrink", "thresholded_relu", "softmax",
    "log_softmax", "gumbel_softmax", "glu", "maxout",
]


def relu(x):
    return torch.relu(x)


def relu6(x):
    return TF.relu6(x)


def sigmoid(x):
    return torch.sigmoid(x)


def log_sigmoid(x):
    return TF.logsigmoid(x)


def tanh(x):
    return torch.tanh(x)


tanh_act = tanh


def silu(x):
    return TF.silu(x)


swish = silu


def mish(x):
    return x * torch.tanh(TF.softplus(x))


def gelu(x, approximate=False):
    """``approximate=True`` is the tanh form, ``jax.nn.gelu``'s."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def elu(x, alpha=1.0):
    return TF.elu(x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return TF.celu(x, alpha=alpha)


def leaky_relu(x, negative_slope=0.01):
    return TF.leaky_relu(x, negative_slope)


def _prelu_broadcast(w, x, data_format):
    n = torch.numel(w)
    if n == 1 or x.dim() <= 1:
        return torch.reshape(w, ()) if n == 1 else w
    shape = [1] * x.dim()
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    shape[ch_axis] = n
    return torch.reshape(w, shape)


def prelu(x, weight, data_format="NCHW"):
    """``weight`` of one value, or one per channel (axis 1 for NC*
    layouts, the last for N*C)."""
    return torch.where(x > 0, x, _prelu_broadcast(weight, x, data_format)
                       * x)


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def softplus(x, beta=1.0, threshold=20.0):
    return TF.softplus(x, beta=beta, threshold=threshold)


def softsign(x):
    return x / (1.0 + x.abs())


def tanhshrink(x):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1,
                   generator=None):
    """softmax((x + g) / temperature) with Gumbel noise g = -log(-log(u
    + 1e-20) + 1e-20), u uniform; ``hard`` gives the one-hot argmax in
    the forward and the soft gradient (straight through)."""
    gen = generator if generator is not None \
        else random_mod.generator(x.device)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    c = x.shape[axis]
    new_shape = tuple(x.shape[:axis]) + (c // groups, groups) + \
        tuple(x.shape[axis + 1:])
    return torch.amax(x.reshape(new_shape), dim=axis + 1)
