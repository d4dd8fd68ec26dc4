"""``linear``, ``relu``, ``pad`` and ``flatten`` (the JAX package's
``nn/functional/common.py:13``, ``activation.py:12`` and
``ops/manipulation.py:30, 269``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...kernels import row_linear as _row


def linear(x, weight, bias=None):
    """y = x @ weight + bias with Paddle's [in, out] ``weight``; inside a
    cached forward through the row-invariant ``row_linear``."""
    x, weight, bias = amp.maybe_cast("linear", x, weight, bias)
    if _row.routes(x, weight, bias):
        return _row.row_linear(x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def relu(x):
    return torch.relu(x)


def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """Paddle's pad: ``2 * x.dim()`` entries pad every dim in order
    (dim0_lo, dim0_hi, dim1_lo, ...); fewer pad the spatial dims,
    innermost first ([w_lo, w_hi, h_lo, h_hi] for 2-D), which sit after
    the channels for NC* layouts and before them for N*C layouts. Modes
    'constant', 'reflect', 'replicate', 'circular'."""
    pad = list(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        nsp = len(pad) // 2
        widths = [(0, 0)] * nd
        first = 1 if data_format.endswith("C") else nd - nsp
        for i in range(nsp):
            widths[first + nsp - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    flat = [w for lo_hi in reversed(widths) for w in lo_hi]
    if mode == "constant":
        return TF.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    # PyTorch's other modes pad only the trailing dims: drop the
    # leading zero pairs
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    return TF.pad(x, flat, mode=mode)
