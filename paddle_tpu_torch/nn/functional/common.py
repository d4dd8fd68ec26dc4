"""``linear``, ``embedding``, ``pad`` and ``flatten`` (the JAX package's
``nn/functional/common.py:13, 22`` and ``ops/manipulation.py:30,
269``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp
from ...core import random as random_mod
from ...core.tensor import Tensor, plain_data
from ...kernels import row_linear as _row


def _data(t):
    return plain_data(t) if isinstance(t, Tensor) else t


def linear(x, weight, bias=None):
    """y = x @ weight + bias with Paddle's [in, out] ``weight``; inside a
    cached forward through the row-invariant ``row_linear``."""
    x, weight, bias = amp.maybe_cast("linear", x, weight, bias)
    if _row.routes(x, weight, bias):
        # no gradient is recorded on this route: the wrapper reads the
        # weights' plain data, whose attributes are torch's own
        return _row.row_linear(x, _data(weight), _data(bias))
    return TF.linear(x, torch.t(weight), bias)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at ``x``; positions where ``x == padding_idx``
    give zeros (and no gradient), as in the JAX package. ``sparse`` is
    accepted and changes nothing."""
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Dropout with its keep mask drawn from ``generator`` (default: the
    device's seeded one): over the whole shape, or over ``axis`` alone
    (the mask broadcast along the other axes). "upscale_in_train" scales
    the kept values by 1 / (1 - p); "downscale_in_infer" keeps them as
    they are. The identity outside training or at p = 0, as in the JAX
    package."""
    if not training or p == 0.0:
        return x
    gen = generator if generator is not None \
        else random_mod.generator(x.device)
    shape = x.shape
    if axis is not None:
        axes = {a % x.dim() for a in
                ([axis] if isinstance(axis, int) else axis)}
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.rand(shape, generator=gen, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", generator=None):
    """Whole channels dropped: the mask over (N, C)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training,
                   generator=generator)


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
