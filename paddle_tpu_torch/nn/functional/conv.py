"""Convolutions (the JAX package's ``nn/functional/conv.py:33-71``).

``conv2d`` takes NCHW or NHWC input with Paddle's ``[O, I/groups, kh,
kw]`` weight, an int, per-dim, per-side or 'SAME'/'VALID' padding,
stride, dilation and groups. The JAX package leaves the convolution to
XLA outside any Pallas kernel; here it is PyTorch's (cuDNN on a card).
NHWC goes through ``permute(0, 3, 1, 2)``, a channels-last view of
the same memory, so cuDNN runs it without a copy. PyTorch's convolution
takes symmetric padding only: per-side padding that is not symmetric
(the space-to-depth stem's ``[2, 1, 2, 1]``) is padded first.
"""
from __future__ import annotations

import torch.nn.functional as TF

from ... import amp


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _pads(padding, kernel, stride, dilation, sizes):
    """(low, high) padding of each spatial dim, as the JAX package reads
    ``padding``: an int, one per dim, one pair per dim flattened
    [h_lo, h_hi, w_lo, w_hi], or 'SAME' / 'VALID'."""
    nsp = len(kernel)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0)] * nsp
        if mode != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        pads = []
        for size, k, s, d in zip(sizes, kernel, stride, dilation):
            out = -(-size // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, int):
        return [(padding, padding)] * nsp
    padding = list(padding)
    if len(padding) == nsp:
        return [(p, p) for p in padding]
    if len(padding) == 2 * nsp:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nsp)]
    raise ValueError(f"bad padding {padding}")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    x, weight, bias = amp.maybe_cast("conv2d", x, weight, bias)
    nchw = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    stride, dilation = _tuple(stride, 2), _tuple(dilation, 2)
    pads = _pads(padding, tuple(weight.shape[2:]), stride, dilation,
                 tuple(nchw.shape[2:]))
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (h_lo, h_hi), (w_lo, w_hi) = pads
        nchw = TF.pad(nchw, (w_lo, w_hi, h_lo, h_hi))
        sym = (0, 0)
    out = TF.conv2d(nchw, weight, bias, stride, sym, dilation, groups)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
