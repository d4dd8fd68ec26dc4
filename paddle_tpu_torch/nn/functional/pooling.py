"""Pooling (the JAX package's ``nn/functional/pooling.py:25-73, 98-128``):
``max_pool2d`` and ``adaptive_avg_pool2d``, NCHW or NHWC."""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    """Max over windows, padding with -inf. With ``ceil_mode`` the high
    side gets the extra padding that rounds the output size up, as in
    the JAX package (every window counts, even one that starts in the
    padding, which PyTorch's own ceil_mode drops)."""
    channel_last = data_format == "NHWC"
    nchw = x.permute(0, 3, 1, 2) if channel_last else x
    ksize = _tuple(kernel_size, 2)
    stride = _tuple(stride if stride is not None else ksize, 2)
    pads = _tuple(padding, 2)
    highs = list(pads)
    if ceil_mode:
        for i, (size, k, s, p) in enumerate(zip(nchw.shape[2:], ksize,
                                                stride, pads)):
            out = -(-(size + 2 * p - k) // s) + 1
            highs[i] = p + max((out - 1) * s + k - (size + 2 * p), 0)
    if tuple(highs) == pads and all(2 * p <= k for p, k in zip(pads, ksize)):
        out = TF.max_pool2d(nchw, ksize, stride, pads)
    else:     # PyTorch pads symmetrically and at most half a window
        padded = TF.pad(nchw, (pads[1], highs[1], pads[0], highs[0]),
                        value=float("-inf"))
        out = TF.max_pool2d(padded, ksize, stride, 0)
    return out.permute(0, 2, 3, 1) if channel_last else out


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over adaptive windows, one spatial axis after the other:
    a whole axis for size 1, equal windows when the size divides, else
    windows [floor(i*in/out), ceil((i+1)*in/out))."""
    axes = (1, 2) if data_format == "NHWC" else (2, 3)
    out = x
    for ax, osz in zip(axes, _tuple(output_size, 2)):
        isz = out.shape[ax]
        if osz == 1:
            out = out.mean(dim=ax, keepdim=True)
        elif isz % osz == 0:
            shape = out.shape[:ax] + (osz, isz // osz) + out.shape[ax + 1:]
            out = out.reshape(shape).mean(dim=ax + 1)
        else:
            slices = [out.narrow(ax, (i * isz) // osz,
                                 max(1, -(-((i + 1) * isz) // osz)
                                     - (i * isz) // osz)).mean(dim=ax)
                      for i in range(osz)]
            out = torch.stack(slices, dim=ax)
    return out
