"""Fake-quant primitives with straight-through gradients, and real int8
quantization (the JAX package's ``quantization/fake_quant.py``).

``fake_quant`` and ``fake_quant_channelwise`` quantize and dequantize in
the input's dtype; their gradient passes inside the representable range
and is zero outside it (the straight-through estimator of the
reference's fake_quantize ops). The JAX package reaches them through its
op registry; here they are called directly (the registry is ROADMAP A2).
``quantize_int8`` / ``dequantize_int8`` give the JAX functions' bits on
fp32 inputs: the same IEEE operations in the same order, and both
frameworks round half to even.
"""
from __future__ import annotations

import torch

from ..core.tensor import plain

__all__ = ["fake_quant", "fake_quant_channelwise", "quantize_int8",
           "dequantize_int8"]


class _FakeQuant(torch.autograd.Function):
    """q = clip(round(x / s * qmax), -qmax, qmax); y = q * s / qmax with
    s = max(scale, 1e-8). Backward: the gradient where |x| <= s, zero
    elsewhere; none for the scale (a constant or a detached absmax)."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        s = torch.clamp_min(scale, 1e-8)
        ctx.save_for_backward(x, s)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        return q * s / qmax

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (x.abs() <= s).to(g.dtype), None, None


def _scale_tensor(scale, x):
    if isinstance(scale, torch.Tensor):
        return scale.detach().to(device=x.device, dtype=x.dtype)
    return torch.as_tensor(scale, dtype=x.dtype, device=x.device)


def fake_quant(x, scale=None, bits: int = 8):
    """Per-tensor quantize-dequantize. ``scale=None`` takes the dynamic
    absmax of ``x`` (no gradient flows through it)."""
    qmax = float(2 ** (bits - 1) - 1)
    x = plain(x)
    s = x.detach().abs().max() if scale is None else _scale_tensor(scale, x)
    return _FakeQuant.apply(x, s, qmax)


def fake_quant_channelwise(x, axis: int = 0, scale=None, bits: int = 8):
    x = plain(x)
    """Per-channel quantize-dequantize along ``axis`` (the channel dim).
    ``scale`` is one value per channel, or None for the dynamic per-
    channel absmax."""
    qmax = float(2 ** (bits - 1) - 1)
    if scale is None:
        red = tuple(i for i in range(x.dim()) if i != axis)
        s = x.detach().abs().amax(dim=red, keepdim=True)
    else:
        s = _scale_tensor(scale, x)
        if s.dim() == 1:
            shape = [1] * x.dim()
            shape[axis] = -1
            s = s.reshape(shape)
    return _FakeQuant.apply(x, s, qmax)


def quantize_int8(x, axis=None):
    """Real int8 quantization: (int8 values, scales in ``x``'s dtype).
    ``axis=None`` is per tensor; else per channel along ``axis``, the
    scales kept with the reduced dims as size 1. Dequantized,
    ``x ~ q * scale / 127``.

    ``x / scale * 127`` is rounded in fp32 whatever ``x``'s dtype, so q
    is the nearest step (the JAX function computes it in ``x``'s dtype:
    the same bits for fp32, but for bf16 a value can land one step off,
    ROADMAP C17)."""
    raw = plain(x).detach()
    if axis is None:
        scale = torch.clamp_min(raw.abs().max(), 1e-8)
    else:
        red = tuple(i for i in range(raw.dim()) if i != axis)
        scale = torch.clamp_min(raw.abs().amax(dim=red, keepdim=True), 1e-8)
    q = torch.clamp(torch.round(raw.float() / scale.float() * 127.0),
                    -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale / 127.0
