"""The int8 COMPUTE path: int8 x int8 -> int32 matmuls and convolutions
(the JAX package's ``quantization/int8_compute.py``).

``Int8ComputeLinear`` keeps its weight in int8 with a per-out-channel
scale and quantizes the activation per tensor (the calibrated PTQ scale
when there is one, the dynamic absmax otherwise), so the product itself
runs int8 x int8 with int32 accumulation, rescaled once. The JAX module
computes the product with XLA (``lax.dot_general`` /
``lax.conv_general_dilated`` with ``preferred_element_type=int32``);
here it is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card), and the
convolution is an exact im2col into it: the int8 values are unfolded as
fp32, which holds them exactly, and cast back. Integer sums are exact,
so the int32 accumulators equal the JAX package's bit for bit.

``convert_to_int8_compute`` walks a model (plain, or ``PTQ.convert``
output) and swaps its Linear and Conv2D layers in place.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..core.tensor import plain
from ..nn.functional.conv import _pads, _tuple
from ..nn.layers_common import Conv2D, Linear
from .fake_quant import quantize_int8

__all__ = ["Int8ComputeLinear", "Int8ComputeConv2D",
           "convert_to_int8_compute", "int8_matmul"]

# What torch._int_mm took on an H100 (torch 2.11, CUDA 12.8): a left
# operand of more than 16 rows and inner and column counts that are
# multiples of 8 (PyTorch's own checks refuse the rest), and at 17 rows a
# column-major right operand only (cuBLASLt returned NOT_SUPPORTED for a
# row-major one). Zero padding leaves the live rows' and columns' int32
# sums unchanged.
_CUDA_MIN_ROWS = 17
_CUDA_ALIGN = 8


def _pad_to(t, dim, size):
    if t.shape[dim] == size:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
    return TF.pad(t, pad)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> exact int32 [M, N] in one
    ``torch._int_mm``. On CUDA the operands are zero-padded to the
    shapes the card takes (see ``_CUDA_MIN_ROWS``) and the right one is
    passed column-major; the result is sliced back. Nothing falls back:
    a refusal raises."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    kp = -(-k // _CUDA_ALIGN) * _CUDA_ALIGN
    np_ = -(-n // _CUDA_ALIGN) * _CUDA_ALIGN
    mp = max(m, _CUDA_MIN_ROWS)
    a = _pad_to(_pad_to(a, 1, kp), 0, mp).contiguous()
    b = _pad_to(_pad_to(b, 0, kp), 1, np_)
    b = b.t().contiguous().t()
    return torch._int_mm(a, b)[:m, :n]


def _quantize_activation(xr, act_scale: Optional[float]):
    """Per-tensor activation quantization of the fp32 ``xr``: the
    calibrated PTQ scale when present, the dynamic absmax otherwise.
    Returns (int8 values, fp32 scale)."""
    if act_scale is not None:
        sx = torch.tensor(act_scale, dtype=torch.float32,
                          device=xr.device) / 127.0
    else:
        sx = xr.abs().max() / 127.0
        sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    qx = torch.clamp(torch.round(xr / sx), -127, 127).to(torch.int8)
    return qx, sx


def _restore_dtype(out, x):
    return out.to(x.dtype) if x.is_floating_point() else out


class Int8ComputeLinear(nn.Module):
    """Linear whose product runs int8 x int8 -> int32.

    Buffers: ``weight_int8`` [in, out] int8, ``weight_scale`` [1, out]
    (``absmax / 127`` per out channel, so w ~ q * weight_scale) and
    ``bias``, under the JAX module's names and shapes."""

    def __init__(self, weight_int8, w_scale, bias=None,
                 act_scale: Optional[float] = None):
        super().__init__()
        self.register_buffer("weight_int8",
                             torch.as_tensor(weight_int8).to(torch.int8))
        self.register_buffer("weight_scale",
                             torch.as_tensor(w_scale).to(torch.float32)
                             / 127.0)
        if bias is not None:
            self.register_buffer("bias", torch.as_tensor(bias).detach()
                                 .clone())
        else:
            self.bias = None
        self._act_scale = None if act_scale is None else float(act_scale)

    @classmethod
    def from_linear(cls, lin: Linear, act_scale=None):
        q, s = quantize_int8(lin.weight, axis=1)
        return cls(q, s, None if lin.bias is None else
                   plain(lin.bias).detach(),
                   act_scale)

    def accumulate(self, x):
        """The int8 activation, its scale and the exact int32 product
        (the accumulators the JAX ``dot_general`` gives)."""
        xr = x.to(torch.float32)
        qx, sx = _quantize_activation(xr, self._act_scale)
        acc = int8_matmul(qx.reshape(-1, qx.shape[-1]), self.weight_int8)
        return qx, sx, acc.reshape(*qx.shape[:-1], acc.shape[-1])

    def forward(self, x):
        _, sx, acc = self.accumulate(x)
        sw = self.weight_scale.to(torch.float32)
        out = acc.to(torch.float32) * (sx * sw)
        if self.bias is not None:
            out = out + self.bias.to(torch.float32)
        return _restore_dtype(out, x)


class Int8ComputeConv2D(nn.Module):
    """Conv2D whose convolution runs int8 x int8 -> int32 (im2col into
    ``int8_matmul``). Buffers: ``weight_int8`` [O, I / groups, kh, kw],
    ``weight_scale`` [O] (``absmax / 127``) and ``bias``."""

    def __init__(self, weight_int8, w_scale, bias, stride, padding,
                 dilation, groups, data_format,
                 act_scale: Optional[float] = None):
        super().__init__()
        self.register_buffer("weight_int8",
                             torch.as_tensor(weight_int8).to(torch.int8))
        self.register_buffer("weight_scale",
                             torch.as_tensor(w_scale).to(torch.float32)
                             / 127.0)
        if bias is not None:
            self.register_buffer("bias", torch.as_tensor(bias).detach()
                                 .clone())
        else:
            self.bias = None
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._act_scale = None if act_scale is None else float(act_scale)

    @classmethod
    def from_conv(cls, conv: Conv2D, act_scale=None):
        q, s = quantize_int8(conv.weight, axis=0)      # per out channel
        return cls(q, s.reshape(-1),
                   None if conv.bias is None else plain(conv.bias).detach(),
                   conv.stride, conv.padding, conv.dilation,
                   conv.groups, conv.data_format, act_scale)

    def accumulate(self, x):
        """(int8 activation, its scale, exact int32 accumulators in the
        layer's data format)."""
        xr = x.to(torch.float32)
        qx, sx = _quantize_activation(xr, self._act_scale)
        nhwc = self.data_format == "NHWC"
        q = qx.permute(0, 3, 1, 2) if nhwc else qx
        w = self.weight_int8
        o, cg, kh, kw = w.shape
        stride, dil = _tuple(self.stride, 2), _tuple(self.dilation, 2)
        (h_lo, h_hi), (w_lo, w_hi) = _pads(self.padding, (kh, kw), stride,
                                           dil, tuple(q.shape[2:]))
        # int8 values are exact in fp32: unfold there, cast back
        xf = TF.pad(q.to(torch.float32), (w_lo, w_hi, h_lo, h_hi))
        n, _, hp, wp = xf.shape
        oh = (hp - dil[0] * (kh - 1) - 1) // stride[0] + 1
        ow = (wp - dil[1] * (kw - 1) - 1) // stride[1] + 1
        cols = TF.unfold(xf, (kh, kw), dilation=dil, stride=stride)
        cols = cols.to(torch.int8)                     # [N, C*kh*kw, L]
        g = self.groups
        og, kk = o // g, cg * kh * kw
        outs = []
        for gi in range(g):
            a = cols[:, gi * kk:(gi + 1) * kk].transpose(1, 2) \
                .reshape(-1, kk)
            b = w[gi * og:(gi + 1) * og].reshape(og, kk).t()
            outs.append(int8_matmul(a, b).reshape(n, oh * ow, og))
        acc = torch.cat(outs, dim=2).transpose(1, 2).reshape(n, o, oh, ow)
        if nhwc:
            acc = acc.permute(0, 2, 3, 1)
        return qx, sx, acc.contiguous()

    def forward(self, x):
        _, sx, acc = self.accumulate(x)
        ch = (1, 1, 1, -1) if self.data_format == "NHWC" else (1, -1, 1, 1)
        sw = self.weight_scale.to(torch.float32)
        out = acc.to(torch.float32) * (sx * sw.reshape(ch))
        if self.bias is not None:
            out = out + self.bias.to(torch.float32).reshape(ch)
        return _restore_dtype(out, x)


def convert_to_int8_compute(model: nn.Module,
                            act_scales: Optional[Dict[str, float]] = None,
                            inplace: bool = True) -> nn.Module:
    """Swap Linear sublayers for Int8ComputeLinear and Conv2D for
    Int8ComputeConv2D. ``act_scales`` maps layer paths to calibrated
    activation scales (``PTQ.quant_info``'s ``act_scale`` entries);
    layers without one quantize dynamically. PTQ's frozen wrappers take
    their own calibrated scale."""
    from .ptq import _FrozenQuantConv2D, _FrozenQuantLinear
    if not inplace:
        model = copy.deepcopy(model)
    act_scales = act_scales or {}

    def walk(layer, prefix):
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            full = f"{prefix}{name}"
            if isinstance(sub, _FrozenQuantLinear):
                layer._modules[name] = Int8ComputeLinear.from_linear(
                    sub.inner, act_scale=sub.act_scale)
            elif isinstance(sub, _FrozenQuantConv2D):
                layer._modules[name] = Int8ComputeConv2D.from_conv(
                    sub.inner, act_scale=sub.act_scale)
            elif isinstance(sub, Linear):
                layer._modules[name] = Int8ComputeLinear.from_linear(
                    sub, act_scale=act_scales.get(full))
            elif type(sub) is Conv2D:
                layer._modules[name] = Int8ComputeConv2D.from_conv(
                    sub, act_scale=act_scales.get(full))
            else:
                walk(sub, full + ".")

    walk(model, "")
    return model
