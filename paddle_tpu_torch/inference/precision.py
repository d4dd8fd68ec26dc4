"""Serving precision, shared by the Predictor's ``run()`` and the
``ServingEngine`` (the JAX package's ``inference/precision.py``):

- float32 / bf16 / fp16: the served module's float parameters and
  buffers cast once at build, float feeds cast per call;
- int8 weight-only (precision Int8): every Linear and Conv2D weight is
  stored as int8 with a per-channel scale (Linear per out channel, axis
  1 of Paddle's ``[in, out]`` layout; Conv2D on axis 0), the other
  floats in bf16;
- int4 weight-only (precision Int8 with ``enable_serving(weight_bits=
  4)``): Linear weights quantized to [-7, 7] and packed two values per
  stored int8 along the in-features axis, scales ``absmax / 7``; Conv2D
  weights stay int8;
- int8 compute (``Config.enable_int8_compute``): Linear and Conv2D
  swapped for ``quantization.int8_compute``'s int8 x int8 -> int32
  layers, the remaining floats in bf16.

How the served module dequantizes: the module swap installs a
``WeightOnlyLinear`` / ``WeightOnlyConv2D`` whose ``weight`` is computed
at each call, ``q.to(bf16) * scale.to(bf16)`` (unpacked first for int4),
as ``ServingParams.materialize`` computes it. Only one layer's
dequantized weight exists at a time: the JAX form leaves the multiply to
XLA, which fuses it into the matmul, and an eager copy of every weight
would double the weight memory.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..core import device as device_mod
from ..core.tensor import plain
from ..kernels import row_linear as _row
from ..nn import functional as F
from ..nn.layers_common import Conv2D, Linear
from ..quantization.fake_quant import quantize_int8
from .config import Config, PrecisionType

__all__ = ["ServingParams", "serving_params", "quantize_int4", "pack_int4",
           "unpack_int4", "WeightOnlyLinear", "WeightOnlyConv2D"]


def quantize_int4(w, axis: int = 1):
    """Per-channel int4 quantization: ``q = round(w / absmax * 7)``
    clipped to [-7, 7], returned UNPACKED as int8 values, with the
    per-channel absmax in ``w``'s dtype (reduced dims kept as size 1;
    dequantized, ``w ~ q * scale / 7``). Rounded in fp32, as
    ``quantize_int8``."""
    w = plain(w)
    red = tuple(i for i in range(w.dim()) if i != axis)
    scale = torch.clamp_min(w.detach().abs().amax(dim=red, keepdim=True),
                            1e-8)
    q = torch.clamp(torch.round(w.detach().float() / scale.float() * 7.0),
                    -7, 7).to(torch.int8)
    return q, scale


def pack_int4(q):
    """Pack int4-range int8 values two per byte along axis 0 (even rows
    in the low nibble, odd rows in the high): [n, ...] -> [ceil(n/2),
    ...] int8. An odd row count pads one zero row."""
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1,) + tuple(q.shape[1:]))], dim=0)
    lo = torch.bitwise_and(q[0::2], 0x0F)
    hi = torch.bitwise_left_shift(q[1::2], 4)
    return torch.bitwise_or(lo, hi)


def unpack_int4(packed, rows: int):
    """Invert :func:`pack_int4`: two arithmetic shifts sign-extend the
    nibbles, the rows re-interleave and the pad row (odd ``rows``) is
    dropped. Exact for values in [-7, 7]."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    q = torch.stack([lo, hi], dim=1)
    return q.reshape((-1,) + tuple(packed.shape[1:]))[:rows]


def dequantize(stored, scale, int4_rows: Optional[int] = None):
    """The bf16 weight of a stored int8 (or, with ``int4_rows``, packed
    int4) tensor: ``q.to(bf16) * scale.to(bf16)``, the JAX
    ``materialize`` product."""
    q = stored if int4_rows is None else unpack_int4(stored, int4_rows)
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


class _WeightOnly(nn.Module):
    """A weight-only quantized layer: buffers ``weight_q`` (int8, or
    packed int4) and ``weight_scale`` (fp32, ``absmax / 127`` or
    ``absmax / 7``); ``weight`` is the dequantized bf16 weight, computed
    at each access."""

    def __init__(self, q, scale, int4_rows, bias):
        super().__init__()
        self.register_buffer("weight_q", q)
        self.register_buffer("weight_scale", scale)
        self.int4_rows = int4_rows
        if bias is not None:
            self.bias = nn.Parameter(bias, requires_grad=False)
        else:
            self.bias = None

    @property
    def weight(self):
        return dequantize(self.weight_q, self.weight_scale, self.int4_rows)


class WeightOnlyLinear(_WeightOnly):
    def __init__(self, lin: Linear, q, scale, int4_rows, bias):
        super().__init__(q, scale, int4_rows, bias)
        self.in_features = lin.in_features
        self.out_features = lin.out_features

    def forward(self, x):
        w = self.weight
        if _row.routes(x, w, self.bias):
            return _row.row_linear(x, w, self.bias)
        return TF.linear(x, w.t(), self.bias)


class WeightOnlyConv2D(_WeightOnly):
    def __init__(self, conv: Conv2D, q, scale, bias):
        super().__init__(q, scale, None, bias)
        for k in ("in_channels", "out_channels", "kernel_size", "stride",
                  "padding", "dilation", "groups", "data_format"):
            setattr(self, k, getattr(conv, k))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


@dataclasses.dataclass
class ServingParams:
    """The module a serving program runs and its stored state.

    ``layer`` is the served module on ``device`` (module-swapped under
    int8 precision). ``names`` / ``vals`` are the stored state under the
    JAX package's names: for weight-only precision the caller's
    state-dict names, with each quantized weight's int8 (or packed int4)
    tensor in its place; ``scales`` maps a quantized name to its fp32
    ``absmax / 127`` (int4: ``absmax / 7``) and ``int4`` to its
    unpacked row count. ``vals`` share storage with ``layer``."""

    layer: nn.Module
    device: torch.device
    names: List[str]
    vals: List[torch.Tensor]
    scales: Dict[str, torch.Tensor]
    compute_dtype: Optional[torch.dtype]
    int4: Dict[str, int] = dataclasses.field(default_factory=dict)

    def materialize(self, param_vals):
        """The dequantized view of ``param_vals`` (in ``names`` order):
        int4 entries unpacked and dequantized, int8 weight-only entries
        dequantized (``q.bf16 * scale.bf16``), the rest as they are. The
        served layers compute the same product, one layer at a time."""
        if not self.scales and not self.int4:
            return list(param_vals)
        return [dequantize(v, self.scales[n], self.int4.get(n))
                if n in self.scales else v
                for n, v in zip(self.names, param_vals)]

    def cast_feed(self, arr):
        """The serving input cast: float feeds move to the compute
        dtype, ids and masks pass through."""
        if self.compute_dtype is not None and arr.is_floating_point():
            return arr.to(self.compute_dtype)
        return arr


def _weight_only(layer: nn.Module, dev: torch.device, bits: int):
    """A copy of ``layer`` on ``dev`` with its Linear and Conv2D weights
    quantized from their own values (int4 for Linear when ``bits`` is
    4), every other float in bf16."""
    swaps = {}
    for lname, sub in layer.named_modules():
        w = getattr(sub, "weight", None)
        if not isinstance(sub, (Linear, Conv2D)) or w is None or \
                not w.is_floating_point():
            continue
        if isinstance(sub, Linear) and bits == 4:
            q, s = quantize_int4(w, axis=1)
            # q = round(x / s * 7)  =>  x ~ q * (s / 7)
            swaps[lname] = (pack_int4(q), s.to(torch.float32) / 7.0,
                            int(w.shape[0]))
        else:
            q, s = quantize_int8(w, axis=1 if isinstance(sub, Linear)
                                 else 0)
            # q = round(x / s * 127)  =>  x ~ q * (s / 127)
            swaps[lname] = (q, s.to(torch.float32) / 127.0, None)
    served = copy.deepcopy(layer)
    served = served.to(device=dev, dtype=torch.bfloat16)
    for lname, (q, s, rows) in swaps.items():
        parent_name, _, attr = lname.rpartition(".")
        parent = served.get_submodule(parent_name) if parent_name \
            else served
        sub = parent._modules[attr]
        bias = None if sub.bias is None else plain(sub.bias).detach()
        if isinstance(sub, Linear):
            new = WeightOnlyLinear(sub, q.to(dev), s.to(dev), rows, bias)
        else:
            new = WeightOnlyConv2D(sub, q.to(dev), s.to(dev), bias)
        parent._modules[attr] = new
    return served, swaps


def serving_params(layer, config: Config) -> ServingParams:
    """Prepare ``layer`` for serving on ``config``'s device in its
    precision. The caller's module is left untouched: when a cast, a
    move or a quantization is needed, a copy is served."""
    dev = device_mod.resolve(config.device)
    prec = config.precision
    layer.eval()
    names = list(layer.state_dict().keys())
    scales: Dict[str, torch.Tensor] = {}
    int4: Dict[str, int] = {}
    if prec == PrecisionType.Int8 and getattr(config, "_int8_compute",
                                              False):
        # int8 compute: Linear and Conv2D swapped for int8 x int8 ->
        # int32 layers, every remaining float (scales and biases too, as
        # in the JAX package) in bf16
        from ..quantization.int8_compute import convert_to_int8_compute
        served = convert_to_int8_compute(layer, inplace=False)
        served = served.to(device=dev, dtype=torch.bfloat16)
        state = served.state_dict(keep_vars=True)
        names = list(state.keys())
        vals = [plain(t).detach() for t in state.values()]
        compute_dtype = torch.bfloat16
    elif prec == PrecisionType.Int8:
        wb = int((getattr(config, "_serving", None) or {})
                 .get("weight_bits") or 8)
        served, swaps = _weight_only(layer, dev, wb)
        state = served.state_dict(keep_vars=True)
        vals = []
        for n in names:
            lname = n[:-len(".weight")] if n.endswith(".weight") else None
            if lname in swaps:
                mod = served.get_submodule(lname)
                vals.append(mod.weight_q)
                scales[n] = mod.weight_scale
                if mod.int4_rows is not None:
                    int4[n] = mod.int4_rows
            else:
                vals.append(plain(state[n]).detach())
        compute_dtype = torch.bfloat16
    else:
        compute_dtype = {PrecisionType.Bfloat16: torch.bfloat16,
                         PrecisionType.Half: torch.float16}.get(prec)
        if compute_dtype is None and prec != PrecisionType.Float32:
            raise ValueError(f"unknown precision {prec!r}")
        tensors = list(layer.parameters()) + list(layer.buffers())
        needs = any(t.device != dev or
                    (compute_dtype is not None and t.is_floating_point()
                     and t.dtype != compute_dtype) for t in tensors)
        served = layer
        if needs:
            served = copy.deepcopy(layer).to(device=dev)
            if compute_dtype is not None:
                served = served.to(dtype=compute_dtype)
        state = served.state_dict(keep_vars=True)
        vals = [plain(state[n]).detach() for n in names]
    served.eval()
    return ServingParams(layer=served, device=dev, names=names, vals=vals,
                         scales=scales, compute_dtype=compute_dtype,
                         int4=int4)
