"""Post-training quantization (the JAX package's ``quantization/ptq.py``).

``PTQ.quantize(model)`` wraps the quantizable layers in observer shims;
the caller runs calibration batches; ``PTQ.convert(model)`` freezes the
observed scales into fixed fake-quant wrappers (for accuracy
evaluation) and records int8 weights and scales in ``quant_info`` (for
deployment: ``convert_to_int8_compute`` turns the frozen wrappers into
int8 compute layers)."""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from ..core.tensor import plain
from ..nn import functional as F
from ..nn.layers_common import Conv2D, Linear
from .config import QuantConfig
from .fake_quant import fake_quant, fake_quant_channelwise, quantize_int8
from .observers import AbsmaxObserver, ChannelWiseAbsmaxObserver

__all__ = ["PTQ"]


def _host(t: torch.Tensor) -> np.ndarray:
    t = plain(t).detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class _ObservedLinear(nn.Module):
    _axis = 1  # weight [in, out]: the out channels

    def __init__(self, inner, config: QuantConfig,
                 q_weight: bool = True, q_act: bool = True):
        super().__init__()
        self.inner = inner
        self._q_weight, self._q_act = q_weight, q_act
        self.act_observer = AbsmaxObserver(config.activation_bits)
        self.weight_observer = ChannelWiseAbsmaxObserver(
            axis=self._axis, bits=config.weight_bits)
        if q_weight:
            # weights are constant during calibration: observe once
            self.weight_observer.observe(inner.weight)

    def forward(self, x):
        if self._q_act:
            self.act_observer.observe(x)
        return self.inner(x)


class _ObservedConv2D(_ObservedLinear):
    _axis = 0  # weight [out, in / groups, kh, kw]


class _FrozenQuantLinear(nn.Module):
    def __init__(self, inner: Linear, act_scale, w_scale,
                 config: QuantConfig, q_weight: bool = True,
                 q_act: bool = True):
        super().__init__()
        self.inner = inner
        self.act_scale = None if act_scale is None else float(act_scale)
        self.w_scale = None if w_scale is None else np.asarray(w_scale)
        self._cfg = config
        self._q_weight, self._q_act = q_weight, q_act

    def forward(self, x):
        if self._q_act:
            x = fake_quant(x, scale=self.act_scale,
                           bits=self._cfg.activation_bits)
        w = self.inner.weight
        if self._q_weight:
            w = fake_quant_channelwise(w, axis=1, scale=self.w_scale,
                                       bits=self._cfg.weight_bits)
        return TF.linear(x, torch.t(w), self.inner.bias)


class _FrozenQuantConv2D(nn.Module):
    def __init__(self, inner: Conv2D, act_scale, w_scale,
                 config: QuantConfig, q_weight: bool = True,
                 q_act: bool = True):
        super().__init__()
        self.inner = inner
        self.act_scale = None if act_scale is None else float(act_scale)
        self.w_scale = None if w_scale is None else np.asarray(w_scale)
        self._cfg = config
        self._q_weight, self._q_act = q_weight, q_act

    def forward(self, x):
        inner = self.inner
        if self._q_act:
            x = fake_quant(x, scale=self.act_scale,
                           bits=self._cfg.activation_bits)
        w = inner.weight
        if self._q_weight:
            w = fake_quant_channelwise(w, axis=0, scale=self.w_scale,
                                       bits=self._cfg.weight_bits)
        return F.conv2d(x, w, inner.bias, inner.stride, inner.padding,
                        inner.dilation, inner.groups, inner.data_format)


_OBSERVED = {Linear: _ObservedLinear, Conv2D: _ObservedConv2D}


class PTQ:
    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()
        #: name -> {"weight_int8": np.int8 array, "weight_scale": ...,
        #:          "act_scale": float} after convert()
        self.quant_info: Dict[str, dict] = {}

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        if not inplace:
            model = copy.deepcopy(model)
        self._walk_observe(model, prefix="")
        return model

    def _walk_observe(self, layer: nn.Module, prefix: str) -> None:
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            full = f"{prefix}{name}"
            shim = _OBSERVED.get(type(sub))
            if shim is not None and \
                    self.config.should_quantize(full, sub):
                qw, qa = self.config._types[type(sub)]
                layer._modules[name] = shim(sub, self.config,
                                            q_weight=qw, q_act=qa)
            else:
                self._walk_observe(sub, prefix=full + ".")

    def convert(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        """Freeze the observed scales; record int8 weights for export."""
        if not inplace:
            model = copy.deepcopy(model)
        self._walk_convert(model, prefix="")
        return model

    def _walk_convert(self, layer: nn.Module, prefix: str) -> None:
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            full = f"{prefix}{name}"
            if isinstance(sub, _ObservedLinear):  # incl. _ObservedConv2D
                act_scale = sub.act_observer.scale if sub._q_act else None
                w_scale = sub.weight_observer.scale if sub._q_weight \
                    else None
                info = {"act_scale": act_scale}
                if sub._q_weight:
                    q, s = quantize_int8(sub.inner.weight, axis=sub._axis)
                    info["weight_int8"] = _host(q)
                    info["weight_scale"] = _host(s)
                self.quant_info[full] = info
                frozen_cls = _FrozenQuantConv2D \
                    if isinstance(sub, _ObservedConv2D) \
                    else _FrozenQuantLinear
                layer._modules[name] = frozen_cls(
                    sub.inner, act_scale, w_scale, self.config,
                    q_weight=sub._q_weight, q_act=sub._q_act)
            else:
                self._walk_convert(sub, prefix=full + ".")
