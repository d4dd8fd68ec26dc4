"""Quantization-aware training (the JAX package's ``quantization/qat.py``).

``QAT.quantize(model)`` swaps each ``Linear`` and ``Conv2D`` sublayer
the config selects for a ``QuantedLinear`` / ``QuantedConv2D`` that
fake-quantizes its weight per output channel and its input per tensor
(dynamic absmax) with straight-through gradients (``fake_quant``). The
wrapper holds the original layer as ``inner`` and shares its
``Parameter`` objects, so an optimizer built before keeps working and
the state dict names gain ``.inner`` (``convert.load_reference_state``
maps such names both ways). ``QAT.convert`` puts the plain layers back
with their trained weights.
"""
from __future__ import annotations

import copy
from typing import Optional

from torch import nn

from ..nn import functional as F
from ..nn.layers_common import Conv2D, Linear
from .config import QuantConfig
from .fake_quant import fake_quant, fake_quant_channelwise

__all__ = ["QAT", "QuantedLinear", "QuantedConv2D"]


def _quant_act(x, cfg: QuantConfig):
    if cfg.activation_quanter is not None:
        return cfg.activation_quanter(x)
    return fake_quant(x, bits=cfg.activation_bits)


def _quant_weight(w, axis: int, cfg: QuantConfig):
    if cfg.weight_quanter is not None:
        return cfg.weight_quanter(w, axis)
    return fake_quant_channelwise(w, axis=axis, bits=cfg.weight_bits)


class QuantedLinear(nn.Module):
    def __init__(self, inner: Linear, config: QuantConfig,
                 q_weight: bool = True, q_act: bool = True):
        super().__init__()
        self.inner = inner
        self._cfg = config
        self._q_weight = q_weight
        self._q_act = q_act

    def forward(self, x):
        if self._q_act:
            x = _quant_act(x, self._cfg)
        w = self.inner.weight
        if self._q_weight:
            # weight [in, out]: the channel axis is 1 (out features)
            w = _quant_weight(w, 1, self._cfg)
        return F.linear(x, w, self.inner.bias)


class QuantedConv2D(nn.Module):
    def __init__(self, inner: Conv2D, config: QuantConfig,
                 q_weight: bool = True, q_act: bool = True):
        super().__init__()
        self.inner = inner
        self._cfg = config
        self._q_weight = q_weight
        self._q_act = q_act

    def forward(self, x):
        if self._q_act:
            x = _quant_act(x, self._cfg)
        inner = self.inner
        w = inner.weight
        if self._q_weight:
            # weight [out, in/g, kh, kw]: the channel axis is 0
            w = _quant_weight(w, 0, self._cfg)
        return F.conv2d(x, w, inner.bias, inner.stride, inner.padding,
                        inner.dilation, inner.groups, inner.data_format)


_WRAPPERS = {Linear: QuantedLinear, Conv2D: QuantedConv2D}


class QAT:
    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: nn.Module, inplace: bool = True) -> nn.Module:
        """Wrap the quantizable sublayers (in place unless ``inplace``
        is False, then in a deep copy)."""
        if not inplace:
            model = copy.deepcopy(model)
        self._walk(model, prefix="")
        return model

    def _walk(self, layer: nn.Module, prefix: str) -> None:
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            full = f"{prefix}{name}"
            wrapper = _WRAPPERS.get(type(sub))
            if wrapper is not None and \
                    self.config.should_quantize(full, sub):
                qw, qa = self.config._types[type(sub)]
                layer._modules[name] = wrapper(sub, self.config,
                                               q_weight=qw, q_act=qa)
            else:
                self._walk(sub, prefix=full + ".")

    @staticmethod
    def convert(model: nn.Module, inplace: bool = True) -> nn.Module:
        """Put the plain layers back in place of the wrappers (weights
        keep their trained values; ``ptq`` and the int8 paths export
        for deployment)."""
        if not inplace:
            model = copy.deepcopy(model)

        def walk(layer):
            for name, sub in list(layer._modules.items()):
                if isinstance(sub, (QuantedLinear, QuantedConv2D)):
                    layer._modules[name] = sub.inner
                elif sub is not None:
                    walk(sub)

        walk(model)
        return model
