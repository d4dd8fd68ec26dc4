"""``QuantConfig`` (the JAX package's ``quantization/config.py``): which
layer types are quantized, and at which bit widths."""
from __future__ import annotations

from typing import Dict, Tuple, Type

from ..nn.layers_common import Conv2D, Linear

__all__ = ["QuantConfig"]


class QuantConfig:
    def __init__(self, activation=None, weight=None,
                 weight_bits: int = 8, activation_bits: int = 8):
        """``activation`` / ``weight`` optionally replace the built-in
        absmax fake-quant: callables ``activation(x) -> x_q`` and
        ``weight(w, axis) -> w_q`` (axis = the channel dim)."""
        self.activation_quanter = activation
        self.weight_quanter = weight
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        # layer type -> (quantize weights, quantize activations)
        self._types: Dict[Type, Tuple[bool, bool]] = {
            Linear: (True, True),
            Conv2D: (True, True),
        }
        self._skip_names: set = set()

    def add_type_config(self, layer_type: Type, weight: bool = True,
                        activation: bool = True) -> "QuantConfig":
        self._types[layer_type] = (weight, activation)
        return self

    def skip(self, *layer_names: str) -> "QuantConfig":
        """Leave the named sublayers (full path or last component)
        unquantized, e.g. the LM head."""
        self._skip_names.update(layer_names)
        return self

    def should_quantize(self, name: str, layer) -> bool:
        if name in self._skip_names or \
                name.split(".")[-1] in self._skip_names:
            return False
        return type(layer) in self._types
