"""Shared model-building helpers (the JAX package's
``models/_common.py``)."""
from __future__ import annotations

from ..nn import initializer as I
from ..nn.layers_common import Linear


def spec_linear(in_f, out_f, std, spec_w=None, spec_b=None, has_bias=True,
                **kw):
    """Linear with Normal(0, std) init. The JAX package attaches mesh
    PartitionSpecs ``spec_w`` / ``spec_b`` here; one card has no mesh,
    so they are dropped. ``kw``: device, dtype, generator."""
    return Linear(in_f, out_f,
                  weight_attr=I.ParamAttr(initializer=I.Normal(0.0, std)),
                  bias_attr=None if has_bias else False, **kw)
