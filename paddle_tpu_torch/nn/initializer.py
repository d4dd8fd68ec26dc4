"""Weight initializers (the JAX package's ``nn/initializer.py``), so far
as the ported models use them: ``Normal``, ``Constant`` and
``ParamAttr(initializer=...)``, taken by ``Linear(weight_attr=,
bias_attr=)`` and ``Embedding(weight_attr=)``. An initializer fills a
parameter in place from an explicit ``torch.Generator`` (the JAX
package splits its global key instead, so the two draw other numbers
from one seed; weights move across with ``convert.py``). The other
initializers are ROADMAP A2."""
from __future__ import annotations

import torch


class Initializer:
    def fill_(self, t: torch.Tensor, generator=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def fill_(self, t, generator=None):
        with torch.no_grad():
            return t.fill_(float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def fill_(self, t, generator=None):
        with torch.no_grad():
            return t.normal_(float(self.mean), float(self.std),
                             generator=generator)


class ParamAttr:
    """The JAX package's ``ParamAttr``: the initializer, ``trainable``
    and ``regularizer`` of one parameter. ``name``, a ``learning_rate``
    other than 1 and ``need_clip=False`` are not ported yet (ROADMAP A2)
    and raise where a layer applies the attribute."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 trainable=True, regularizer=None, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.regularizer = regularizer
        self.need_clip = need_clip


def default_unless(attr, default):
    """A layer's own init (``default``), or "zeros" when ``attr`` brings
    an initializer that will fill the parameter instead."""
    init = attr.initializer if isinstance(attr, ParamAttr) else attr
    return "zeros" if isinstance(init, Initializer) else default


def apply_attr(param: torch.nn.Parameter, attr, generator=None):
    """Fill ``param`` by ``attr`` (a ParamAttr, a bare Initializer, or
    None for the layer's default, already drawn) and set its
    ``trainable`` flag and ``regularizer``."""
    if attr is None:
        return param
    if isinstance(attr, Initializer):
        attr = ParamAttr(initializer=attr)
    if not isinstance(attr, ParamAttr):
        raise TypeError(f"expected a ParamAttr or an Initializer, got "
                        f"{type(attr).__name__}")
    if attr.name is not None or attr.learning_rate != 1.0 or \
            not attr.need_clip:
        raise NotImplementedError(
            "ParamAttr(name=, learning_rate=, need_clip=): not ported yet "
            "(ROADMAP A2)")
    if attr.initializer is not None:
        attr.initializer.fill_(param.data, generator)
    param.requires_grad_(bool(attr.trainable))
    if attr.regularizer is not None:
        param.regularizer = attr.regularizer
    return param
