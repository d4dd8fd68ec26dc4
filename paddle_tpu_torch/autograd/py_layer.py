"""PyLayer: user-defined forward and backward (the JAX package's
``autograd/py_layer.py``) as a ``torch.autograd.Function``. ``backward``
returns one gradient per differentiable ``Tensor`` input of
``forward``, in order; the other inputs get none."""
from __future__ import annotations

from typing import List

import torch

from ..core.tensor import Tensor, as_torch, is_grad_enabled

_PLAIN = torch.Tensor
_NO_TF = torch._C.DisableTorchFunctionSubclass


class PyLayerContext:
    def __init__(self):
        self._saved: List = []
        self.extra: dict = {}

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    saved_tensors = saved_tensor


class PyLayerMeta(type):
    def __call__(cls, *args, **kwargs):
        raise RuntimeError(f"Use {cls.__name__}.apply(...) instead of "
                           f"constructing it")


def _as_tensor(o):
    if isinstance(o, Tensor):
        return o
    return as_torch(o).as_subclass(Tensor)


def _differentiable(a) -> bool:
    if not isinstance(a, torch.Tensor):
        return False
    with _NO_TF():
        return a.requires_grad


class _Bridge(torch.autograd.Function):
    """One PyLayer call: ``layer``'s forward (run, as any Function's
    forward, with no recording) and backward with their PyLayerContext;
    ``info["single"]`` says whether forward returned one output."""

    @staticmethod
    def forward(ctx, layer, kwargs, info, *args):
        pctx = PyLayerContext()
        ctx.pctx, ctx.layer = pctx, layer
        ctx.diff = [_differentiable(a) for a in args]
        outs = layer.forward(pctx, *args, **kwargs)
        info["single"] = not isinstance(outs, (list, tuple))
        outs = [outs] if info["single"] else list(outs)
        return tuple(_as_tensor(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        got = ctx.layer.backward(ctx.pctx, *[g.as_subclass(Tensor)
                                             for g in grads])
        if not isinstance(got, (list, tuple)):
            got = (got,)
        it = iter(got)
        full = [as_torch(next(it)) if d else None for d in ctx.diff]
        return (None, None, None, *full)


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx: PyLayerContext, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grad_outputs):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        if is_grad_enabled() and any(_differentiable(a) for a in args):
            info = {}
            outs = [o.as_subclass(Tensor)
                    for o in _Bridge.apply(cls, kwargs, info, *args)]
            return outs[0] if info["single"] else tuple(outs)
        out = cls.forward(PyLayerContext(), *args, **kwargs)
        if isinstance(out, (list, tuple)):
            return tuple(_as_tensor(o) for o in out)
        return _as_tensor(out)
