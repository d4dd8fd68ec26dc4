"""``loss.backward()`` and ``paddle.grad`` (the JAX package's
``autograd/backward_engine.py``) on torch's autograd engine.

The JAX package walks its own tape because JAX has no eager autograd;
here ``torch.autograd.backward`` and ``torch.autograd.grad`` do the walk,
with the JAX package's argument rules and error messages:
``create_graph`` (double grad), ``allow_unused``, ``no_grad_vars`` (no
gradient flows through them) and ``only_inputs``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.tensor import Tensor, as_torch

_PLAIN = torch.Tensor
_NO_TF = torch._C.DisableTorchFunctionSubclass


def _plain(t):
    with _NO_TF():
        return t.as_subclass(_PLAIN) if type(t) is not _PLAIN else t


def _has_graph(t) -> bool:
    with _NO_TF():
        return (t.requires_grad and t.grad_fn is not None
                and not getattr(t, "_cut", False))


def run_backward(root, grad_tensor=None, retain_graph: bool = False):
    """loss.backward(): accumulate into every reachable leaf's .grad."""
    if not _has_graph(root):
        raise RuntimeError(
            "Tensor has no grad graph (stop_gradient=True or no recorded "
            "ops); cannot call backward(). Note: backward() is an eager-mode "
            "API — inside paddle_tpu.jit-traced functions use "
            "paddle_tpu.grad / value_and_grad instead.")
    r = _plain(root)
    if grad_tensor is None:
        if r.numel() != 1:
            raise RuntimeError(
                f"grad_tensor must be given for non-scalar root "
                f"(shape {list(r.shape)})")
        seed = torch.ones_like(r)
    else:
        seed = as_torch(grad_tensor, None, r.device)
    with _NO_TF():
        torch.autograd.backward(root, seed, retain_graph=retain_graph)


def tensor_grad(outputs, inputs, grad_outputs=None,
                retain_graph: Optional[bool] = None,
                create_graph: bool = False, only_inputs: bool = True,
                allow_unused: bool = False, no_grad_vars=None):
    """paddle.grad(outputs, inputs, ...): gradients of ``outputs`` with
    respect to ``inputs`` without touching .grad. With create_graph=True
    the returned gradients are themselves differentiable."""
    if not only_inputs:
        raise ValueError("only_inputs=False is not supported (matches "
                         "the reference dygraph restriction)")
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
        else [inputs]
    if not outputs or not inputs:
        raise ValueError("outputs and inputs must be non-empty")
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if len(grad_outputs) != len(outputs):
        raise ValueError(
            f"grad_outputs has {len(grad_outputs)} entries for "
            f"{len(outputs)} outputs")
    if retain_graph is None:
        retain_graph = create_graph
    outs, seeds = [], []
    for o, go in zip(outputs, grad_outputs):
        if not isinstance(o, torch.Tensor):
            raise TypeError("outputs must be Tensors")
        if not _has_graph(o):
            continue          # nothing flows from it
        outs.append(o)
        seeds.append(torch.ones_like(_plain(o)) if go is None
                     else as_torch(go, None, _plain(o).device))
    live = [i for i, t in enumerate(inputs)
            if isinstance(t, torch.Tensor) and _plain(t).requires_grad]
    grads = [None] * len(inputs)
    if outs and live:
        handles = []
        with _NO_TF():
            for v in no_grad_vars or ():
                if v.requires_grad:
                    handles.append(_PLAIN.register_hook(v, torch.zeros_like))
            try:
                got = torch.autograd.grad(
                    outs, [inputs[i] for i in live], seeds,
                    retain_graph=retain_graph, create_graph=create_graph,
                    allow_unused=True)
            finally:
                for h in handles:
                    h.remove()
        for i, g in zip(live, got):
            grads[i] = g
    result = []
    for g in grads:
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    "one of the inputs receives no gradient from "
                    "outputs (unreachable in the recorded graph); pass "
                    "allow_unused=True to get None for it")
            result.append(None)
        else:
            result.append((g if create_graph else g.detach()).as_subclass(
                Tensor))
    return result
