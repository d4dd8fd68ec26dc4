"""AMP autocast (the JAX package's ``amp/auto_cast.py``).

O1: inside ``auto_cast()``, an op on the white list computes in the low
precision dtype (its float32, float16 and bfloat16 inputs are cast to
it) and an op on the black list in float32 (its float16 and bfloat16
inputs are cast up); any other op takes its inputs as they come. O2:
``decorate`` casts the model's parameters to the low dtype up front, and
an optimizer built with ``multi_precision=True`` keeps float32 masters.

The JAX package casts in its op dispatch, by the op's registered name.
This package's op registry (``ops/op_registry.py``) does the same for
the ops of ``ops/``; the ``nn`` functions, which are not registered ops
yet (ROADMAP A2b), call ``maybe_cast(name, *tensors)`` at their head
wherever their JAX counterpart dispatches under a listed name:
``nn.functional.linear``
(and ``Linear``, the GPT LM head), ``conv2d``, ``layer_norm``,
``rms_norm``, ``batch_norm_train``, ``batch_norm_infer``,
``scaled_dot_product_attention`` and the losses on the black list.
``torch.autocast`` is not used: its op lists are not the reference's,
and it would cast inside functions the reference treats as one op,
such as the einsums of ``sdpa_xla``.

The state is thread-local and read at every call. The JAX package
compiles the state it finds at a ``TrainStep``'s first call into that
step's program; here each step runs under the state around it, which
is the same as long as a step runs under one state. ``recompute``
re-enters the state of a forward when it recomputes it in backward.
"""
from __future__ import annotations

import threading

import torch

from ..core import dtype as dtype_mod
from ..core import flags

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard",
           "is_autocast_enabled", "get_autocast_dtype",
           "get_autocast_level", "maybe_cast", "decorate"]

_STATE = threading.local()

# ops that compute in the low precision dtype (the JAX package's list)
WHITE_LIST = {
    "matmul", "bmm", "mm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "einsum", "scaled_dot_product_attention", "addmm",
}
# numerically sensitive ops that stay in float32 (the JAX package's list)
BLACK_LIST = {
    "softmax", "log_softmax", "cross_entropy", "nll_loss", "layer_norm",
    "rms_norm", "batch_norm_train", "batch_norm_infer", "group_norm",
    "logsumexp", "sum", "mean", "exp", "log", "pow", "norm",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
    "mse_loss", "l1_loss",
}

_CASTABLE = (torch.float32, torch.float16, torch.bfloat16)
_LOW = (torch.float16, torch.bfloat16)


def is_autocast_enabled() -> bool:
    return getattr(_STATE, "enabled", False)


def get_autocast_dtype() -> torch.dtype:
    return getattr(_STATE, "dtype", torch.bfloat16)


def get_autocast_level() -> str:
    return getattr(_STATE, "level", "O1")


def _get_state():
    """The whole thread-local state, for ``recompute`` to put back."""
    return (getattr(_STATE, "enabled", False),
            getattr(_STATE, "dtype", None),
            getattr(_STATE, "level", "O1"),
            getattr(_STATE, "white", None),
            getattr(_STATE, "black", None))


def _set_state(state):
    (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.white,
     _STATE.black) = state
    if _STATE.dtype is None:
        del _STATE.dtype      # get_autocast_dtype's default again


class auto_cast:
    """Context manager: ``with paddle_tpu_torch.amp.auto_cast(): ...``.
    ``dtype`` defaults to the flag ``amp_dtype``; custom lists move ops
    between the white and the black list."""

    def __init__(self, enable: bool = True, custom_white_list=None,
                 custom_black_list=None, level: str = "O1",
                 dtype: str = None):
        self.enable = enable
        self.level = level
        self.dtype = dtype_mod.convert_dtype(
            dtype or flags.get_flag("amp_dtype"))
        self.white = set(WHITE_LIST)
        self.black = set(BLACK_LIST)
        if custom_white_list:
            self.white |= set(custom_white_list)
            self.black -= set(custom_white_list)
        if custom_black_list:
            self.black |= set(custom_black_list)
            self.white -= set(custom_black_list)

    def __enter__(self):
        self._prev = _get_state()
        _set_state((self.enable, self.dtype, self.level, self.white,
                    self.black))
        return self

    def __exit__(self, *exc):
        _set_state(self._prev)
        return False


amp_guard = auto_cast


def maybe_cast(op_name: str, *tensors):
    """``tensors`` as the op ``op_name`` takes them under the current
    autocast state: a white-listed op's float32/float16/bfloat16 tensors
    in the low dtype, a black-listed op's float16/bfloat16 tensors in
    float32, anything else (None, integer tensors) as it is. Returns a
    tuple of the same length."""
    if not getattr(_STATE, "enabled", False):
        return tensors
    white = getattr(_STATE, "white", None)
    black = getattr(_STATE, "black", None)
    if op_name in (WHITE_LIST if white is None else white):
        low = get_autocast_dtype()
        return tuple(t.to(low) if isinstance(t, torch.Tensor)
                     and t.dtype in _CASTABLE and t.dtype != low else t
                     for t in tensors)
    if op_name in (BLACK_LIST if black is None else black):
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype in _LOW else t for t in tensors)
    return tensors


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every model's parameters and buffers to ``dtype`` in
    place (the Parameter objects stay, so an optimizer built before
    keeps them). Build the optimizers with ``multi_precision=True`` to
    keep float32 masters. Returns ``models``, or ``(models,
    optimizers)`` when optimizers are given."""
    d = dtype_mod.convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        if m is not None:
            m.to(dtype=d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
