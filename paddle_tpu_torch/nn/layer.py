"""``Layer``: the module base class (the JAX package's ``nn/layer.py``)
on ``torch.nn.Module``.

Storage is torch's own: parameters, buffers and sublayers live in
``_parameters``, ``_buffers`` and ``_modules`` (``_sub_layers`` is the
same dict), so ``torch.func.functional_call``, ``.cuda()``, ``deepcopy``,
torch's hooks and ``load_state_dict`` work on a ``Layer`` as on any
module, and a plain ``nn.Module`` child is walked like a ``Layer``.
Over it sits the JAX package's surface: ``create_parameter`` (the
port's ``Parameter``, drawn from an initializer with an explicit
``torch.Generator``), traversal with ``include_sublayers`` /
``include_self`` that returns lists, ``apply`` self first, Paddle's
forward pre/post hooks, ``state_dict`` in the JAX order (parameters,
then persistable buffers), ``set_state_dict`` returning ``(missing,
unexpected)``, ``to(device, dtype)`` with Paddle's strings and
``astype``. Each method also takes the keywords torch passes when it
recurses (``state_dict(destination=, prefix=, keep_vars=)``,
``train(mode)``, ``named_parameters(prefix, recurse, remove_duplicate)``,
``to(torch.device)``).

The boundary: a call whose inputs include the port's ``Tensor``s runs
``forward`` on their plain torch views and returns ``Tensor``s; a call
on plain tensors stays plain and costs one scan of the inputs' types.
Inside ``forward`` parameters are the port's ``Parameter``s: torch
functions on them return plain tensors, while their methods and
operators are Paddle's (``p.t()``, ``p + x`` dispatch an op), so the
port's own layers pass them to torch functions only. Hooks registered
with ``register_forward_pre_hook`` / ``register_forward_post_hook``
see ``Tensor``s, as the JAX package's do.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core import random as random_mod
from ..core.tensor import Parameter, Tensor
from . import initializer as init_mod

_PLAIN = torch.Tensor
_module_call = nn.Module.__call__


# ------------------------------------------------------------ the boundary

def _has_tensor(values) -> bool:
    for v in values:
        if type(v) is _PLAIN:       # the main path's case, first
            continue
        if isinstance(v, Tensor):
            return True
        if type(v) in (tuple, list) and _has_tensor(v):
            return True
        if type(v) is dict and _has_tensor(v.values()):
            return True
    return False


def to_plain(x):
    """``x`` with every port ``Tensor`` in it (nested in tuples, lists
    and dicts) replaced by its plain torch view; a ``Tensor`` marked
    ``stop_gradient`` after it was computed comes detached."""
    if isinstance(x, Tensor):
        t = x.as_subclass(_PLAIN)
        return t.detach() if getattr(x, "_cut", False) else t
    if type(x) in (tuple, list):
        return type(x)(to_plain(v) for v in x)
    if type(x) is dict:
        return {k: to_plain(v) for k, v in x.items()}
    return x


def to_paddle(x):
    """``x`` with every plain torch tensor in it made a ``Tensor``."""
    if type(x) is _PLAIN:
        return x.as_subclass(Tensor)
    if type(x) in (tuple, list):
        return type(x)(to_paddle(v) for v in x)
    if type(x) is dict:
        return {k: to_paddle(v) for k, v in x.items()}
    return x


class _Listed(list):
    """What ``parameters()`` and ``buffers()`` return: a list, as in the
    JAX package, that torch's idiom ``next(m.parameters())`` can also
    step."""

    def __next__(self):
        it = self.__dict__.get("_it")
        if it is None:
            it = self._it = iter(self)
        return next(it)


def _dtype_name(value) -> bool:
    if not isinstance(value, str):
        return False
    try:
        return dtype_mod.convert_dtype(value) is not None
    except (TypeError, ValueError, KeyError):
        return False


class Layer(nn.Module):
    """The JAX package's ``Layer`` as a ``torch.nn.Module``."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()

    # ------------------------------------------------------------ call
    def __call__(self, *args, **kwargs):
        if _has_tensor(args) or (kwargs and _has_tensor(kwargs.values())):
            out = _module_call(self, *to_plain(args), **to_plain(kwargs))
            return to_paddle(out)
        return _module_call(self, *args, **kwargs)

    # ------------------------------------------------------------ registry
    @property
    def _sub_layers(self):
        return self._modules

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        """Paddle's ``persistable=False`` is torch's ``persistent=False``:
        the buffer stays out of ``state_dict``."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        return tensor

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         attr=None, is_bias: bool = False, *, device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Parameter:
        """A ``Parameter`` of ``shape`` on ``device`` (default: the
        ``set_device`` device), drawn by ``attr``'s initializer, else
        ``default_initializer``, else zeros for a bias and XavierNormal
        otherwise, from ``generator`` (default: the device's seeded one).
        ``attr`` (a ``ParamAttr`` or a bare initializer) also gives
        ``trainable`` and ``regularizer``; its ``name``,
        ``learning_rate`` and ``need_clip`` are kept and not applied, as
        in the JAX package (ROADMAP C23)."""
        attr = init_mod.as_param_attr(attr)
        init = attr.initializer if attr is not None else None
        if init is None:
            init = default_initializer
        if init is None:
            init = init_mod.Constant(0.0) if is_bias \
                else init_mod.XavierNormal()
        dev = device_mod.resolve(device)
        dt = dtype_mod.convert_dtype(dtype or self._dtype) or torch.float32
        gen = generator if generator is not None \
            else random_mod.generator(dev)
        data = init(shape, dt, device=dev, generator=gen)
        p = Parameter(data, trainable=True if attr is None
                      else bool(attr.trainable))
        if attr is not None:
            attr.apply_to(p)
        return p

    # ------------------------------------------------------------ traversal
    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        """Sublayers depth first, each before its own (the JAX order);
        plain ``nn.Module`` children too."""
        if include_self:
            yield prefix, self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            sub_prefix = prefix + "." + name if prefix else name
            yield sub_prefix, sub
            if isinstance(sub, Layer):
                yield from sub.named_sublayers(prefix=sub_prefix)
            else:
                for n, m in sub.named_modules(prefix=sub_prefix):
                    if m is not sub:
                        yield n, m

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         recurse: Optional[bool] = None,
                         remove_duplicate: bool = True):
        deep = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=deep,
                                        remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> List[Parameter]:
        deep = include_sublayers if recurse is None else recurse
        return _Listed(p for _, p in self.named_parameters(recurse=deep))

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse: Optional[bool] = None,
                      remove_duplicate: bool = True):
        deep = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=deep,
                                     remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True,
                recurse: Optional[bool] = None) -> list:
        deep = include_sublayers if recurse is None else recurse
        return _Listed(b for _, b in self.named_buffers(recurse=deep))

    def apply(self, fn: Callable[[nn.Module], None]) -> "Layer":
        """``fn`` on this layer, then on every sublayer depth first (the
        JAX order; torch's ``Module.apply`` visits children first)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ------------------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook, *, prepend: bool = False,
                                  with_kwargs: bool = False):
        """``hook(layer, inputs)`` before ``forward``, the inputs as
        ``Tensor``s; a result other than None replaces them. Returns a
        handle whose ``remove()`` takes the hook off. ``with_kwargs``
        registers torch's form, which sees plain tensors."""
        if with_kwargs:
            return super().register_forward_pre_hook(
                hook, prepend=prepend, with_kwargs=True)

        def pre(layer, inputs):
            res = hook(layer, to_paddle(inputs))
            return None if res is None else to_plain(res)

        return super().register_forward_pre_hook(pre, prepend=prepend)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after ``forward``, each as
        ``Tensor``s; a result other than None replaces the outputs."""

        def post(layer, inputs, outputs):
            res = hook(layer, to_paddle(inputs), to_paddle(outputs))
            return None if res is None else to_plain(res)

        return self.register_forward_hook(post)

    # ------------------------------------------------------------ state
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "",
                   use_hook: bool = True, *, prefix: str = "",
                   keep_vars: bool = False):
        """Parameters, then persistable buffers, by structured name (the
        JAX order). Values are the tensors themselves under
        ``keep_vars``, else detached views of them. Given a
        ``destination`` (torch's recursion does), it is filled in
        torch's order."""
        prefix = prefix or structured_name_prefix
        if prefix and not prefix.endswith("."):
            prefix += "."
        if destination is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        if not include_sublayers:
            out = collections.OrderedDict()
            self._save_to_state_dict(out, prefix, keep_vars)
            return out
        raw = super().state_dict(prefix=prefix, keep_vars=keep_vars)
        out = collections.OrderedDict()
        for name, _ in self.named_parameters(prefix=prefix.rstrip(".")):
            if name in raw:
                out[name] = raw[name]
        for name, value in raw.items():
            if name not in out:
                out[name] = value
        return out

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s values (tensors or arrays) into this
        layer's state by name, each in the target's dtype; returns
        ``(missing, unexpected)`` key lists. A shape mismatch raises
        before anything is written."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected, todo = [], [], []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            val = state_dict[name]
            shape = tuple(val.shape) if isinstance(val, torch.Tensor) \
                else tuple(np.shape(val))
            if shape != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint {shape} vs "
                    f"layer {tuple(target.shape)}")
            todo.append((target, val))
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        with torch.no_grad():
            for target, val in todo:
                src = val.as_subclass(_PLAIN) if isinstance(val, Tensor) \
                    else val
                if not isinstance(src, torch.Tensor):
                    src = torch.as_tensor(np.array(src))
                _PLAIN.copy_(target.as_subclass(_PLAIN), src)
        return missing, unexpected

    load_dict = set_state_dict

    # ------------------------------------------------------------ placement
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` with Paddle's
        device strings ('gpu', 'gpu:0', 'cpu') and dtype names, or any
        of torch's forms (``to(torch.device)``, ``to(torch.dtype)``,
        ``to(tensor)``). Floating parameters and buffers take the dtype;
        the ``Parameter`` objects stay the same."""
        device = kwargs.pop("device", None)
        dtype = kwargs.pop("dtype", None)
        blocking = kwargs.pop("blocking", None)
        non_blocking = bool(kwargs.pop("non_blocking", False))
        if kwargs:
            raise TypeError(f"to() got unexpected keywords {sorted(kwargs)}")
        for a in args:
            if a is None:
                continue
            if isinstance(a, torch.dtype) or _dtype_name(a):
                dtype = a
            elif isinstance(a, torch.Tensor):
                device, dtype = a.device, a.dtype
            elif isinstance(a, bool):
                blocking = a
            else:
                device = a
        if blocking is not None:
            non_blocking = not blocking
        dev = device_mod.resolve(device) if device is not None else None
        dt = dtype_mod.convert_dtype(dtype) if dtype is not None else None
        return super().to(device=dev, dtype=dt, non_blocking=non_blocking)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None
