"""Core layers with Paddle's parameter layout and names.

``Linear`` keeps Paddle's ``[in_features, out_features]`` weight (the
transpose of ``torch.nn.Linear``'s), ``Conv2D`` Paddle's ``[out, in /
groups, kh, kw]``, and every layer keeps the JAX package's parameter
and buffer names (``BatchNorm2D``'s running statistics are ``_mean`` and
``_variance``), so the two packages' state dicts match key for key and
shape for shape. Parameters are created on an explicit
device and initialized from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from ..core import random as random_mod
from . import functional as F


def _param(shape, device, dtype, init, generator=None) -> nn.Parameter:
    """A parameter of ``shape`` on ``device``: ``init`` is a float (the
    std of a zero-mean normal draw from ``generator``), ``("uniform",
    bound)`` (a draw from U(-bound, bound)) or the string 'zeros' /
    'ones'."""
    dev = device_mod.resolve(device)
    dt = dtype_mod.convert_dtype(dtype) or torch.float32
    data = torch.empty(shape, device=dev, dtype=dt)
    with torch.no_grad():
        if init == "zeros":
            data.zero_()
        elif init == "ones":
            data.fill_(1.0)
        else:
            gen = generator if generator is not None \
                else random_mod.generator(dev)
            if isinstance(init, tuple):
                data.uniform_(-init[1], init[1], generator=gen)
            else:
                data.normal_(0.0, float(init), generator=gen)
    return nn.Parameter(data)


class Linear(nn.Module):
    """y = xW + b with W of shape [in_features, out_features]. ``std``
    is the normal init's deviation (default: Xavier-normal, Paddle's
    default initializer)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, std: Optional[float] = None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        if std is None:
            std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = _param((in_features, out_features), device, dtype,
                             std, generator)
        self.bias = _param((out_features,), device, dtype, "zeros") \
            if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 1.0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param((num_embeddings, embedding_dim), device,
                             dtype, std, generator)

    def forward(self, x):
        return TF.embedding(x, self.weight)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = _param(self.normalized_shape, device, dtype, "ones")
        self.bias = _param(self.normalized_shape, device, dtype, "zeros")

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"



class RMSNorm(nn.Module):
    """RMSNorm over the last dim with a ``[hidden_size]`` weight of
    ones."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param((hidden_size,), device, dtype, "ones")

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

class Dropout(nn.Module):
    """Upscale-in-train dropout drawing its mask from the device's
    seeded generator; the identity in eval mode."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=random_mod.generator(x.device),
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


# ---------------------------------------------------------------- conv

class Conv2D(nn.Module):
    """2-D convolution with Paddle's ``[out, in / groups, kh, kw]``
    weight, initialized KaimingUniform (fan_in, negative slope sqrt(5),
    leaky ReLU: U(-1/sqrt(fan_in), 1/sqrt(fan_in))); the bias, unless
    ``bias_attr=False``, from the same bound."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr is not None or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D padding_mode / weight_attr / bias_attr other than "
                "the defaults are not ported yet (ROADMAP A2)")
        ks = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = ks
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = _param((out_channels, in_channels // groups) + ks,
                             device, dtype, ("uniform", bound), generator)
        self.bias = _param((out_channels,), device, dtype,
                           ("uniform", bound), generator) \
            if bias_attr is not False else None

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)

    def extra_repr(self):
        return f"{self.in_channels}, {self.out_channels}, " \
               f"kernel_size={self.kernel_size}, stride={self.stride}, " \
               f"data_format={self.data_format}"


# ---------------------------------------------------------------- norm

_FROZEN = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, batch norm layers leave their running statistics as they
    are. ``jit.TrainStep`` runs its forward here: the JAX package traces
    that forward, and a traced forward cannot update them. A recomputed
    forward (``distributed.parallel.recompute``) runs here too."""
    depth = getattr(_FROZEN, "depth", 0)
    _FROZEN.depth = depth + 1
    try:
        yield
    finally:
        _FROZEN.depth = depth


@contextlib.contextmanager
def train_step_trace():
    """Marks the forward of ``jit.TrainStep``, which the JAX package
    traces. Two behaviours of the reference hang on that trace and key
    on this mark here: ``ResNet(recompute_stages=)`` engages only inside
    it, and attention dropout is off inside it (the traced forward gets
    no dropout key; ROADMAP C18)."""
    prev = getattr(_FROZEN, "traced", False)
    _FROZEN.traced = True
    try:
        yield
    finally:
        _FROZEN.traced = prev


def in_train_step() -> bool:
    """True inside ``train_step_trace``."""
    return getattr(_FROZEN, "traced", False)


class BatchNorm2D(nn.Module):
    """Batch norm over the channel axis (1 for NCHW, last for NHWC).
    Training (unless ``use_global_stats``) normalizes with the batch
    statistics and moves the running ones by ``momentum``; eval uses
    the running ones. Buffers ``_mean`` (zeros) and ``_variance``
    (ones) take ``dtype`` as the parameters do."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = _param((num_features,), device, dtype, "ones") \
            if weight_attr is not False else None
        self.bias = _param((num_features,), device, dtype, "zeros") \
            if bias_attr is not False else None
        buf = dict(device=device_mod.resolve(device),
                   dtype=dtype_mod.convert_dtype(dtype) or torch.float32)
        self.register_buffer("_mean", torch.zeros(num_features, **buf))
        self.register_buffer("_variance", torch.ones(num_features, **buf))

    def forward(self, x):
        if self.training and not self.use_global_stats:
            out, mean, var = F.batch_norm_train(
                x, self.weight, self.bias, self.epsilon, self.data_format)
            self._update_running(mean, var)
            return out
        return F.batch_norm_infer(x, self._mean, self._variance,
                                  self.weight, self.bias, self.epsilon,
                                  self.data_format)

    @torch.no_grad()
    def _update_running(self, mean, var):
        """running = momentum*running + (1 - momentum)*batch, in the
        buffers' dtype, from detached statistics; nothing inside
        ``frozen_running_stats``. Also the hook the fused conv+BN path
        (``models.resnet``) feeds its epilogue statistics through."""
        if getattr(_FROZEN, "depth", 0):
            return
        mom = self.momentum
        self._mean.copy_(mom * self._mean + (1 - mom) * mean.detach())
        self._variance.copy_(mom * self._variance
                             + (1 - mom) * var.detach())

    def extra_repr(self):
        return f"{self.num_features}, data_format={self.data_format}"


# ---------------------------------------------------------------- pooling

class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        if return_mask:
            raise NotImplementedError("MaxPool2D(return_mask=True) is not "
                                      "ported yet (ROADMAP A2)")
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


# ---------------------------------------------------------------- losses

class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` with its options fixed at construction
    (``weight`` and ``label_smoothing`` included)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, label_smoothing=0.0):
        super().__init__()
        self.weight = weight
        self.ignore_index, self.reduction = ignore_index, reduction
        self.soft_label, self.axis = soft_label, axis
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               label_smoothing=self.label_smoothing)


def _loss(name, fn_name, params=()):
    """A layer whose forward is ``F.<fn_name>(*inputs, **options)``; the
    options are ``params`` given by position or by keyword (the JAX
    package's ``nn/layers_wrap.py`` ``_loss`` factory)."""

    class _Loss(nn.Module):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kw = {}
            for i, pname in enumerate(params):
                if i < len(args):
                    self._kw[pname] = args[i]
                elif pname in kwargs:
                    self._kw[pname] = kwargs[pname]

        def forward(self, *inputs):
            return getattr(F, fn_name)(*inputs, **self._kw)

    _Loss.__name__ = name
    _Loss.__qualname__ = name
    return _Loss


MSELoss = _loss("MSELoss", "mse_loss", ("reduction",))
L1Loss = _loss("L1Loss", "l1_loss", ("reduction",))
BCELoss = _loss("BCELoss", "binary_cross_entropy", ("weight", "reduction"))
BCEWithLogitsLoss = _loss("BCEWithLogitsLoss",
                          "binary_cross_entropy_with_logits",
                          ("weight", "reduction", "pos_weight"))
KLDivLoss = _loss("KLDivLoss", "kl_div", ("reduction",))
SmoothL1Loss = _loss("SmoothL1Loss", "smooth_l1_loss", ("reduction", "delta"))
NLLLoss = _loss("NLLLoss", "nll_loss", ("weight", "ignore_index",
                                        "reduction"))
