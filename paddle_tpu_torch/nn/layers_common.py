"""Core layers on ``Layer`` (the JAX package's ``nn/layers_common.py``)
with Paddle's parameter layout and names.

``Linear`` keeps Paddle's ``[in_features, out_features]`` weight (the
transpose of ``torch.nn.Linear``'s), ``Conv2D`` Paddle's ``[out, in /
groups, kh, kw]``, and every layer keeps the JAX package's parameter
and buffer names (``BatchNorm2D``'s running statistics are ``_mean`` and
``_variance``), so the two packages' state dicts match key for key and
shape for shape. Weights come from ``Layer.create_parameter`` with the
JAX package's default initializers, on an explicit ``device`` and from
an explicit ``torch.Generator``; ``weight_attr`` / ``bias_attr`` (a
``ParamAttr``, a bare initializer, or False for no bias) override them.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..core import device as device_mod
from ..core import dtype as dtype_mod
from . import functional as F
from . import initializer as I
from .layer import Layer


def _mk(device, dtype, generator=None):
    return dict(device=device, dtype=dtype, generator=generator)


class Linear(Layer):
    """y = xW + b with W of shape [in_features, out_features], default
    XavierNormal (``std`` gives Normal(0, std) instead) and a zero bias;
    ``bias=False`` or ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 bias: bool = True, std=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        mk = _mk(device, dtype, generator)
        default = I.XavierNormal() if std is None else I.Normal(0.0, std)
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=default, **mk)
        self.bias = self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True, **mk) \
            if bias and bias_attr is not False else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    """Rows of a [num_embeddings, embedding_dim] table, default
    Normal(0, ``std``); ``padding_idx`` positions give zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None, *, std: float = 1.0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, std),
            **_mk(device, dtype, generator))

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        mk = _mk(device, dtype, generator)
        self.weight = None if weight_attr is False else \
            self.create_parameter(self.normalized_shape, attr=weight_attr,
                                  default_initializer=I.Constant(1.0), **mk)
        self.bias = None if bias_attr is False else \
            self.create_parameter(self.normalized_shape, attr=bias_attr,
                                  is_bias=True, **mk)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm over the last dim with a ``[hidden_size]`` weight of
    ones."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), default_initializer=I.Constant(1.0),
            device=device, dtype=dtype)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class Dropout(Layer):
    """``F.dropout`` in training, the identity in eval mode; the mask
    from the device's seeded generator."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCHW",
                 name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


# ---------------------------------------------------------------- conv

class Conv2D(Layer):
    """2-D convolution with Paddle's ``[out, in / groups, kh, kw]``
    weight, default KaimingUniform (fan_in, negative slope sqrt(5),
    leaky ReLU: U(-1/sqrt(fan_in), 1/sqrt(fan_in))) and a bias from the
    same bound unless ``bias_attr=False``. ``padding_mode`` other than
    "zeros" is not ported yet (ROADMAP A2b-2)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                "Conv2D padding_mode other than 'zeros' is not ported yet "
                "(ROADMAP A2b-2)")
        ks = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = ks
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.data_format = data_format
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        mk = _mk(device, dtype, generator)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + ks, attr=weight_attr,
            default_initializer=I.KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5.0),
                nonlinearity="leaky_relu"), **mk)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), **mk)

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


class BatchNorm2D(Layer):
    """Batch norm over the channel axis (1 for NCHW, last for NHWC).
    Training (unless ``use_global_stats``) normalizes with the batch
    statistics and moves the running ones by ``momentum``; eval uses
    the running ones. Buffers ``_mean`` (zeros) and ``_variance``
    (ones) are plain tensors in ``dtype``, as the parameters are."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        mk = _mk(device, dtype, generator)
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_features,), attr=weight_attr,
                                  default_initializer=I.Constant(1.0), **mk)
        self.bias = None if bias_attr is False else \
            self.create_parameter((num_features,), attr=bias_attr,
                                  is_bias=True, **mk)
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

class MaxPool2D(Layer):
    """``return_mask=True`` is not ported yet (ROADMAP A2b-2)."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        if return_mask:
            raise NotImplementedError("MaxPool2D(return_mask=True) is not "
                                      "ported yet (ROADMAP A2b-2)")
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


# ---------------------------------------------------------------- activations

def _act(name, fn_name, params=()):
    """A layer whose forward is ``F.<fn_name>(x, **options)``; the
    options are ``params`` given by position or by keyword (the JAX
    package's ``nn/layers_wrap.py`` ``_act`` factory)."""

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kw = {}
            for i, pname in enumerate(params):
                if i < len(args):
                    self._kw[pname] = args[i]
                elif pname in kwargs:
                    self._kw[pname] = kwargs[pname]

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kw)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act("ReLU", "relu")
GELU = _act("GELU", "gelu", ("approximate",))
Sigmoid = _act("Sigmoid", "sigmoid")
Tanh = _act("Tanh", "tanh")
Softmax = _act("Softmax", "softmax", ("axis",))
LogSoftmax = _act("LogSoftmax", "log_softmax", ("axis",))
LeakyReLU = _act("LeakyReLU", "leaky_relu", ("negative_slope",))
Silu = _act("Silu", "silu")
Hardswish = _act("Hardswish", "hardswish")
Hardsigmoid = _act("Hardsigmoid", "hardsigmoid")
ReLU6 = _act("ReLU6", "relu6")
ELU = _act("ELU", "elu", ("alpha",))
Mish = _act("Mish", "mish")


class Swish(Silu):
    pass


class PReLU(Layer):
    """``weight`` [num_parameters], Constant(``init``)."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", *, device=None, dtype=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=I.Constant(init), device=device,
            dtype=dtype)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


# ---------------------------------------------------------------- losses

class CrossEntropyLoss(Layer):
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

    class _Loss(Layer):
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
