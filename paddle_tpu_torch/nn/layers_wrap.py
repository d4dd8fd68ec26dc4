"""The activation and loss layers of the JAX package's
``nn/layers_wrap.py`` that delegate to a functional with options fixed
at construction (built by ``layers_common._act`` and ``_loss``, with
the same positional-parameter names), ``Maxout``, ``Softmax2D``, and
``HSigmoidLoss``, the one loss layer with parameters. The rest of that
file (pools, unpools, norms, pixel shuffles, transposed convs) is
ROADMAP A2b-2."""
from __future__ import annotations

from . import functional as F
from . import initializer as I
from .layer import Layer
from .layers_common import _act, _loss

__all__ = [
    "CELU", "Hardshrink", "Hardtanh", "LogSigmoid", "SELU", "Softplus",
    "Softshrink", "Softsign", "Tanhshrink", "ThresholdedReLU", "Maxout",
    "Softmax2D", "CTCLoss", "CosineEmbeddingLoss", "HingeEmbeddingLoss",
    "MarginRankingLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "SoftMarginLoss", "TripletMarginLoss", "TripletMarginWithDistanceLoss",
    "HSigmoidLoss",
]


CELU = _act("CELU", "celu", ("alpha",))
Hardshrink = _act("Hardshrink", "hardshrink", ("threshold",))
Hardtanh = _act("Hardtanh", "hardtanh", ("min", "max"))
LogSigmoid = _act("LogSigmoid", "log_sigmoid")
SELU = _act("SELU", "selu", ("scale", "alpha"))
Softplus = _act("Softplus", "softplus", ("beta", "threshold"))
Softshrink = _act("Softshrink", "softshrink", ("threshold",))
Softsign = _act("Softsign", "softsign")
Tanhshrink = _act("Tanhshrink", "tanhshrink")
ThresholdedReLU = _act("ThresholdedReLU", "thresholded_relu",
                       ("threshold",))


class Maxout(Layer):
    def __init__(self, groups: int, axis: int = 1):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class Softmax2D(Layer):
    """Softmax over the channel axis of a 3-D or 4-D (NCHW) input."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(
                f"Softmax2D expects 3-d/4-d input, got {x.dim()}-d")
        return F.softmax(x, axis=-3)


CTCLoss = _loss("CTCLoss", "ctc_loss", ("blank", "reduction"))
CosineEmbeddingLoss = _loss("CosineEmbeddingLoss", "cosine_embedding_loss",
                            ("margin", "reduction"))
HingeEmbeddingLoss = _loss("HingeEmbeddingLoss", "hinge_embedding_loss",
                           ("margin", "reduction"))
MarginRankingLoss = _loss("MarginRankingLoss", "margin_ranking_loss",
                          ("margin", "reduction"))
TripletMarginLoss = _loss("TripletMarginLoss", "triplet_margin_loss",
                          ("margin", "p", "epsilon", "swap", "reduction"))
MultiLabelSoftMarginLoss = _loss("MultiLabelSoftMarginLoss",
                                 "multi_label_soft_margin_loss",
                                 ("weight", "reduction"))
MultiMarginLoss = _loss("MultiMarginLoss", "multi_margin_loss",
                        ("p", "margin", "weight", "reduction"))
SoftMarginLoss = _loss("SoftMarginLoss", "soft_margin_loss", ("reduction",))
TripletMarginWithDistanceLoss = _loss(
    "TripletMarginWithDistanceLoss", "triplet_margin_with_distance_loss",
    ("distance_function", "margin", "swap", "reduction"))


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss over the default complete binary tree:
    ``weight`` [num_classes - 1, feature_size] XavierNormal from
    ``generator``, ``bias`` [num_classes - 1] zeros unless
    ``bias_attr=False``. Custom trees and sparse updates raise, as in
    the JAX package."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        if is_custom or is_sparse:
            raise NotImplementedError(
                "custom-tree / sparse hsigmoid is unsupported; use the "
                "default complete-binary-tree form")
        self._num_classes = num_classes
        mk = dict(device=device, dtype=dtype, generator=generator)
        self.weight = self.create_parameter(
            (num_classes - 1, feature_size), attr=weight_attr,
            default_initializer=I.XavierNormal(), **mk)
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_classes - 1,), attr=bias_attr, is_bias=True, **mk)

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self._num_classes,
                               self.weight, self.bias)
