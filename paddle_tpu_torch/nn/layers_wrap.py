"""Loss layers that delegate to a functional with options fixed at
construction (built by ``layers_common._loss``, as the JAX package's
``nn/layers_wrap.py`` builds them, with the same positional-parameter
names), and ``HSigmoidLoss``, the one loss layer with parameters."""
from __future__ import annotations

import math

from torch import nn

from . import functional as F
from .layers_common import _loss, _param

__all__ = [
    "CTCLoss", "CosineEmbeddingLoss", "HingeEmbeddingLoss",
    "MarginRankingLoss", "MultiLabelSoftMarginLoss", "MultiMarginLoss",
    "SoftMarginLoss", "TripletMarginLoss", "TripletMarginWithDistanceLoss",
    "HSigmoidLoss",
]


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


class HSigmoidLoss(nn.Module):
    """Hierarchical sigmoid loss over the default complete binary tree:
    ``weight`` [num_classes - 1, feature_size] Xavier-normal from
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
        shape = (num_classes - 1, feature_size)
        std = math.sqrt(2.0 / (shape[0] + shape[1]))
        self.weight = _param(shape, device, dtype, std, generator)
        self.bias = None if bias_attr is False else \
            _param((num_classes - 1,), device, dtype, "zeros")

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self._num_classes,
                               self.weight, self.bias)
