"""Functionals the ported modules use (``torch.nn.functional`` covers
the rest)."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import flatten, pad, relu  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import (batch_norm_infer, batch_norm_train,  # noqa: F401
                   layer_norm, rms_norm)
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401
