"""Functionals the ported modules use (``torch.nn.functional`` covers
the rest)."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
