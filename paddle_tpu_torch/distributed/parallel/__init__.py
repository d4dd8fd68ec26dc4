"""Parallel training pieces of the port. So far activation recompute
(``recompute``) and ``mp_layers.sharded_constraint`` (the identity on
one card); the mesh layers, pipelines and sharding are ROADMAP A11."""
from .mp_layers import sharded_constraint  # noqa: F401
from .recompute import RecomputeWrapper, recompute  # noqa: F401
