"""Parallel training pieces of the port. So far activation recompute
(``recompute``); the mesh layers, pipelines and sharding are ROADMAP
A11."""
from .recompute import RecomputeWrapper, recompute  # noqa: F401
