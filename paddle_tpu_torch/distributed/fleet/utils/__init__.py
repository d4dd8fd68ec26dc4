"""Fleet utilities of the port: the ``recompute`` activation-
checkpointing entry (the JAX package's ``distributed/fleet/utils/``;
its FS clients are ROADMAP A11)."""
from .recompute import RecomputeConfig, recompute  # noqa: F401

__all__ = ["RecomputeConfig", "recompute"]
