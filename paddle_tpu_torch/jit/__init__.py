"""Training step (the JAX package's ``jit/``)."""
from .api import TrainStep  # noqa: F401
