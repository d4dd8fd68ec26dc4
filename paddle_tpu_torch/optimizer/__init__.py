"""Optimizers, gradient clipping and LR schedules (the JAX package's
``optimizer/``). Ported: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, the
three clips and every scheduler; the other optimizers are still to port
(ROADMAP A4)."""
from . import lr  # noqa: F401
from .grad_clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                        ClipGradByValue)
from .optimizer import Optimizer  # noqa: F401
from .optimizers import SGD, Adam, AdamW, Momentum  # noqa: F401
