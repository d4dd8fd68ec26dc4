"""Optimizers, gradient clipping and LR schedules (the JAX package's
``optimizer/``): ``SGD``, ``Momentum``, ``Adagrad``, ``RMSProp``,
``Adam``, ``AdamW``, ``Adamax``, ``Lamb``, the three clips and every
scheduler."""
from . import lr  # noqa: F401
from .grad_clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                        ClipGradByValue)
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adagrad, Adam, Adamax, AdamW,  # noqa: F401
                         Lamb, Momentum, RMSProp)
