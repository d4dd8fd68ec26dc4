"""Activations of the JAX package's ``nn/functional/activation.py``, so
far those the ported models call: ``gelu`` (``approximate=True`` is the
tanh form, ``jax.nn.gelu``'s) and ``tanh``. The rest are ROADMAP A2."""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)
