"""Gradient clipping on lists of tensors (the JAX package's
``optimizer/grad_clip.py``): each clip returns new tensors and leaves
its inputs as they are. Norms are taken in fp32 and each clipped
gradient is cast back to its own dtype."""
from __future__ import annotations

from typing import List

import torch


class ClipGradBase:
    def __call__(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, grads):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Per-tensor L2 clip."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        out = []
        for g in grads:
            norm = g.float().square().sum().sqrt()
            scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global L2 clip across all gradients."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        return sum(g.float().square().sum() for g in grads).sqrt()

    def __call__(self, grads):
        gnorm = self.global_norm(grads)
        scale = (self.clip_norm / gnorm.clamp_min(1e-12)).clamp_max(1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads]
