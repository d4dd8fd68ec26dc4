"""Calibration observers (the JAX package's ``quantization/observers.py``).
They run eagerly during PTQ calibration and keep running numpy state;
a tensor is read to the host once per observation (bf16 widened
exactly to float32)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.tensor import plain

__all__ = ["AbsmaxObserver", "AVGObserver", "ChannelWiseAbsmaxObserver"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = plain(x).detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class AbsmaxObserver:
    """Running max of |x| (per tensor)."""

    def __init__(self, bits: int = 8):
        self.bits = bits
        self._max: float = 0.0

    def observe(self, x) -> None:
        self._max = max(self._max, float(np.abs(_np(x)).max()))

    @property
    def scale(self) -> float:
        return max(self._max, 1e-8)


class AVGObserver:
    """Average of the per-batch absmax."""

    def __init__(self, bits: int = 8):
        self.bits = bits
        self._sum = 0.0
        self._n = 0

    def observe(self, x) -> None:
        self._sum += float(np.abs(_np(x)).max())
        self._n += 1

    @property
    def scale(self) -> float:
        return max(self._sum / max(self._n, 1), 1e-8)


class ChannelWiseAbsmaxObserver:
    """Per-channel absmax along ``axis`` (weights)."""

    def __init__(self, axis: int = 0, bits: int = 8):
        self.axis = axis
        self.bits = bits
        self._max: Optional[np.ndarray] = None

    def observe(self, x) -> None:
        arr = np.abs(_np(x))
        red = tuple(i for i in range(arr.ndim) if i != self.axis)
        m = arr.max(axis=red)
        self._max = m if self._max is None else np.maximum(self._max, m)

    @property
    def scale(self) -> np.ndarray:
        assert self._max is not None, "observer saw no data"
        return np.maximum(self._max, 1e-8)
