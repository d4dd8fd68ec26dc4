"""Seeded generators: ``seed()`` resets one ``torch.Generator`` per
device (Paddle keeps one stateful generator per device; the JAX package
splits one functional key instead). Code that draws random numbers
takes an explicit generator; ``generator(device)`` is the default one.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import torch

from .device import DeviceLike, resolve

_LOCK = threading.Lock()
_GENERATORS: Dict[str, torch.Generator] = {}
_SEED: Optional[int] = None


def seed(s: int) -> int:
    """paddle.seed analog: every device's default generator restarts
    from ``s``."""
    global _SEED
    with _LOCK:
        _SEED = int(s)
        for gen in _GENERATORS.values():
            gen.manual_seed(_SEED)
    return _SEED


def generator(device: DeviceLike = None) -> torch.Generator:
    """The default generator of ``device`` (created on first use from
    the last ``seed()``, or from fresh entropy when none was set)."""
    dev = resolve(device)
    key = str(dev)
    with _LOCK:
        gen = _GENERATORS.get(key)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_SEED if _SEED is not None
                            else int.from_bytes(os.urandom(4), "little"))
            _GENERATORS[key] = gen
        return gen


def get_states() -> Dict[str, torch.Tensor]:
    """The state of every default generator made so far, by device
    (``recompute`` puts them back around a recomputed forward)."""
    with _LOCK:
        return {key: gen.get_state() for key, gen in _GENERATORS.items()}


def set_states(states: Dict[str, torch.Tensor]) -> None:
    """Restore states taken by ``get_states``; a generator made since
    keeps its own."""
    with _LOCK:
        for key, state in states.items():
            _GENERATORS[key].set_state(state)
