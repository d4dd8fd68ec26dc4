"""Device selection with Paddle's ``set_device`` strings.

``'gpu'``, ``'gpu:N'`` and ``'cuda:N'`` name a CUDA card; ``'cpu'`` is
the host and is used only when a caller asks for it. Nothing here falls
back: asking for a card on a machine without CUDA raises.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

_LOCK = threading.Lock()
_CURRENT: Optional[torch.device] = None   # None = the default, 'gpu:0'

_PLAT_ALIASES = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}

DeviceLike = Union[None, str, torch.device]


def _parse(device: Union[str, torch.device]) -> torch.device:
    if isinstance(device, torch.device):
        plat, idx = device.type, device.index
    else:
        text = device.lower().strip()
        plat, _, idx_s = text.partition(":")
        idx = int(idx_s) if idx_s else None
    try:
        plat = _PLAT_ALIASES[plat]
    except KeyError:
        raise ValueError(f"unknown device {device!r}: 'gpu', 'gpu:N' "
                         "or 'cpu'") from None
    if plat == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs a CUDA card and none is visible; "
            "pass device='cpu' to run on the host")
    idx = 0 if idx is None else idx
    if idx >= torch.cuda.device_count():
        raise ValueError(f"CUDA device index {idx} out of range "
                         f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", idx)


def set_device(device: Union[str, torch.device]) -> torch.device:
    """paddle.set_device analog: the default device of every entry
    point that is not given one."""
    global _CURRENT
    dev = _parse(device)
    with _LOCK:
        _CURRENT = dev
    return dev


def get_device() -> str:
    with _LOCK:
        dev = _CURRENT
    if dev is None:
        return "gpu:0"
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def resolve(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` when
    given, else the ``set_device`` default (the first card). Raises when
    a card is asked for and CUDA is missing."""
    if device is not None:
        return _parse(device)
    with _LOCK:
        dev = _CURRENT
    return dev if dev is not None else _parse("gpu")


def memory_allocated(device: DeviceLike = None) -> int:
    """Bytes the caching allocator holds in live tensors on ``device``
    (the current card by default); 0 on the CPU, which has no device
    allocator."""
    dev = resolve(device)
    return int(torch.cuda.memory_allocated(dev)) if dev.type == "cuda" else 0


def memory_reserved(device: DeviceLike = None) -> int:
    """Bytes the caching allocator has reserved from the card (live and
    cached blocks); 0 on the CPU."""
    dev = resolve(device)
    return int(torch.cuda.memory_reserved(dev)) if dev.type == "cuda" else 0
