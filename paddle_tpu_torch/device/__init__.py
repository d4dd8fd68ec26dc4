"""paddle.device (the JAX package's ``device/``): device selection, the
build queries and the CUDA memory API on ``torch.cuda``'s caching
allocator. A ``device`` argument is None (the ``set_device`` device),
'gpu:N' / 'cpu', an int card index or a ``torch.device``; the CPU has
no device allocator, so its byte counts are 0."""
from __future__ import annotations

import torch

from ..core import device as _core
from ..core.device import get_device, resolve, set_device  # noqa: F401

Place = torch.device


def current_place() -> torch.device:
    return resolve()


def device_count() -> int:
    return torch.cuda.device_count()


def synchronize(device=None):
    dev = _dev(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def is_compiled_with_cuda() -> bool:
    """True where torch was built with CUDA (the JAX package's answer is
    always False: its accelerator is a TPU)."""
    return torch.backends.cuda.is_built()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def _dev(device) -> torch.device:
    if isinstance(device, int):
        device = f"gpu:{device}"
    return resolve(device)


def memory_stats(device=None) -> dict:
    """The caching allocator's statistics of the card ({} on the CPU)."""
    dev = _dev(device)
    return dict(torch.cuda.memory_stats(dev)) if dev.type == "cuda" else {}


def _on_card(fn, device) -> int:
    dev = _dev(device)
    return int(fn(dev)) if dev.type == "cuda" else 0


def memory_allocated(device=None) -> int:
    """Bytes in live tensors on the card."""
    return _core.memory_allocated(_dev(device))


def max_memory_allocated(device=None) -> int:
    """Peak of ``memory_allocated`` since the start or the last reset."""
    return _on_card(torch.cuda.max_memory_allocated, device)


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from the card (live and
    cached blocks)."""
    return _core.memory_reserved(_dev(device))


def max_memory_reserved(device=None) -> int:
    return _on_card(torch.cuda.max_memory_reserved, device)


def reset_peak_memory_stats(device=None) -> int:
    """Reset both high-water marks (allocated and reserved); returns the
    bytes allocated now."""
    dev = _dev(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return memory_allocated(dev)


# torch resets the two peaks together; the Paddle names each reset both
reset_max_memory_allocated = reset_peak_memory_stats


def reset_max_memory_reserved(device=None) -> int:
    reset_peak_memory_stats(device)
    return memory_reserved(device)
