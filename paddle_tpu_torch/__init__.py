"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``core``, ``nn``, ``kernels``, ``models``, ``generation``,
``inference``, ``serving``, ``optimizer``, ``jit``) and imports torch, never jax and nothing of
``paddle_tpu``. Every TPU kernel on a ported path is a kernel written by
hand for Hopper (``csrc/``), beside its plain PyTorch version. Entry
points run on the first CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""
__version__ = "0.1.0"

from .core.device import get_device, set_device  # noqa: F401
from .core.random import seed  # noqa: F401

__all__ = ["get_device", "set_device", "seed"]
