"""Fused AdamW update of one tensor (the JAX package's
``kernels/fused_adamw.py``).

``fused_adamw_update`` launches the kernel of ``csrc/fused_adamw.cu``
for tensors on a CUDA card and runs the plain version
``fused_adamw_update_plain`` (same signature) for tensors on the CPU;
nothing else picks the plain version. The wrapper counts its launches
(``fused_adamw_update.launches``), the plain version its calls
(``fused_adamw_update_plain.calls``).

The update is the JAX kernel's, operation for operation, in fp32:
``m = b1*m + (1-b1)*g``, ``v = b2*v + (1-b2)*g*g``,
``update = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p``, ``p = p - lr*update``,
with every hyperparameter and ``bc = 1 - b**step`` derived in fp32 (a
Python double ``1 - 0.999`` rounds to fp32 0.001; the fp32
``1 - f32(0.999)`` is 0.00099998713). So this is not the step of
``optimizer.AdamW``, which also decays the parameter multiplicatively
(``p*(1 - lr*wd)``) where this adds ``wd*p`` to the update; the JAX
package differs in the same way.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paddle_adamw": (_I, (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P)
                         + (ctypes.c_float,) * 7 + (_P,))}


def hyperparameters(param, lr, beta1, beta2, epsilon, weight_decay, step):
    """(lr, b1, b2, eps, wd, 1 - b1**step, 1 - b2**step), each in fp32 as
    the JAX package derives them (``fused_adamw.py:54-63``): a tuple of
    numpy float32 values when every argument is a Python number, else an
    fp32 vector of 7 on ``param``'s device, computed there (no host
    sync)."""
    vals = (lr, beta1, beta2, epsilon, weight_decay, step)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        lr, b1, b2, eps, wd, t = (np.float32(v) for v in vals)
        one = np.float32(1.0)
        return (lr, b1, b2, eps, wd, one - b1 ** t, one - b2 ** t)
    lr, b1, b2, eps, wd, t = (
        v.to(device=param.device, dtype=torch.float32).reshape(())
        if isinstance(v, torch.Tensor) else
        torch.full((), float(v), dtype=torch.float32, device=param.device)
        for v in vals)
    return torch.stack([lr, b1, b2, eps, wd, 1 - b1 ** t, 1 - b2 ** t])


def _check(param, grad, m, v):
    for name, t in (("param", param), ("grad", grad)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32, bfloat16 or float16, "
                            f"got {t.dtype}")
    for name, t in (("grad", grad), ("m", m), ("v", v)):
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name} must have param's shape "
                             f"{tuple(param.shape)}, got {tuple(t.shape)}")
        if t.device != param.device:
            raise ValueError(f"{name} is on {t.device}, param on "
                             f"{param.device}")
    for name, t in (("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("param", param), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: it is updated in "
                             f"place")
    if param.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adamw_update runs on CUDA or the CPU, got "
                         f"{param.device}")


@torch.no_grad()
def fused_adamw_update_plain(param, grad, m, v, lr, beta1, beta2, epsilon,
                             weight_decay, step):
    """Plain version of the kernel: the same update in fp32 PyTorch, one
    operation at a time, in place. Returns (param, m, v)."""
    fused_adamw_update_plain.calls += 1
    _check(param, grad, m, v)
    h = hyperparameters(param, lr, beta1, beta2, epsilon, weight_decay,
                        step)
    if isinstance(h, tuple):
        h = torch.tensor([float(x) for x in h], dtype=torch.float32,
                         device=param.device)
    lr, b1, b2, eps, wd, bc1, bc2 = h.unbind()
    p, g = param.float(), grad.float()
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * p
    param.copy_(p - lr * update)
    m.copy_(m_new)
    v.copy_(v_new)
    return param, m, v


fused_adamw_update_plain.calls = 0


@torch.no_grad()
def fused_adamw_update(param, grad, m, v, lr, beta1, beta2, epsilon,
                       weight_decay, step):
    """One AdamW step on one tensor, IN PLACE: param (any float dtype),
    m and v (fp32, param's shape) are overwritten, as the JAX kernel's
    donated buffers are, and returned as (param, m, v). grad is any
    float dtype. ``lr`` and ``step`` (and the others) may be tensors: the
    kernel then reads its hyperparameters from the card, with no host
    sync. Non-contiguous or mis-typed state is refused, never copied.
    The kernel for CUDA tensors (``paddle_adamw``), the plain version
    for CPU tensors."""
    _check(param, grad, m, v)
    if param.device.type == "cpu":
        return fused_adamw_update_plain(param, grad, m, v, lr, beta1, beta2,
                                        epsilon, weight_decay, step)
    if param.numel() == 0:
        return param, m, v
    h = hyperparameters(param, lr, beta1, beta2, epsilon, weight_decay,
                        step)
    on_host = isinstance(h, tuple)
    g = grad.contiguous()
    with torch.cuda.device(param.device):
        err = _build.library("fused_adamw", _SIG).paddle_adamw(
            param.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            param.numel(), _DTYPE_CODES[param.dtype], _DTYPE_CODES[g.dtype],
            None if on_host else h.data_ptr(),
            *(float(x) for x in (h if on_host else (0.0,) * 7)),
            torch.cuda.current_stream(param.device).cuda_stream)
    _build.raise_on(err, "fused_adamw_update")
    fused_adamw_update.launches += 1
    return param, m, v


fused_adamw_update.launches = 0


def reset_counts():
    """Zero the launch and plain-call counters."""
    fused_adamw_update.launches = 0
    fused_adamw_update_plain.calls = 0
