"""Weight-decay regularizers (the JAX package's ``regularizer.py``).

A regularizer is folded into the gradient inside the optimizer update:
``L1Decay(c)`` adds ``c * sign(p)``, ``L2Decay(c)`` adds ``c * p`` (the
reference's convention), the coefficient in the gradient's dtype. Pass
one as an optimizer's ``weight_decay``, or set it as the ``regularizer``
attribute of a parameter, which then wins over the optimizer's
``weight_decay`` for that parameter (``ParamAttr(regularizer=...)``,
which sets it in the reference, is ROADMAP A2).
"""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


def _coeff(c, grad):
    return torch.tensor(c, dtype=grad.dtype, device=grad.device)


class L1Decay:
    """loss += coeff * sum(|p|), so grad += coeff * sign(p)."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __call__(self, grad, param):
        return grad + _coeff(self._coeff, grad) * torch.sign(param).to(
            grad.dtype)

    def __repr__(self):
        return f"L1Decay(coeff={self._coeff})"


class L2Decay:
    """loss += coeff/2 * sum(p^2), so grad += coeff * p."""

    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __call__(self, grad, param):
        return grad + _coeff(self._coeff, grad) * param.to(grad.dtype)

    def __repr__(self):
        return f"L2Decay(coeff={self._coeff})"
