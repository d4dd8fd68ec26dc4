"""Loss functionals (the JAX package's ``nn/functional/loss.py``)."""
from __future__ import annotations

import torch


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, label_smoothing: float = 0.0):
    """Softmax cross entropy of logits ``input`` along ``axis``.

    Hard labels (index tensors, optionally with a trailing 1 on
    ``axis``) skip ``ignore_index``; ``reduction="mean"`` divides by the
    count of kept labels (at least 1). Soft labels are distributions
    over ``axis``. Per-class ``weight`` and ``label_smoothing`` are not
    ported yet (ROADMAP A2) and raise."""
    if weight is not None or label_smoothing:
        raise NotImplementedError(
            "cross_entropy weight / label_smoothing are not ported yet "
            "(ROADMAP A2)")
    logp = torch.log_softmax(input, dim=axis)
    if soft_label:
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    lbl = label
    if lbl.dim() == logp.dim():              # [..., 1] index labels
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    return _reduce(nll, reduction)
