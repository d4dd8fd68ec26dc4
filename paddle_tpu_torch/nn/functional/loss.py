"""Loss functionals (the JAX package's ``nn/functional/loss.py``).

Each keeps the JAX function's own reduction rule: ``cross_entropy`` and
``nll_loss`` divide a "mean" by the kept labels (or their weights),
``kl_div`` also takes "batchmean", ``ctc_loss`` averages each sequence's
loss over its label length, and the rest take the plain mean or sum
of ``_reduce``. Any other reduction, "none" or not, returns the
unreduced loss, as in the JAX package. ``ctc_loss`` runs
``torch.nn.functional.ctc_loss`` on the log-softmax of its input (the
JAX package calls ``optax.ctc_loss``, which normalizes its input the
same way).
``edit_distance`` is a metric: no gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss         # "none", and any other word, as the JAX package


def _zero(t):
    return torch.zeros_like(t)


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, label_smoothing: float = 0.0):
    """Softmax cross entropy of logits ``input`` along ``axis``.

    Hard labels (index tensors, optionally with a trailing 1 on
    ``axis``) skip ``ignore_index``; ``label_smoothing`` mixes the
    label's NLL with the mean NLL over the classes. Per-class ``weight``
    scales each kept label's loss, and "mean" then divides by the kept
    labels' weights (at least 1e-12), else by the count of kept labels
    (at least 1). Soft labels are distributions over ``axis``, smoothed
    toward uniform; ``weight`` and ``ignore_index`` do not apply to
    them."""
    logp = torch.log_softmax(input, dim=axis)
    k = input.shape[axis]
    if soft_label:
        tgt = label
        if label_smoothing > 0.0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / k
        return _reduce(-(tgt * logp).sum(dim=axis), reduction)
    lbl = label
    if lbl.dim() == logp.dim():              # [..., 1] index labels
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, _zero(lbl)).long()
    nll = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=axis)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    if weight is not None:
        w = weight[safe]
        nll = torch.where(valid, nll * w, _zero(nll))
        if reduction == "mean":
            return nll.sum() / torch.where(valid, w, _zero(w)).sum() \
                .clamp_min(1e-12)
        return _reduce(nll, reduction)
    nll = torch.where(valid, nll, _zero(nll))
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    return _reduce(nll, reduction)


softmax_with_cross_entropy = cross_entropy


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """Negative log likelihood of log-probabilities ``input`` [..., C] at
    ``label`` [...], skipping ``ignore_index``. A weighted "mean" divides
    by the kept labels' weights (no floor, as in the JAX package), an
    unweighted one by their count (at least 1)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, _zero(label)).long()
    picked = -input.gather(-1, safe[..., None])[..., 0]
    if weight is not None:
        w = weight[safe]
        picked = torch.where(valid, picked * w, _zero(picked))
        if reduction == "mean":
            return picked.sum() / torch.where(valid, w, _zero(w)).sum()
    picked = torch.where(valid, picked, _zero(picked))
    if reduction == "mean":
        return picked.sum() / valid.sum().clamp_min(1)
    return _reduce(picked, reduction)


def mse_loss(input, label, reduction: str = "mean"):
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction: str = "mean"):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction: str = "mean", delta=1.0):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """BCE of probabilities ``input``, each log clamped at 1e-12."""
    eps = 1e-12
    loss = -(label * torch.log(input.clamp_min(eps))
             + (1 - label) * torch.log((1 - input).clamp_min(eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """BCE of logits in the stable form max(x, 0) - x*y + log1p(e^-|x|);
    ``pos_weight`` scales the loss by (pos_weight - 1)*y + 1."""
    loss = logit.clamp_min(0.0) - logit * label + \
        torch.log1p(torch.exp(-logit.abs()))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1.0) * label + 1.0)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean"):
    """label * (log label - input), log clamped at 1e-12; "batchmean"
    divides the sum by the batch size."""
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce((-label * (input - other) + margin).clamp_min(0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input, (margin - input).clamp_min(0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1)).clamp_min(1e-12)
    loss = torch.where(label == 1, 1.0 - cos, (cos - margin).clamp_min(0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def pdist(a, b):
        return ((a - b).abs() + epsilon).pow(p).sum(-1).pow(1.0 / p)

    d_pos = pdist(input, positive)
    d_neg = pdist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, pdist(positive, negative))
    return _reduce((d_pos - d_neg + margin).clamp_min(0.0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum"):
    p = torch.sigmoid(logit)
    ce = logit.clamp_min(0.0) - logit * label + \
        torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t).pow(gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def square_error_cost(input, label):
    return (input - label).square()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """CTC loss of ``log_probs`` [T, B, C] (normalized over C first, as
    ``optax.ctc_loss`` does) against padded ``labels`` [B, L]: the
    negative log likelihood of each sequence; "mean" is the mean of
    loss / label length (at least 1)."""
    lp = torch.log_softmax(log_probs, dim=-1)
    loss = TF.ctc_loss(lp, labels.long(), input_lengths.long(),
                       label_lengths.long(), blank=blank, reduction="none")
    if reduction == "mean":
        return (loss / label_lengths.to(loss.dtype).clamp_min(1)).mean()
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean"):
    """log(1 + exp(-label * input)), label in {-1, 1}, in the stable
    softplus form."""
    z = -label.to(input.dtype) * input
    return _reduce(z.clamp_min(0) + torch.log1p(torch.exp(-z.abs())),
                   reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    y = label.to(input.dtype)
    term = y * TF.logsigmoid(input) + (1 - y) * TF.logsigmoid(-input)
    if weight is not None:
        term = term * weight
    return _reduce(-term.mean(-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    c = input.shape[1]
    lbl = label.long()
    gold = input.gather(1, lbl[:, None])
    diff = (margin - gold + input).clamp_min(0.0)
    if p != 1:
        diff = diff ** p
    if weight is not None:
        diff = diff * weight[lbl][:, None]
    mask = torch.arange(c, device=input.device)[None, :] != lbl[:, None]
    return _reduce((diff * mask).sum(1) / c, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean"):
    """Triplet loss with a distance callable on torch tensors (default:
    sqrt(sum((u - v)^2) + 1e-12) over the last dim)."""
    def dist(u, v):
        if distance_function is None:
            return torch.sqrt((u - v).square().sum(-1) + 1e-12)
        return distance_function(u, v)

    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None):
    """Hierarchical sigmoid over the default complete binary tree: class
    c's path runs through the internal nodes (c + num_classes) / 2^k,
    and its cost is the summed binary cross entropy along the path.
    Returns [N, 1] fp32."""
    n = input.shape[0]
    code_len = int(math.ceil(math.log2(max(num_classes, 2)))) + 1
    node = label.long().reshape(-1) + num_classes
    losses = torch.zeros((n,), dtype=torch.float32, device=input.device)
    for _ in range(code_len):
        parent = node // 2
        active = node > 1                        # has a parent edge
        is_right = (node % 2).to(torch.float32)
        idx = (parent - 1).clamp(0, num_classes - 2)
        logit = (weight[idx] * input).sum(-1)
        if bias is not None:
            logit = logit + bias[idx]
        ce = logit.clamp_min(0) - logit * is_right + \
            torch.log1p(torch.exp(-logit.abs()))
        losses = losses + torch.where(active, ce, _zero(ce))
        node = parent
    return losses[:, None]


def _drop_tokens(arr, lens, ignored):
    rows = [[t for t in r[:ln] if int(t) not in ignored]
            for r, ln in zip(arr.tolist(), lens.tolist())]
    width = max(max(len(r) for r in rows), 1)
    out = torch.zeros((len(rows), width), dtype=torch.int64,
                      device=arr.device)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.tensor(r, dtype=torch.int64)
    return out, torch.tensor([len(r) for r in rows], dtype=torch.int32,
                             device=arr.device)


@torch.no_grad()
def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance per batch row between token ids ``input`` [B,
    Sa] and ``label`` [B, Sb] (their first ``input_length`` /
    ``label_length`` tokens, after dropping ``ignored_tokens``), divided
    by the label length (at least 1) when ``normalized``. Returns
    (distance [B, 1] fp32, sequence count [1] fp32). Each DP row is
    closed-form, row[j] = j + cummin(cand - j), as in the JAX package."""
    a, b = input.long(), label.long()
    bsz, sa = a.shape
    sb = b.shape[1]
    dev = a.device
    la = input_length.long() if input_length is not None \
        else torch.full((bsz,), sa, dtype=torch.int64, device=dev)
    lb = label_length.long() if label_length is not None \
        else torch.full((bsz,), sb, dtype=torch.int64, device=dev)
    if ignored_tokens:
        ign = {int(t) for t in ignored_tokens}
        a, la = _drop_tokens(a, la, ign)
        b, lb = _drop_tokens(b, lb, ign)
        la, lb = la.long(), lb.long()
        sa, sb = a.shape[1], b.shape[1]
    jot = torch.arange(sb + 1, dtype=torch.float32, device=dev)
    row = jot.expand(bsz, sb + 1)
    rows = [row]
    for i in range(sa):
        cost = (a[:, i:i + 1] != b).to(torch.float32)
        cand = torch.cat([row[:, :1] + 1.0,
                          torch.minimum(row[:, 1:] + 1.0,
                                        row[:, :-1] + cost)], dim=1)
        row = jot + torch.cummin(cand - jot, dim=1).values
        rows.append(row)
    table = torch.stack(rows, dim=1)                 # [B, sa + 1, sb + 1]
    dist = table[torch.arange(bsz, device=dev), la, lb]
    if normalized:
        dist = dist / lb.to(torch.float32).clamp_min(1.0)
    return dist[:, None], torch.tensor([bsz], dtype=torch.float32,
                                       device=dev)
