"""Normalization functionals (the JAX package's ``nn/functional/norm.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims. Statistics
    are computed in fp32 for bf16 inputs, the normalized value is cast
    back to the input dtype, then scaled and shifted — the JAX package's
    order of operations. On the CPU the statistics are the JAX package's
    two-pass mean and variance (bitwise). On a CUDA card they come from
    one ``torch.nn.functional.layer_norm`` without affine, whose kernel
    gives every row one block of a fixed size, so a row's bits do not
    depend on how many rows the call holds: two ``mean`` reductions would
    spread a row over more threads the fewer rows there are, and a
    serving batch would drift from batch-1 ``generate``."""
    x, weight, bias = amp.maybe_cast("layer_norm", x, weight, bias)
    if normalized_shape is None:
        ndims = 1
    else:
        ndims = 1 if isinstance(normalized_shape, int) else \
            len(tuple(normalized_shape))
    dims = tuple(range(x.dim() - ndims, x.dim()))
    xf = x.float() if x.dtype == torch.bfloat16 else x
    if xf.is_cuda:
        out = TF.layer_norm(xf, xf.shape[x.dim() - ndims:],
                            eps=epsilon).to(x.dtype)
    else:
        mean = xf.mean(dim=dims, keepdim=True)
        var = (xf - mean).square().mean(dim=dims, keepdim=True)
        out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out



def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """RMSNorm over the last dim: x / sqrt(mean(x^2) + eps), computed in
    fp32 for bf16 inputs, cast back to the input dtype, then scaled —
    the JAX package's cast and scale order. On the CPU it is the JAX
    package's ``mean`` of the squares and division (bitwise). On a CUDA
    card the normalized row comes from one ``torch.nn.functional.
    rms_norm`` without weight, whose kernel reduces every row in one
    block of a fixed size, so a row's bits do not depend on how many
    rows the call holds (a ``mean`` spreads a row over more threads the
    fewer rows there are, as ``layer_norm`` did). That kernel multiplies
    by rsqrt(mean + eps) instead of dividing by sqrt(mean + eps), which
    can move the fp32 value by an ulp before the cast."""
    x, weight = amp.maybe_cast("rms_norm", x, weight)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    if xf.is_cuda:
        out = TF.rms_norm(xf, xf.shape[-1:], eps=epsilon).to(x.dtype)
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = (xf / torch.sqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out

def _channel_shape(x, data_format):
    """The channel axis of ``x`` and the shape a [C] vector broadcasts
    in (channels at 1 for NC* layouts, last for N*C layouts)."""
    ch = 1 if data_format.startswith("NC") and x.dim() > 1 else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return ch, shape


def batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                     epsilon: float = 1e-5, data_format: str = "NCHW"):
    """BN with the running statistics: (x - mean) / sqrt(var + eps),
    then weight and bias, in the promoted dtype of x and the stats."""
    x, running_mean, running_var, weight, bias = amp.maybe_cast(
        "batch_norm_infer", x, running_mean, running_var, weight, bias)
    _, shape = _channel_shape(x, data_format)
    out = (x - running_mean.reshape(shape)) / torch.sqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm_train(x, weight=None, bias=None, epsilon: float = 1e-5,
                     data_format: str = "NCHW"):
    """BN with the batch statistics. Returns (out, batch mean, batch
    var); the running-statistic update is the layer's. Statistics and
    the normalization are fp32 for bf16 inputs, the normalized value is
    cast to the input dtype, then scaled and shifted in that dtype (the
    JAX package's order of rounding)."""
    x, weight, bias = amp.maybe_cast("batch_norm_train", x, weight, bias)
    ch, shape = _channel_shape(x, data_format)
    axes = tuple(a for a in range(x.dim()) if a != ch)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False)
    out = ((xf - mean.reshape(shape))
           / torch.sqrt(var.reshape(shape) + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var
