"""Fused conv + BN training functionals (NHWC), backed by
``kernels.fused_resnet`` (the JAX package's
``nn/functional/fused_conv.py:17-94``, without its ops registry).
Weights and BN parameters are taken as plain views
(``core.tensor.plain``), so a ``Parameter`` reaches the kernels'
wrappers as a torch tensor."""
from __future__ import annotations

from ...core.tensor import plain as _p
from ...kernels import fused_resnet as _k


def conv1x1_bn_stats(x, weight, stride=1):
    """NHWC 1x1 conv + batch statistics of its output in one pass.
    weight is the Paddle-layout [O, I, 1, 1] kernel. Returns (y, mean,
    var) with fp32 statistics."""
    return _k.conv1x1_bn_stats(x, _p(weight), stride=stride)


def bn_relu_conv1x1_bn_stats(x, scale, shift, weight):
    """relu(x*scale + shift) -> NHWC 1x1 conv -> batch statistics of the
    output; the normalized activation is never written. scale/shift are
    the folded BN affine (``bn_fold``). Returns (y, mean, var)."""
    return _k.bn_relu_conv1x1_bn_stats(x, scale, shift, _p(weight))


def bn_relu_conv3x3_bn_stats(x, scale, shift, weight):
    """relu(x*scale + shift) -> 3x3/s1 SAME conv (NHWC) -> batch
    statistics of the output in one pass; the normalized activation is
    never written. weight is the Paddle-layout [O, I, 3, 3] kernel.
    Returns (y, mean, var) with fp32 statistics."""
    return _k.bn_relu_conv3x3_bn_stats(x, scale, shift, _p(weight))


def bn_apply_relu_add(y, scale, shift, identity):
    """relu(bf16(y*scale + shift) + identity), residual-lean backward."""
    return _k.bn_apply_relu_add(y, scale, shift, identity)


def bn_apply_relu(y, scale, shift):
    """relu(bf16(y*scale + shift)), residual-lean backward."""
    return _k.bn_apply_relu(y, scale, shift)


def bn_apply(y, scale, shift):
    """bf16(y*scale + shift), residual-lean backward."""
    return _k.bn_apply(y, scale, shift)


def bn_center_apply_relu_add(y, mean, scale, beta, identity):
    """relu(bf16((y - mean)*scale + beta) + identity): the closing apply
    in centered form (scale = gamma*rsqrt(var + eps))."""
    return _k.bn_center_apply_relu_add(y, mean, scale, _p(beta), identity)


def bn_center_apply(y, mean, scale, beta):
    """bf16((y - mean)*scale + beta): centered apply, no relu."""
    return _k.bn_center_apply(y, mean, scale, _p(beta))


def bn_moments(y):
    """Channel-last batch mean/var (fp32), residual-lean backward."""
    return _k.bn_moments(y)


def bn_fold(gamma, beta, mean, var, epsilon=1e-5):
    """BN parameters and batch statistics folded into fp32 (scale,
    shift): bn(y) = y*scale + shift."""
    return _k.bn_fold(_p(gamma), _p(beta), mean, var, epsilon)
