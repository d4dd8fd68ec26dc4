"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``core``, ``ops``, ``autograd``, ``device``, ``framework``, ``nn``,
``kernels``, ``models``, ``generation``, ``inference``, ``serving``,
``optimizer``, ``jit``, ``amp``, ``regularizer``, ``quantization``,
``distributed``) and imports torch, never jax and nothing of
``paddle_tpu``. Every TPU kernel on a ported path is a kernel written
by hand for Hopper (``csrc/``), beside its plain PyTorch version. Entry
points run on the first CUDA card unless the caller passes
``device="cpu"`` (or ``set_device("cpu")``); without a card they raise.

The eager surface: ``Tensor`` (a ``torch.Tensor`` subclass), ``Parameter``,
``to_tensor`` and the ops of ``ops/`` at top level, ``backward``,
``grad``, ``PyLayer``. The models, the engines and ``jit.TrainStep``
take and make plain torch tensors.
"""
__version__ = "0.1.0"

from . import amp, regularizer  # noqa: F401
from .core import dtype as _dtype_mod
from .core.device import get_device, set_device  # noqa: F401
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa: F401
                         float16, float32, float64, int8, int16, int32,
                         int64, uint8)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.random import get_states as get_rng_state  # noqa: F401
from .core.random import seed  # noqa: F401
from .core.random import set_states as set_rng_state  # noqa: F401
from .core.tensor import (Parameter, Tensor, enable_grad,  # noqa: F401
                          is_grad_enabled, no_grad, set_grad_enabled,
                          to_tensor)

from . import ops  # noqa: F401,E402  (installs the Tensor methods)
from .ops.creation import (arange, assign, bernoulli, create_parameter,  # noqa: F401,E402
                           diag, diagflat, empty, empty_like, eye, full,
                           full_like, linspace, logspace, meshgrid,
                           multinomial, normal, ones, ones_like, poisson,
                           rand, randint, randint_like, randn, randperm,
                           standard_normal, tril, tril_indices, triu,
                           triu_indices, uniform, zeros, zeros_like)
from .ops.linalg import (bincount, bmm, cross, dist, dot,  # noqa: F401,E402
                         einsum, histogram, matmul, mm, mv, t, tensordot)
from .ops.manipulation import (argsort, as_complex, as_real,  # noqa: F401,E402
                               broadcast_shape, broadcast_tensors,
                               broadcast_to, bucketize, chunk, complex,
                               concat, crop, diag_embed, diff, expand,
                               expand_as, fill_diagonal,
                               fill_diagonal_tensor, flatten, flip, gather,
                               gather_nd, index_add, index_add_, index_fill,
                               index_sample, index_select, masked_fill,
                               masked_select, moveaxis, nonzero, numel,
                               one_hot, put_along_axis, repeat_interleave,
                               reshape, reshape_, reverse, roll, rot90,
                               scatter, scatter_, scatter_nd,
                               scatter_nd_add, searchsorted, shape,
                               shard_index, slice, sort, split, squeeze,
                               squeeze_, stack, strided_slice, take,
                               take_along_axis, tanh_, tile, topk,
                               transpose, unbind, unique,
                               unique_consecutive, unsqueeze, unsqueeze_,
                               unstack, vsplit, where)
from .ops.math import (abs, acos, acosh, add, add_n, addmm, all,  # noqa: F401,E402
                       allclose, amax, amin, angle, any, argmax, argmin,
                       asin, asinh, atan, atan2, atanh, bitwise_and,
                       bitwise_not, bitwise_or, bitwise_xor, cast, ceil,
                       clip, clone, conj, cos, cosh, count_nonzero, cummax,
                       cummin, cumprod, cumsum, deg2rad, diagonal, digamma,
                       divide, equal, equal_all, erf, erfinv, exp, expm1,
                       floor, floor_divide, fmax, fmin, frac, frexp, gcd,
                       greater_equal, greater_than, heaviside, hypot, imag,
                       increment, inner, isclose, isfinite, isinf, isnan,
                       kron, kthvalue, lcm, lerp, less_equal, less_than,
                       lgamma, log, log10, log1p, log2, logaddexp,
                       logcumsumexp, logical_and, logical_not, logical_or,
                       logical_xor, logit, logsumexp, max, maximum, mean,
                       median, min, minimum, mod, mode, multiplex,
                       multiply, nanmean, nanmedian, nanquantile, nansum,
                       neg, not_equal, outer, pow, prod, quantile, rad2deg,
                       real, reciprocal, remainder, renorm, round, rsqrt,
                       scale, sgn, sign, sin, sinh, sqrt, square, stanh,
                       std, subtract, sum, tan, tanh, trace, trunc, var,
                       vander)
from .ops.math import mod as floor_mod  # noqa: F401,E402
from .framework import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401,E402
                        DataParallel, LazyGuard, NPUPlace, batch,
                        check_shape, disable_signal_handler, finfo,
                        get_cuda_rng_state, iinfo, is_complex, is_empty,
                        is_floating_point, is_integer, is_tensor, rank,
                        set_cuda_rng_state, set_printoptions, tolist)
from .core.dtype import bool_ as bool  # noqa: F401,E402,A001

from . import autograd, device, jit, nn  # noqa: F401,E402
from .nn import ParamAttr  # noqa: F401,E402
from .device import (device_count, is_compiled_with_tpu,  # noqa: F401,E402
                     synchronize)
from .jit.api import grad, value_and_grad  # noqa: F401,E402

get_default_dtype = _dtype_mod.get_default_dtype
set_default_dtype = _dtype_mod.set_default_dtype
dtype = _dtype_mod.convert_dtype  # paddle.dtype('float32')

# paddle.enable_static / disable_static track the intent for
# in_dynamic_mode(); the static graph itself is ROADMAP A13
_static_mode = False


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static():
    global _static_mode
    _static_mode = False


def in_dynamic_mode() -> bool:
    return not _static_mode


def get_cudnn_version():
    """cuDNN's version as torch reports it (None without cuDNN)."""
    import torch
    return torch.backends.cudnn.version()
