"""The functional op namespace (the JAX package's ``ops/``); importing it
installs the Paddle methods on ``core.tensor.Tensor`` (and only there:
``torch.Tensor`` and ``torch.nn.Parameter`` stay as they are)."""
from __future__ import annotations

import torch

from . import creation, linalg, manipulation, math
from . import validators  # noqa: F401  (registers the enforce checks)
from .op_registry import OPS, dispatch, get_op, op  # noqa: F401
from ..core.tensor import Tensor

# ---- method aliases on Tensor (the JAX package's table) -----------------

_METHOD_SOURCES = {
    math: [
        "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
        "pow", "maximum", "minimum", "abs", "sqrt", "rsqrt", "square", "exp",
        "log", "log2", "log10", "log1p", "sin", "cos", "tan", "tanh", "floor",
        "ceil", "round", "sign", "reciprocal", "erf", "clip", "scale", "cast",
        "cumsum", "cumprod", "sum", "mean", "max", "min", "prod", "std",
        "var", "logsumexp", "all", "any", "argmax", "argmin", "isnan",
        "isinf", "isfinite", "allclose", "equal_all", "trace", "lerp",
        "nan_to_num", "count_nonzero", "median", "clone", "equal",
        "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal", "logical_and", "logical_or", "logical_not",
        "acos", "acosh", "asin", "asinh", "atan", "atanh", "sinh", "cosh",
        "atan2", "add_n", "addmm", "amax", "amin", "angle", "conj", "real",
        "imag", "deg2rad", "rad2deg", "digamma", "lgamma", "erfinv",
        "expm1", "fmax", "fmin", "frac", "frexp", "gcd", "lcm", "heaviside",
        "increment", "inner", "outer", "isclose", "kron", "kthvalue",
        "logit", "logcumsumexp", "logical_xor", "mod", "mode", "multiplex",
        "nanmean", "nanmedian", "nanquantile", "nansum", "neg", "quantile",
        "sgn", "stanh", "trunc", "diagonal", "cummax", "cummin", "hypot",
        "vander", "renorm", "bitwise_and", "bitwise_or", "bitwise_xor",
        "bitwise_not",
    ],
    manipulation: [
        "reshape", "flatten", "squeeze", "unsqueeze", "split", "chunk",
        "transpose", "tile", "expand", "expand_as", "broadcast_to", "flip",
        "roll", "gather", "gather_nd", "scatter", "scatter_nd_add",
        "index_select", "masked_select", "masked_fill", "topk", "sort",
        "argsort", "unbind", "numel", "unique", "repeat_interleave",
        "take_along_axis", "put_along_axis", "moveaxis", "nonzero", "pad",
        "as_complex", "as_real", "broadcast_shape", "broadcast_tensors",
        "bucketize", "concat", "diff", "index_add", "index_sample",
        "index_fill", "reverse", "rot90", "scatter_nd", "shard_index",
        "slice", "stack", "strided_slice", "take", "unique_consecutive",
        "unstack", "vsplit", "swapaxes", "searchsorted", "where", "one_hot",
        # the module-level in-place functions double as methods
        "reshape_", "squeeze_", "unsqueeze_", "scatter_", "index_add_",
        "tanh_",
    ],
    linalg: [
        "matmul", "mm", "bmm", "dot", "mv", "norm", "dist", "cholesky",
        "inverse", "det", "matrix_power", "pinv", "solve", "qr", "svd", "t",
        "cross", "bincount", "histogram", "cond", "corrcoef", "cov", "eig",
        "eigvals", "eigvalsh", "cholesky_solve", "triangular_solve",
        "lstsq", "lu", "lu_unpack", "multi_dot", "tensordot",
    ],
    creation: ["tril", "triu", "zeros_like", "ones_like", "full_like"],
}

# The JAX Tensor takes a method only where it has none of that name yet;
# here every name replaces torch's own (Paddle's signature, not torch's):
# torch.Tensor defines most of them.
for _module, _names in _METHOD_SOURCES.items():
    for _name in _names:
        _fn = getattr(_module, _name, None)
        if _fn is not None and _name not in Tensor.__dict__:
            setattr(Tensor, _name, _fn)

# framework predicates as methods (the reference registers them too)
from .. import framework as _framework  # noqa: E402

for _n in ("is_complex", "is_empty", "is_floating_point", "is_integer",
           "is_tensor", "rank"):
    if _n not in Tensor.__dict__:
        setattr(Tensor, _n, getattr(_framework, _n))


def _astype(self, dtype):
    return math.cast(self, dtype)   # an int or bool target detaches


Tensor.astype = _astype
Tensor.cast = _astype


# ---- trailing-underscore in-place variants ------------------------------
# the out-of-place op on a snapshot of the tensor (so the op's autograd
# record keeps the value before the write, as the JAX package's snapshot
# does), then Tensor._adopt writes the result into the tensor

def _make_inplace(base_name):
    def inplace(self, *args, **kwargs):
        src = self
        with torch._C.DisableTorchFunctionSubclass():
            needs_snapshot = torch.is_grad_enabled() and self.requires_grad
        if needs_snapshot:
            src = math.clone(self)
        return self._adopt(getattr(Tensor, base_name)(src, *args, **kwargs))

    inplace.__name__ = base_name + "_"
    return inplace


_INPLACE_BASES = [
    "add", "subtract", "ceil", "clip", "exp", "floor", "erfinv",
    "lerp", "reciprocal", "remainder", "round", "rsqrt", "scale",
    "sqrt", "flatten", "put_along_axis",
]
for _b in _INPLACE_BASES:
    if _b + "_" not in Tensor.__dict__:
        setattr(Tensor, _b + "_", _make_inplace(_b))


def _uniform_(self, min=-1.0, max=1.0, seed=0):
    """In-place uniform refill (the reference's Tensor.uniform_)."""
    new = creation.uniform(self.shape, dtype=self.dtype, min=min, max=max,
                           seed=seed)
    return self._adopt(new.detach())


def _exponential_(self, lam=1.0):
    """In-place exponential refill: -log(U)/lam."""
    u = creation.uniform(self.shape, dtype=self.dtype, min=1e-7, max=1.0)
    return self._adopt(math.log(u.detach()) * (-1.0 / lam))


Tensor.uniform_ = _uniform_
Tensor.exponential_ = _exponential_
Tensor.floor_mod = Tensor.remainder   # the reference's alias
