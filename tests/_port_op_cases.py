"""The op cases of the port's parity checks: numpy only.

Every op that ``paddle_tpu/ops/{creation,math,manipulation,linalg}.py``
registers in ``OPS``, and every ``nn`` op the port registers (the
activations, ``linear``, ``embedding``, ``scaled_dot_product_attention``),
has a case here: numpy inputs made from one seed,
its arguments, which operand to differentiate, and its tolerance class.
This module imports numpy alone, so that ``chip_smoke.py`` can run the
same cases on the card without the JAX package;
``tests/_port_op_parity.py`` runs them through both packages.

Tolerances (absolute and relative, per element):
- ``EXACT`` ops (data movement, comparisons, the same elementwise
  arithmetic in the same order): values bitwise equal;
- other fp32 ops: 1e-6;
- transcendentals, reductions over rows and linear algebra (``TR``):
  1e-5; decompositions through their reconstructions where signs are
  free (``eigvals`` as a sorted set);
- gradients: 1e-6, or 1e-5 for ``TR`` ops.
Integer, boolean and dtype results are equal.
"""
import numpy as np

rng = np.random.RandomState(0)
T34 = rng.randn(3, 4).astype(np.float32)
B34 = rng.randn(3, 4).astype(np.float32)
U34 = rng.randn(3, 4).astype(np.float32)
POS = (np.abs(rng.randn(3, 4)) + 0.2).astype(np.float32)
POS2 = (np.abs(rng.randn(3, 4)) * 0.5 + 0.1).astype(np.float32)
UNIT = (rng.rand(3, 4) * 0.8 + 0.1).astype(np.float32)
GT1 = (rng.rand(3, 4) * 2 + 1.1).astype(np.float32)
SYM = (lambda m: (m + m.T) / 2 + 4 * np.eye(4, dtype=np.float32))(
    rng.randn(4, 4).astype(np.float32))
M45 = rng.randn(4, 5).astype(np.float32)
M52 = rng.randn(5, 2).astype(np.float32)
B42 = rng.randn(4, 2).astype(np.float32)
C35 = rng.randn(3, 5).astype(np.float32)
I34 = rng.randint(0, 4, (3, 4)).astype(np.int64)
I34B = rng.randint(1, 9, (3, 4)).astype(np.int64)
I3 = np.array([0, 2, 1], np.int64)
BOOL = rng.rand(3, 4) > 0.5
BOOL2 = rng.rand(3, 4) > 0.5
NAN = T34.copy()
NAN[0, 0], NAN[1, 1], NAN[2, 2] = np.nan, np.inf, -np.inf
REP = rng.randint(0, 3, (3, 6)).astype(np.float32)
T234 = rng.randn(2, 3, 4).astype(np.float32)
A33 = rng.randn(3, 3).astype(np.float32)
B33 = rng.randn(3, 3).astype(np.float32)
SORTED = np.sort(rng.randn(3, 5).astype(np.float32), axis=1)
IDX32 = np.stack([rng.permutation(4)[:2] for _ in range(3)]).astype(
    np.int64)
TALL = rng.randn(6, 3).astype(np.float32)
Y6 = rng.randn(6, 2).astype(np.float32)
CPLX = (rng.randn(3, 4) + 1j * rng.randn(3, 4)).astype(np.complex64)
IMG4 = rng.randn(4, 4, 3, 3).astype(np.float32)

# name -> (args, kwargs[, options]); options: "grad" (the operand index
# to differentiate, None for none), "sorted" (compare as a sorted set)
CASES = {
    # ---------------------------------------------------------- creation
    "zeros_like": ([T34], {}),
    "ones_like": ([T34], {"dtype": "int32"}),
    "full_like": ([T34, 2.5], {}),
    "tril": ([T34], {"diagonal": 1}),
    "triu": ([T34], {}),
    # -------------------------------------------------------------- math
    "add": ([T34, B34], {}),
    "subtract": ([T34, B34], {}),
    "multiply": ([T34, B34], {}),
    "divide": ([POS, POS2], {}),
    "floor_divide": ([POS * 3, POS2], {}),
    "remainder": ([POS * 3, POS2], {}),
    "pow": ([POS, POS2], {}),
    "maximum": ([T34, B34], {}),
    "minimum": ([T34, B34], {}),
    "fmax": ([NAN, B34], {}),
    "fmin": ([NAN, B34], {}),
    "atan2": ([T34, B34], {}),
    "logaddexp": ([T34, B34], {}),
    "heaviside": ([T34, B34], {}),
    "lerp": ([T34, B34, 0.3], {}),
    "inner": ([T34, B34], {}),
    "outer": ([T34, B34], {}),
    "kron": ([T34, A33], {}),
    "gcd": ([I34, I34B], {}),
    "lcm": ([I34, I34B], {}),
    "equal": ([T34, np.where(BOOL, T34, B34)], {}),
    "not_equal": ([T34, np.where(BOOL, T34, B34)], {}),
    "less_than": ([T34, B34], {}),
    "less_equal": ([T34, np.where(BOOL, T34, B34)], {}),
    "greater_than": ([T34, B34], {}),
    "greater_equal": ([T34, np.where(BOOL, T34, B34)], {}),
    "equal_all": ([T34, T34.copy()], {}),
    "allclose": ([T34, T34 + 1e-7], {}),
    "isclose": ([T34, np.where(BOOL, T34, B34)], {}),
    "logical_and": ([BOOL, BOOL2], {}),
    "logical_or": ([BOOL, BOOL2], {}),
    "logical_not": ([BOOL], {}),
    "logical_xor": ([BOOL, BOOL2], {}),
    "bitwise_and": ([I34, I34B], {}),
    "bitwise_or": ([I34, I34B], {}),
    "bitwise_xor": ([I34, I34B], {}),
    "bitwise_not": ([I34], {}),
    "isnan": ([NAN], {}),
    "isinf": ([NAN], {}),
    "isfinite": ([NAN], {}),
    "abs": ([T34], {}),
    "neg": ([T34], {}),
    "sqrt": ([POS], {}),
    "rsqrt": ([POS], {}),
    "square": ([T34], {}),
    "exp": ([T34], {}),
    "expm1": ([T34], {}),
    "log": ([POS], {}),
    "log2": ([POS], {}),
    "log10": ([POS], {}),
    "log1p": ([POS], {}),
    "sin": ([T34], {}),
    "cos": ([T34], {}),
    "tan": ([T34], {}),
    "asin": ([UNIT], {}),
    "acos": ([UNIT], {}),
    "atan": ([T34], {}),
    "sinh": ([T34], {}),
    "cosh": ([T34], {}),
    "tanh": ([T34], {}),
    "asinh": ([T34], {}),
    "acosh": ([GT1], {}),
    "atanh": ([UNIT], {}),
    "floor": ([T34 * 3], {}),
    "ceil": ([T34 * 3], {}),
    "round": ([T34 * 3], {}),
    "trunc": ([T34 * 3], {}),
    "frac": ([T34 * 3], {}),
    "sign": ([T34], {}),
    "reciprocal": ([POS], {}),
    "erf": ([T34], {}),
    "erfinv": ([UNIT], {}),
    "lgamma": ([POS], {}),
    "digamma": ([POS], {}),
    "deg2rad": ([T34], {}),
    "rad2deg": ([T34], {}),
    "angle": ([T34], {}),
    "conj": ([T34], {}),
    "real": ([T34], {}),
    "imag": ([CPLX], {}, {"grad": None}),
    "nan_to_num": ([NAN], {"nan": 0.5, "posinf": 9.0}),
    "clip": ([T34], {"min": -0.5, "max": 0.5}),
    "scale": ([T34], {"scale": 2.0, "bias": 1.0}),
    "clone": ([T34], {}),
    "increment": ([T34], {"value": 2.0}),
    "stanh": ([T34], {}),
    "multiplex": ([[T34, B34], np.array([[0], [1], [0]], np.int64)], {}),
    "cast": ([T34, "float16"], {}),
    "cumsum": ([T34], {"axis": 1}),
    "cumprod": ([T34], {"dim": 1}),
    "logcumsumexp": ([T34], {"axis": 1}),
    "sum": ([T34], {"axis": 1}),
    "mean": ([T34], {"axis": [0, 1], "keepdim": True}),
    "max": ([T34], {"axis": 1}),
    "min": ([T34], {"axis": 0, "keepdim": True}),
    "prod": ([T34], {"axis": 1}),
    "std": ([T34], {"axis": 1}),
    "var": ([T34], {"axis": 0, "unbiased": False}),
    "nansum": ([T34], {"axis": 1}),
    "nanmean": ([T34], {"axis": 1}),
    "logsumexp": ([T34], {"axis": 1}),
    "all": ([BOOL], {"axis": 1}),
    "any": ([BOOL], {"axis": 0}),
    "argmax": ([T34], {"axis": 1}),
    "argmin": ([T34], {}),
    "count_nonzero": ([BOOL], {"axis": 1}),
    "median": ([T34], {"axis": 1}),
    "quantile": ([T34, 0.3], {"axis": 1}),
    "nanmedian": ([NAN], {"axis": 1}),
    "nanquantile": ([T34, 0.7], {}),
    "trace": ([SYM], {}),
    "diagonal": ([T34], {"offset": 1}),
    "addmm": ([C35, T34, M45], {"beta": 0.5, "alpha": 2.0}),
    "cummax": ([T34], {"axis": 1}),
    "cummin": ([T34], {"axis": 0}),
    "vander": ([T34[0]], {"n": 3}),
    "hypot": ([T34, B34], {}),
    "logit": ([UNIT], {}),
    "sgn": ([T34], {}),
    "frexp": ([T34], {}),
    "add_n": ([[T34, B34, U34]], {}),
    "renorm": ([T34, 2.0, 0, 1.0], {}),
    "kthvalue": ([T34, 2], {"axis": 1}),
    "mode": ([REP], {"axis": 1}),
    # ------------------------------------------------------- manipulation
    "reshape": ([T34, [4, 3]], {}),
    "flatten": ([T234], {"start_axis": 1}),
    "squeeze": ([T34.reshape(3, 1, 4)], {"axis": 1}),
    "unsqueeze": ([T34, [0, -1]], {}),
    "concat": ([[T34, B34]], {"axis": 1}),
    "stack": ([[T34, B34]], {"axis": 1}),
    "vstack": ([[T34, B34]], {}),
    "hstack": ([[T34, B34]], {}),
    "dstack": ([[T34, B34]], {}),
    "transpose": ([T234, [2, 0, 1]], {}),
    "moveaxis": ([T234, 0, 2], {}),
    "swapaxes": ([T34, 0, 1], {}),
    "tile": ([T34, [2, 1]], {}),
    "expand": ([T34[:1], [3, 4]], {}),
    "expand_as": ([T34[:1], T34], {}),
    "flip": ([T34, [0]], {}),
    "roll": ([T34, 1], {"axis": 1}),
    "rot90": ([T34], {}),
    "gather": ([T34, I3], {"axis": 0}),
    "index_select": ([T34, I3], {"axis": 1}),
    "take_along_axis": ([T34, I34[:, :2], 1], {}),
    "put_along_axis": ([T34, IDX32, rng.randn(3, 2).astype(np.float32),
                        1], {}),
    "gather_nd": ([T34, np.array([[0, 1], [2, 3]], np.int64)], {}),
    "scatter": ([T34, I3, U34], {}),
    "scatter_nd_add": ([T34, np.array([[0], [2]], np.int64), U34[:2]], {}),
    "where": ([BOOL, T34, B34], {}, {"grad": 1}),
    "masked_fill": ([T34, BOOL, 0.5], {}),
    "repeat_interleave": ([T34, 2], {"axis": 1}),
    "pad": ([T34, [1, 1, 0, 2]], {}),
    "sort": ([T34], {"axis": 1, "descending": True}),
    "argsort": ([T34], {"axis": 0}),
    "searchsorted": ([SORTED, T34], {}),
    "bucketize": ([T34[0], SORTED[0]], {"right": True}),
    "as_strided": ([T34, [2, 2], [4, 1]], {"offset": 1}),
    "index_add": ([T34, I3, 0, U34], {}),
    "index_fill": ([T34, np.array([0, 2], np.int64), 0, 1.5], {}),
    "diff": ([T34], {"axis": 1}),
    "take": ([T34, np.array([[0, 5], [11, -1]], np.int64)], {}),
    "index_sample": ([T34, I34[:, :2]], {}),
    "unique_consecutive": ([REP], {"return_inverse": True,
                                   "return_counts": True}),
    "unstack": ([T34], {"axis": 1}),
    "vsplit": ([rng.randn(4, 3).astype(np.float32), [1, 3]], {}),
    "reverse": ([T34, [0, 1]], {}),
    "slice": ([T34, [0, 1], [1, -3], [3, 100]], {}),
    "strided_slice": ([T34, [1], [3], [0], [-2]], {}),
    "crop": ([T34, [2, 2], [1, 3]], {}),
    "as_complex": ([T234.reshape(3, 4, 2)], {}, {"grad": None}),
    "as_real": ([CPLX], {}, {"grad": None}),
    "complex": ([T34, B34], {}, {"grad": None}),
    "broadcast_shape": ([[3, 1, 4], [2, 4]], {}),
    "shard_index": ([np.array([[1], [5], [9]], np.int64), 12, 3, 1], {}),
    "diag_embed": ([T34], {"offset": 1}),
    "fill_diagonal": ([T34, 0.5], {}),
    "fill_diagonal_tensor": ([T34, rng.randn(3).astype(np.float32)], {}),
    "temporal_shift": ([IMG4, 2], {}),
    "gather_tree": ([rng.randint(0, 5, (3, 2, 4)).astype(np.int64),
                     rng.randint(0, 4, (3, 2, 4)).astype(np.int64)], {}),
    # ------------------------------------------------------------ linalg
    "matmul": ([T34, M45], {}),
    "bmm": ([T234, rng.randn(2, 4, 5).astype(np.float32)], {}),
    "dot": ([T34, B34], {}),
    "mv": ([T34, M45[:, 0].copy()], {}),
    "outer_linalg": ([T34[0], M45[0]], {}),
    "transpose_last2": ([T234], {}),
    "t": ([T34], {}),
    "einsum": ([T34, M45], {"equation": "ij,jk->ik"}),
    "norm": ([T34], {"p": 1, "axis": 1}),
    "dist": ([T34, B34], {"p": 3}),
    "cholesky": ([SYM], {}),
    "inverse": ([SYM], {}),
    "det": ([SYM], {}),
    "slogdet": ([SYM], {}),
    "matrix_power": ([SYM, 3], {}),
    "matrix_rank": ([SYM], {}),
    "pinv": ([M45], {}),
    "solve": ([SYM, B42], {}),
    "triangular_solve": ([np.tril(SYM), B42], {"upper": False}),
    "cholesky_solve": ([B42, np.linalg.cholesky(SYM).astype(np.float32)],
                       {}),
    "lstsq": ([TALL, Y6], {}),
    "eigvalsh": ([SYM], {}),
    "cross": ([A33, B33], {}),
    "cov": ([T34], {}),
    "corrcoef": ([T34], {}),
    "histogram": ([T34], {"bins": 5}),
    "bincount": ([np.array([0, 1, 1, 3, 7], np.int64)], {"minlength": 9}),
    "multi_dot": ([[T34, M45, M52]], {}),
    "lu": ([SYM], {}),
    "tensordot": ([T34, M45], {"axes": 1}),
    "eigvals": ([SYM], {}, {"sorted": True}),
    "cond": ([SYM], {}),
    "lu_unpack": ([SYM, np.array([2, 2, 4, 4], np.int32)], {}),
    # ------------------------------------------- nn (activations and more)
    "relu": ([T34], {}),
    "relu6": ([3.5 * T34], {}),
    "sigmoid": ([T34], {}),
    "log_sigmoid": ([T34], {}),
    "silu": ([T34], {}),
    "softsign": ([T34], {}),
    "tanh_act": ([T34], {}),
    "mish": ([T34], {}),
    "gelu": ([T34], {"approximate": True}),
    "elu": ([T34], {"alpha": 0.7}),
    "selu": ([T34], {}),
    "celu": ([T34], {"alpha": 1.3}),
    "leaky_relu": ([T34], {"negative_slope": 0.2}),
    "prelu": ([IMG4[:2], np.array([0.1, -0.3, 0.5, 0.2], np.float32)], {}),
    "hardtanh": ([T34], {"min": -0.5, "max": 1.5}),
    "hardshrink": ([T34], {"threshold": 0.3}),
    "softshrink": ([T34], {"threshold": 0.3}),
    "hardsigmoid": ([4.0 * T34], {}),
    "hardswish": ([4.0 * T34], {}),
    "softplus": ([T34], {"beta": 2.0, "threshold": 3.0}),
    "tanhshrink": ([T34], {}),
    "thresholded_relu": ([T34], {"threshold": 0.2}),
    "softmax": ([T34], {"axis": 0}),
    "log_softmax": ([T34], {}),
    "gumbel_softmax": ([T34], {}),
    "glu": ([T34], {"axis": 1}),
    "maxout": ([T234], {"groups": 3, "axis": 1}),
    "linear": ([T34, M45, C35[0]], {}),
    "embedding": ([I3, M45], {}, {"grad": 1}),
    "scaled_dot_product_attention": (
        [T234.reshape(1, 3, 2, 4), B34.reshape(1, 3, 2, 2).repeat(2, 3),
         U34.reshape(1, 3, 2, 2).repeat(2, 3)], {}),
}

# ops the registry-wide comparison leaves out, each with its reason
EXCEPTIONS = {
    "gumbel_softmax": "its noise comes from each device's own generator, "
                      "so the card and the host draw other values",
}

EXACT = {
    "zeros_like", "ones_like", "full_like", "tril", "triu", "add",
    "subtract", "multiply", "maximum", "minimum", "fmax", "fmin",
    "heaviside", "gcd", "lcm", "equal", "not_equal", "less_than",
    "less_equal", "greater_than", "greater_equal", "equal_all",
    "allclose", "isclose", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "isnan", "isinf", "isfinite", "abs", "neg", "square",
    "floor", "ceil", "round", "trunc", "frac", "sign", "conj", "real",
    "imag", "nan_to_num", "clip", "scale", "clone", "increment",
    "multiplex", "cast", "max", "min", "all", "any", "argmax", "argmin",
    "count_nonzero", "diagonal", "cummax", "cummin", "sgn", "frexp",
    "kthvalue", "mode", "reshape", "flatten", "squeeze", "unsqueeze",
    "concat", "stack", "vstack", "hstack", "dstack", "transpose",
    "moveaxis", "swapaxes", "tile", "expand", "expand_as", "flip", "roll",
    "rot90", "gather", "index_select", "take_along_axis",
    "put_along_axis", "gather_nd", "scatter", "where", "masked_fill",
    "repeat_interleave", "pad", "sort", "argsort", "searchsorted",
    "bucketize", "as_strided", "index_fill", "take", "index_sample",
    "unique_consecutive", "unstack", "vsplit", "reverse", "slice",
    "strided_slice", "crop", "as_complex", "as_real", "complex",
    "broadcast_shape", "shard_index", "diag_embed", "fill_diagonal",
    "fill_diagonal_tensor", "temporal_shift", "gather_tree",
    "transpose_last2", "t", "histogram", "bincount", "matrix_rank",
    "lu_unpack", "relu", "relu6", "hardtanh", "hardshrink",
    "thresholded_relu", "maxout", "embedding",
}

TR = {
    "divide", "remainder", "pow", "atan2", "logaddexp", "sqrt", "rsqrt",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "reciprocal", "erf", "erfinv", "lgamma", "digamma", "stanh",
    "logcumsumexp", "std", "var", "logsumexp", "hypot", "logit", "renorm",
    "cumprod", "prod", "vander", "quantile", "median", "nanmedian",
    "nanquantile", "addmm", "inner", "outer", "kron", "matmul", "bmm",
    "dot", "mv", "outer_linalg", "einsum", "norm", "dist", "cholesky",
    "inverse", "det", "slogdet", "matrix_power", "pinv", "solve",
    "triangular_solve", "cholesky_solve", "lstsq", "eigvalsh", "cross",
    "cov", "corrcoef", "multi_dot", "lu", "tensordot", "eigvals", "cond",
    "sigmoid", "log_sigmoid", "silu", "softsign", "tanh_act", "mish",
    "gelu", "elu", "selu", "celu", "softplus", "tanhshrink", "softmax",
    "log_softmax", "glu", "linear", "scaled_dot_product_attention",
    "trace", "mean", "sum", "nansum", "nanmean", "cumsum", "lerp",
    "deg2rad", "rad2deg", "angle", "scatter_nd_add", "index_add",
    "floor_divide", "diff", "add_n",
}


def options(name):
    spec = CASES[name]
    return spec[2] if len(spec) > 2 else {}


def tolerance(name):
    return 1e-5 if name in TR else 1e-6


# ------------------------------------------------------------------ running

def _to(pkg, a, stop_gradient=True):
    if isinstance(a, np.ndarray):
        return pkg.to_tensor(a, stop_gradient=stop_gradient)
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [pkg.to_tensor(x, stop_gradient=stop_gradient) for x in a]
    return a


def _grad_index(name, registered_differentiable):
    opt = options(name)
    if "grad" in opt:
        return opt["grad"]
    if not registered_differentiable:
        return None
    first = CASES[name][0][0]
    if isinstance(first, list):
        first = first[0]
    if isinstance(first, np.ndarray) and first.dtype.kind == "f":
        return 0
    return None


def _leaves(out):
    if isinstance(out, (tuple, list)):
        res = []
        for o in out:
            res.extend(_leaves(o))
        return res
    return [out]


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else t


def _dtype_name(t):
    d = t.dtype
    return str(d).replace("torch.", "") if "torch" in str(d) else \
        np.dtype(d).name
