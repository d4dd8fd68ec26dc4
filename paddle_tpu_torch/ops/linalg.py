"""Linear algebra ops (the JAX package's ``ops/linalg.py``) on
``torch.linalg``. ``matmul`` is XLA's product outside any kernel in the
reference, so here it is ``torch.matmul`` (cuBLAS on a card), as are
``mm``, ``bmm`` and ``einsum``."""
from __future__ import annotations

import math

import torch

from .op_registry import dispatch, op


@op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() >= 2:
        x = torch.swapaxes(x, -1, -2)
    if transpose_y and y.dim() >= 2:
        y = torch.swapaxes(y, -1, -2)
    return torch.matmul(x, y)


mm = matmul
bmm = op("bmm")(lambda x, y: torch.matmul(x, y))
dot = op("dot")(lambda x, y: torch.sum(x * y, dim=-1))
mv = op("mv")(lambda x, vec: torch.matmul(x, vec))
outer = op("outer_linalg")(
    lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)))

transpose_last2 = op("transpose_last2")(lambda x: torch.swapaxes(x, -1, -2))
t = op("t")(lambda x: x.t() if x.dim() <= 2 else torch.swapaxes(x, -1, -2))

einsum_impl = op("einsum")(
    lambda *ops, equation=None: torch.einsum(equation, *ops))


def einsum(equation, *operands):
    return einsum_impl(*operands, equation=equation)


def _dims(axis):
    if isinstance(axis, list):
        return tuple(axis)
    return axis


@op("norm")
def norm(x, p="fro", axis=None, keepdim=False):
    axis = _dims(axis)
    dim = tuple(range(x.dim())) if axis is None else axis
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(x), dim=dim,
                                    keepdim=keepdim))
    if p == math.inf:
        return torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == -math.inf:
        return torch.amin(torch.abs(x), dim=dim, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dim, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dim,
                               keepdim=keepdim), 1.0 / p)


def _p_norm_scalar(d, p):
    if p == 2:
        return torch.sqrt(torch.sum(torch.square(d)))
    if p == math.inf:
        return torch.amax(torch.abs(d))
    if p == -math.inf:
        return torch.amin(torch.abs(d))
    if p == 0:
        return torch.sum((d != 0).to(d.dtype))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


dist = op("dist")(lambda x, y, p=2: _p_norm_scalar(x - y, p))


@op("cholesky")
def cholesky(x, upper=False):
    low = torch.linalg.cholesky(x)
    return low.swapaxes(-1, -2).conj() if upper else low


inv = op("inverse")(lambda x: torch.linalg.inv(x))
inverse = inv
det = op("det")(lambda x: torch.linalg.det(x))
slogdet = op("slogdet")(lambda x: torch.stack(torch.linalg.slogdet(x)))
matrix_power = op("matrix_power")(
    lambda x, n: torch.linalg.matrix_power(x, n))


@op("matrix_rank", differentiable=False)
def matrix_rank(x, tol=None, hermitian=False):
    # jnp.linalg.matrix_rank(x, rtol=tol): singular values above
    # rtol * the largest (default rtol: max(M, N) * eps)
    s = torch.linalg.svdvals(x)
    rtol = (max(x.shape[-2:]) * torch.finfo(x.dtype).eps
            if tol is None else tol)
    return torch.sum(s > rtol * s.amax(-1, keepdim=True), dim=-1)


pinv = op("pinv")(
    lambda x, rcond=1e-15, hermitian=False: torch.linalg.pinv(
        x, rtol=rcond, hermitian=hermitian))
solve = op("solve")(lambda x, y: torch.linalg.solve(x, y))
triangular_solve = op("triangular_solve")(
    lambda x, y, upper=True, transpose=False, unitriangular=False:
    torch.linalg.solve_triangular(
        x.swapaxes(-1, -2) if transpose else x, y,
        upper=upper != transpose, unitriangular=unitriangular))
cholesky_solve = op("cholesky_solve")(
    lambda x, y, upper=False: torch.cholesky_solve(x, y, upper=upper))
lstsq = op("lstsq", differentiable=False)(
    lambda x, y, rcond=None: torch.linalg.lstsq(
        x, y, rcond=rcond, driver="gelsd" if x.device.type == "cpu"
        else None).solution)


def qr(x, mode="reduced"):
    return dispatch("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)),
                    (x,), {})


def svd(x, full_matrices=False):
    return dispatch(
        "svd", lambda a: tuple(torch.linalg.svd(
            a, full_matrices=full_matrices)), (x,), {})


def eig(x):
    return dispatch("eig", lambda a: tuple(torch.linalg.eig(a)), (x,), {},
                    differentiable=False)


def eigh(x, UPLO="L"):
    return dispatch("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)),
                    (x,), {})


eigvalsh = op("eigvalsh")(
    lambda x, UPLO="L": torch.linalg.eigvalsh(x, UPLO=UPLO))


def _cross_impl(x, y, axis=9):
    if axis == 9:  # paddle sentinel: first dimension of size 3
        axis = next((i for i, d in enumerate(x.shape) if d == 3), -1)
    return torch.linalg.cross(x, y, dim=axis)


cross = op("cross")(_cross_impl)


@op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


corrcoef = op("corrcoef")(
    lambda x, rowvar=True: torch.corrcoef(x if rowvar else x.T))


@op("histogram", differentiable=False)
def histogram(x, bins=100, min=0, max=0):
    lo, hi = (x.min(), x.max()) if min == 0 and max == 0 else (min, max)
    edges = torch.linspace(float(lo), float(hi), bins + 1, device=x.device,
                           dtype=torch.float32)
    # jnp.histogram: bins [e_i, e_i+1), the last one closed
    idx = torch.searchsorted(edges, x.reshape(-1).float(), right=True) - 1
    idx = torch.where(x.reshape(-1) == edges[-1], bins - 1, idx)
    keep = (idx >= 0) & (idx < bins)
    # jnp.histogram's counts are floats
    return torch.zeros(bins, dtype=torch.float32, device=x.device).index_add(
        0, idx[keep], torch.ones_like(idx[keep], dtype=torch.float32))


bincount = op("bincount", differentiable=False)(
    lambda x, weights=None, minlength=0:
    torch.bincount(x.long(), weights=weights, minlength=minlength))

multi_dot = op("multi_dot")(lambda xs: torch.linalg.multi_dot(list(xs)))


@op("lu")
def lu(x, pivot=True):
    """LU factorization -> (packed LU, pivots), the pivots 1-based
    (LAPACK's convention, as paddle.linalg.lu); pivot=False is not
    supported (the reference's XLA LU always pivots)."""
    if not pivot:
        raise NotImplementedError(
            "lu(pivot=False) is unsupported: XLA's LU always performs "
            "partial pivoting")
    lu_mat, piv = torch.linalg.lu_factor(x)
    return lu_mat, piv


@op("tensordot")
def tensordot(x, y, axes=2):
    """paddle.tensordot: int, [ax_list_x, ax_list_y], or pair-of-lists
    axes."""
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
        if len(axes) == 1:
            axes = [axes[0], axes[0]]
    return torch.tensordot(x, y, dims=axes)


eigvals = op("eigvals", differentiable=False)(
    lambda x: torch.linalg.eigvals(x))
cond = op("cond", differentiable=False)(
    lambda x, p=None: torch.linalg.cond(x, p=p))


@op("lu_unpack", differentiable=False)
def lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    """paddle.linalg.lu results -> (P, L, U) with x = P @ L @ U; pivots
    are 1-based."""
    return tuple(torch.lu_unpack(lu_mat, pivots.to(torch.int32)))
