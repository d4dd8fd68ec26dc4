"""Shape, indexing and reorganization ops (the JAX package's
``ops/manipulation.py``) on torch. Index operands may be int32 (the JAX
package's index dtype); each impl casts them to int64 where torch
needs it. Ops with data-dependent output shapes (``unique``,
``nonzero``, ``masked_select``, a boolean index) run on the operand's
device: the only host transfers of the op surface are ``numpy()``,
``item()`` and ``tolist()`` (and a shape given as a tensor, as in the
JAX package)."""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..core import dtype as dtype_mod
from ..core.tensor import Tensor, as_torch
from .op_registry import _wrap_outputs, dispatch, op


def _norm_shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


reshape = op("reshape")(lambda x, shape: torch.reshape(x, _norm_shape(shape)))
view = reshape


@op("flatten")
def flatten(x, start_axis=0, stop_axis=-1):
    nd = x.dim()
    if nd == 0:
        return torch.reshape(x, (1,))
    sa = start_axis % nd
    so = stop_axis % nd
    return torch.reshape(x, tuple(x.shape[:sa]) + (-1,)
                         + tuple(x.shape[so + 1:]))


@op("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = [axis]
    nd = builtins.max(x.dim(), 1)
    axis = tuple(a % nd for a in axis if x.shape[a % nd] == 1)
    return torch.squeeze(x, axis) if axis else x


@op("unsqueeze")
def unsqueeze(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    out_rank = x.dim() + len(axis)
    out = x
    for a in sorted(a % out_rank for a in axis):
        out = torch.unsqueeze(out, a)
    return out


concat = op("concat")(lambda x, axis=0: torch.cat(list(x), dim=int(axis)))
stack = op("stack")(lambda x, axis=0: torch.stack(list(x), dim=axis))
vstack = op("vstack")(lambda x: torch.vstack(list(x)))
hstack = op("hstack")(lambda x: torch.hstack(list(x)))
dstack = op("dstack")(lambda x: torch.dstack(list(x)))


def _dim_of(x, axis):
    return (x.shape if isinstance(x, torch.Tensor) else
            as_torch(x).shape)[axis]


def split(x, num_or_sections, axis=0):
    axis = int(axis)
    total = _dim_of(x, axis)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if total % n != 0:
            raise ValueError(f"split: dim {axis} size {total} not divisible "
                             f"by {n}")
        secs = [total // n] * n
    else:
        secs = list(num_or_sections)
        if any(s == -1 for s in secs):
            known = builtins.sum(s for s in secs if s != -1)
            secs = [total - known if s == -1 else s for s in secs]
    # each slice a dispatch of its own, as in the JAX package
    return tuple(
        dispatch("split", lambda a, lo=lo, n=n: torch.narrow(a, axis, lo, n),
                 (x,), {})
        for lo, n in _starts(secs))


def _starts(sizes):
    out, acc = [], 0
    for s in sizes:
        out.append((acc, s))
        acc += s
    return out


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def unbind(x, axis=0):
    n = _dim_of(x, axis)
    return tuple(dispatch("unbind", lambda a, i=i: torch.select(a, axis, i),
                          (x,), {})
                 for i in range(n))


transpose = op("transpose")(lambda x, perm: torch.permute(x, tuple(perm)))
moveaxis = op("moveaxis")(
    lambda x, source, destination: torch.movedim(x, source, destination))
swapaxes = op("swapaxes")(
    lambda x, axis1, axis2: torch.swapaxes(x, axis1, axis2))

tile = op("tile")(
    lambda x, repeat_times: torch.tile(x, _norm_shape(repeat_times)))


@op("expand")
def expand(x, shape):
    shape = list(_norm_shape(shape))
    xshape = list(x.shape)
    # paddle semantics: -1 keeps the original dim; leading dims may be added
    diff = len(shape) - len(xshape)
    for i, s in enumerate(shape):
        if s == -1 and i >= diff:
            shape[i] = xshape[i - diff]
    return torch.broadcast_to(x, tuple(shape))


broadcast_to = expand
expand_as = op("expand_as")(lambda x, y: torch.broadcast_to(x, y.shape))


def broadcast_tensors(inputs):
    shapes = [tuple(t.shape) for t in inputs]
    shape = torch.broadcast_shapes(*shapes)
    return [dispatch("broadcast_tensors",
                     lambda a, s=shape: torch.broadcast_to(a, s), (t,), {})
            for t in inputs]


flip = op("flip")(lambda x, axis: torch.flip(
    x, tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)))
roll = op("roll")(
    lambda x, shifts, axis=None: torch.roll(x, shifts, axis))
rot90 = op("rot90")(
    lambda x, k=1, axes=(0, 1): torch.rot90(x, k, tuple(axes)))


def _take(x, index, axis):
    """jnp.take of in-range indices: a 0-d index drops the axis."""
    if index.dim() == 0:
        return torch.select(x, axis, int(index))
    return torch.index_select(x, axis, index.long().reshape(-1)).reshape(
        tuple(x.shape[:axis % x.dim()]) + tuple(index.shape)
        + tuple(x.shape[axis % x.dim() + 1:]))


gather = op("gather")(
    lambda x, index, axis=0: _take(
        x, index.reshape(-1) if index.dim() > 1 else index, int(axis)))
index_select = op("index_select")(
    lambda x, index, axis=0: _take(x, index, int(axis)))
take_along_axis = op("take_along_axis")(
    lambda arr, indices, axis, broadcast=True:
    torch.take_along_dim(arr, indices.long(), dim=axis))


@op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    """paddle.put_along_axis: reduce in assign/add/mul/mean/amax/amin;
    broadcast=True broadcasts indices over non-axis dims;
    include_self=False starts touched slots from the reduce identity."""
    axis = axis % arr.dim()
    if broadcast:
        tgt = list(arr.shape)
        tgt[axis] = indices.shape[axis]
        indices = torch.broadcast_to(indices, tgt)
    idx = indices.long()
    if isinstance(values, torch.Tensor) and values.dim():
        values = torch.broadcast_to(values, idx.shape)
    else:
        values = torch.full(idx.shape, float(values) if not isinstance(
            values, torch.Tensor) else values.item(), dtype=arr.dtype,
            device=arr.device)
    values = values.to(arr.dtype)
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, values)
    touched = torch.zeros(arr.shape, dtype=torch.int32,
                          device=arr.device).scatter_add(
        axis, idx, torch.ones(idx.shape, dtype=torch.int32,
                              device=arr.device))
    hit = touched > 0

    def base_with(identity):
        if include_self:
            return arr
        return torch.where(hit, torch.as_tensor(identity, dtype=arr.dtype,
                                                device=arr.device), arr)

    if reduce in ("add", "sum"):
        return torch.scatter_add(base_with(0), axis, idx, values)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(base_with(1), axis, idx, values, "prod")
    if reduce == "mean":
        sums = torch.scatter_add(base_with(0), axis, idx, values)
        counts = torch.clamp(touched + (1 if include_self else 0), min=1)
        if not (arr.is_floating_point() or arr.is_complex()):
            # truncated toward zero, in the integer domain
            mean = torch.sign(sums) * torch.div(torch.abs(sums), counts,
                                                rounding_mode="floor")
            mean = mean.to(arr.dtype)
        else:
            mean = (sums / counts).to(arr.dtype)
        return torch.where(hit, mean, arr)
    if reduce == "amax":
        return torch.scatter_reduce(base_with(-float("inf")), axis, idx,
                                    values, "amax")
    if reduce == "amin":
        return torch.scatter_reduce(base_with(float("inf")), axis, idx,
                                    values, "amin")
    raise ValueError(f"unknown reduce {reduce!r}")


def _index_tuple(index):
    return tuple(torch.movedim(index.long(), -1, 0))


gather_nd = op("gather_nd")(lambda x, index: x[_index_tuple(index)])


@op("scatter")
def scatter(x, index, updates, overwrite=True):
    idx = index.long()
    if idx.dim() == 0:
        idx = idx.reshape(1)
        updates = updates.unsqueeze(0)
    return torch.index_put(x, (idx,), updates.to(x.dtype),
                           accumulate=not overwrite)


scatter_nd_add = op("scatter_nd_add")(
    lambda x, index, updates: torch.index_put(
        x, _index_tuple(index), updates.to(x.dtype), accumulate=True))


def scatter_nd(index, updates, shape):
    return dispatch(
        "scatter_nd",
        lambda idx, upd: torch.zeros(_norm_shape(shape), dtype=upd.dtype,
                                     device=upd.device).index_put(
            _index_tuple(idx), upd, accumulate=True),
        (index, updates), {})


@op("where")
def where(condition, x=None, y=None):
    if x is None:
        return torch.nonzero(condition)
    dev = condition.device
    return torch.where(condition.bool(), as_torch(x, None, dev),
                       as_torch(y, None, dev))


def _no_grad_tensor(x):
    x = x if isinstance(x, torch.Tensor) else as_torch(x)
    with torch._C.DisableTorchFunctionSubclass():
        return x.as_subclass(torch.Tensor).detach()


def nonzero(x, as_tuple=False):
    arr = _no_grad_tensor(x)
    idx = torch.nonzero(arr)
    if as_tuple:
        return _wrap_outputs(tuple(idx.unbind(-1)), arr.device)
    return _wrap_outputs(idx, arr.device)


def masked_select(x, mask):
    arr = _no_grad_tensor(x)
    m = _no_grad_tensor(mask).bool()
    return _wrap_outputs(arr.reshape(-1)[m.reshape(-1)], arr.device)


masked_fill = op("masked_fill")(
    lambda x, mask, value: torch.where(
        mask.bool(), as_torch(value, None, x.device).to(x.dtype), x))

repeat_interleave = op("repeat_interleave")(
    lambda x, repeats, axis=None: torch.repeat_interleave(
        x, repeats.long() if isinstance(repeats, torch.Tensor) else repeats,
        dim=axis))


@op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    pad = list(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        # full-rank spec, in dim order (dim0_lo, dim0_hi, dim1_lo, ...)
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # spatial spec: the last spatial dims, innermost first
        nspatial = len(pad) // 2
        widths = [(0, 0)] * nd
        if data_format.endswith("C"):
            spatial_axes = list(range(1, 1 + nspatial))
        else:
            spatial_axes = list(range(nd - nspatial, nd))
        for i in range(nspatial):
            widths[spatial_axes[::-1][i]] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths):
            flat += [lo, hi]
        return F.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    out = x
    for ax, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        n = out.shape[ax]
        if mode == "replicate":
            parts = [out.narrow(ax, 0, 1).repeat_interleave(lo, ax), out,
                     out.narrow(ax, n - 1, 1).repeat_interleave(hi, ax)]
        elif mode == "reflect":
            parts = [out.narrow(ax, 1, lo).flip(ax), out,
                     out.narrow(ax, n - 1 - hi, hi).flip(ax)]
        else:
            parts = [out.narrow(ax, n - lo, lo), out, out.narrow(ax, 0, hi)]
        out = torch.cat(parts, ax)
    return out


def one_hot(x, num_classes):
    from ..core.enforce import run_check
    run_check("one_hot", x, num_classes)
    return dispatch(
        "one_hot",
        lambda idx: F.one_hot(idx.long(), num_classes).to(
            dtype_mod.get_default_dtype()),
        (x,), {}, differentiable=False)


# ------------------------------------------------------------- sort / topk


def topk(x, k, axis=-1, largest=True, sorted=True):
    from ..core.enforce import run_check
    run_check("topk", x, k=k, axis=axis)

    def impl(arr):
        vals, idx = torch.topk(arr, k, dim=axis, largest=largest,
                               sorted=sorted)
        return vals, idx

    return dispatch("topk", impl, (x,), {})


sort = op("sort")(
    lambda x, axis=-1, descending=False: torch.sort(
        x, dim=axis, descending=descending, stable=True)[0])
argsort = op("argsort", differentiable=False)(
    lambda x, axis=-1, descending=False: torch.argsort(
        x, dim=axis, descending=descending, stable=True))


@op("searchsorted", differentiable=False)
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right)


bucketize = op("bucketize", differentiable=False)(
    lambda x, sorted_sequence, out_int32=False, right=False:
    searchsorted.raw(sorted_sequence, x, out_int32=out_int32, right=right))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """numpy's ``unique`` on the operand's device: the sorted values, then
    the first index of each, the inverse, the counts, as asked."""
    arr = _no_grad_tensor(x)
    vals, inv, counts = torch.unique(arr, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return _wrap_outputs(vals, arr.device)
    res = [vals]
    if return_index:
        flat_inv = inv.reshape(-1)
        n = flat_inv.shape[0]
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), n, dtype=torch.long,
                           device=arr.device)
        res.append(first.scatter_reduce(
            0, flat_inv, torch.arange(n, device=arr.device), "amin"))
    if return_inverse:
        res.append(inv.reshape(-1) if axis is None else inv)
    if return_counts:
        res.append(counts)
    return _wrap_outputs(tuple(res), arr.device)


def numel(x):
    n = 1
    for s in (x.shape if isinstance(x, torch.Tensor) else as_torch(x).shape):
        n *= s
    return _wrap_outputs(n, x.device if isinstance(x, torch.Tensor)
                         else None)


def shape(x):
    dims = list(x.shape) if isinstance(x, torch.Tensor) else \
        list(as_torch(x).shape)
    dev = x.device if isinstance(x, torch.Tensor) else None
    return _wrap_outputs(as_torch(dims, "int32", dev), dev)


@op("as_strided")
def as_strided(x, shape, stride, offset=0):
    return torch.as_strided(x.contiguous(), _norm_shape(shape),
                            tuple(stride), offset)


# ------------------------------------------------------------- get/setitem


def _norm_index(idx, device):
    """Paddle index specs as torch takes them: tensors plain, lists as
    index tensors."""
    if isinstance(idx, torch.Tensor):
        with torch._C.DisableTorchFunctionSubclass():
            return idx.as_subclass(torch.Tensor).to(device)
    if isinstance(idx, tuple):
        return tuple(_norm_index(i, device) for i in idx)
    if isinstance(idx, list):
        return as_torch(idx, None, device)
    return idx


def _device_of(x):
    with torch._C.DisableTorchFunctionSubclass():
        return x.device if isinstance(x, torch.Tensor) else None


def getitem(x, idx):
    nidx = _norm_index(idx, _device_of(x))
    name = ("getitem_bool" if isinstance(nidx, torch.Tensor)
            and nidx.dtype == torch.bool else "getitem")
    return dispatch(name, lambda a: a[nidx], (x,), {})


def setitem(x, idx, value):
    nidx = _norm_index(idx, _device_of(x))

    def impl(a, v):
        out = a.clone()
        out[nidx] = v.to(a.dtype) if isinstance(v, torch.Tensor) else v
        return out

    return dispatch("setitem", impl, (x, value), {})


# ------------------------------------------------------- indexing extras

index_add = op("index_add")(
    lambda x, index, axis, value: torch.index_add(x, axis, index.long(),
                                                  value.to(x.dtype)))
index_fill = op("index_fill")(
    lambda x, index, axis, value: torch.index_fill(x, axis, index.long(),
                                                   value))
diff = op("diff")(
    lambda x, n=1, axis=-1, prepend=None, append=None:
    torch.diff(x, n, axis, prepend, append))


@op("take")
def take(x, index, mode="raise"):
    """Flat-index gather (paddle.take): mode raise (bounds-checked),
    wrap (modulo), clip (into [0, n-1])."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    elif mode == "raise":
        if bool(((idx >= n) | (idx < -n)).any()):
            raise IndexError(
                f"take: index out of range for {n} elements")
        idx = torch.where(idx < 0, idx + n, idx)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return flat[idx]


index_sample = op("index_sample")(
    lambda x, index: torch.take_along_dim(x, index.long(), dim=1))


@op("unique_consecutive", differentiable=False)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Collapse consecutive duplicates of the flattened operand."""
    if axis is not None:
        raise NotImplementedError(
            "unique_consecutive(axis=...) is unsupported; flatten first")
    res = torch.unique_consecutive(x.reshape(-1),
                                   return_inverse=return_inverse,
                                   return_counts=return_counts)
    if isinstance(res, tuple):
        return tuple(res)
    return res


@op("unstack")
def unstack(x, axis=0, num=None):
    return tuple(torch.unbind(x, axis))


@op("vsplit")
def vsplit(x, num_or_sections):
    if isinstance(num_or_sections, int):
        if x.shape[0] % num_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(x, num_or_sections, dim=0))
    points, acc = [], 0
    for s in list(num_or_sections)[:-1]:
        acc += int(s)
        points.append(acc)
    return tuple(torch.tensor_split(x, points, dim=0))


@op("reverse")
def reverse(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, tuple(axes))


@op("slice")
def slice(x, axes, starts, ends):  # noqa: A001 — paddle exports `slice`
    """paddle.slice: per-axis [start, end) with negative and overflowing
    bounds normalized."""
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(int(st), int(en))
    return x[tuple(idx)]


@op("strided_slice")
def strided_slice(x, axes, starts, ends, strides):
    out = x
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        st, en, sd = int(st), int(en), int(sd)
        if sd > 0:
            idx = [builtins.slice(None)] * out.dim()
            idx[ax] = builtins.slice(st, en, sd)
            out = out[tuple(idx)]
        else:
            rows = range(*builtins.slice(st, en, sd).indices(out.shape[ax]))
            out = torch.index_select(out, ax, torch.tensor(
                list(rows), dtype=torch.long, device=out.device))
    return out


@op("crop")
def crop(x, shape=None, offsets=None):
    offs = [0] * x.dim() if offsets is None else [int(o) for o in offsets]
    tgt = list(x.shape) if shape is None else [
        int(s) if int(s) != -1 else x.shape[i] - offs[i]
        for i, s in enumerate(shape)]
    out = x
    for ax, (o, n) in enumerate(zip(offs, tgt)):
        # lax.dynamic_slice clamps the start so the window fits
        o = builtins.min(builtins.max(o, 0), x.shape[ax] - n)
        out = out.narrow(ax, o, n)
    return out


as_complex = op("as_complex")(lambda x: torch.complex(x[..., 0], x[..., 1]))
as_real = op("as_real")(
    lambda x: torch.stack([torch.real(x), torch.imag(x)], dim=-1))
complex = op("complex")(lambda real, imag: torch.complex(real, imag))
broadcast_shape = op("broadcast_shape", differentiable=False)(
    lambda x_shape, y_shape: tuple(torch.broadcast_shapes(
        tuple(x_shape), tuple(y_shape))))


@op("shard_index", differentiable=False)
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    """Global ids to shard-local ids (the reference's shard_index op)."""
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    in_shard = (x >= lo) & (x < lo + shard_size)
    return torch.where(in_shard, x - lo, torch.full_like(x, ignore_value))


# ---- in-place variants (paddle's trailing-underscore functions) --------
# Tensor._adopt: the out-of-place result is written into the tensor


def _inplace(x: Tensor, out: Tensor) -> Tensor:
    return x._adopt(out)


def reshape_(x, shape):
    return _inplace(x, reshape(x, shape))


def squeeze_(x, axis=None):
    return _inplace(x, squeeze(x, axis))


def unsqueeze_(x, axis):
    return _inplace(x, unsqueeze(x, axis))


def scatter_(x, index, updates, overwrite=True):
    return _inplace(x, scatter(x, index, updates, overwrite))


def index_add_(x, index, axis, value):
    return _inplace(x, index_add(x, index, axis, value))


def tanh_(x):
    from .math import tanh as _tanh
    return _inplace(x, _tanh(x))


# ---- the remaining tensor-op families ----------------------------------

@op("diag_embed")
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


def _diag_rc(n, offset, device):
    rng = torch.arange(n - builtins.abs(int(offset)) if offset else n,
                       device=device)
    return rng + builtins.max(-offset, 0), rng + builtins.max(offset, 0)


@op("fill_diagonal")
def fill_diagonal(x, value, offset=0, wrap=False):
    """x with its main diagonal set to ``value`` (functional form of
    Tensor.fill_diagonal_)."""
    rows, cols = _diag_rc(builtins.min(x.shape[-2], x.shape[-1]), offset,
                          x.device)
    out = x.clone()
    out[..., rows, cols] = torch.as_tensor(value, dtype=x.dtype,
                                           device=x.device)
    return out


@op("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    """Fill the (dim1, dim2) diagonal of x with tensor y."""
    nd = x.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    xm = torch.movedim(x, (d1, d2), (-2, -1))
    n = builtins.min(xm.shape[-2], xm.shape[-1]) - builtins.abs(int(offset))
    rng = torch.arange(n, device=x.device)
    rows = rng + builtins.max(-offset, 0)
    cols = rng + builtins.max(offset, 0)
    xm = xm.clone()
    xm[..., rows, cols] = y.to(x.dtype)
    return torch.movedim(xm, (-2, -1), (d1, d2))


@op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM temporal shift: shift a fraction of channels one step along
    the segment (time) axis."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    back = F.pad(xr[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    fwd = F.pad(xr[:, :-1, c1:c2], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([back, fwd, xr[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


@op("gather_tree", differentiable=False)
def gather_tree(ids, parents):
    """Beam-search backtrace: ids/parents [max_time, batch, beam]; walk
    parents from the last step back to assemble full sequences."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).long()
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.take_along_dim(ids[t], beams, dim=-1))
        beams = torch.take_along_dim(parents[t], beams, dim=-1).long()
    return torch.stack(toks[::-1])
