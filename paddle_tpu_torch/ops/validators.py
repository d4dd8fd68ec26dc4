"""InferMeta-style validators (the JAX package's ``ops/validators.py``):
the same checks under the same op names, with the same messages.

Reference: paddle/phi/infermeta/{unary,binary,ternary,multiary}.cc —
every kernel validates operand shapes/dtypes and raises
PADDLE_ENFORCE_* with expected-vs-got messages. Validators are
registered per op name (core/enforce.py) and run at the dispatch
boundary before the torch impl, so users get an op-named shape message
instead of a raw torch traceback. Checks read only shapes and dtypes.
The ``nn`` ops' checks (softmax, conv, pools, norms) are registered
here too; their ops come with ROADMAP A2b.
"""
from __future__ import annotations

from ..core.enforce import enforce, infer_check

__all__ = []


def _shape(x):
    return tuple(getattr(x, "shape", ()))


def _ndim(x):
    return len(_shape(x))


def _broadcastable(a, b) -> bool:
    for x, y in zip(reversed(a), reversed(b)):
        if x != 1 and y != 1 and x != y:
            return False
    return True


def _check_axis(op, axis, ndim, allow_scalar_like=True):
    lo = -ndim if ndim else -1
    hi = max(ndim - 1, 0)
    enforce(lo <= axis <= hi, op,
            f"axis must be in [{lo}, {hi}] for a {ndim}-d operand, "
            f"got {axis}")


def _binary_broadcast(op):
    @infer_check(op)
    def check(x, y, *a, **k):
        sx, sy = _shape(x), _shape(y)
        enforce(_broadcastable(sx, sy), op,
                f"operands could not be broadcast together: "
                f"x{list(sx)} vs y{list(sy)}")
    return check


for _name in ("add", "subtract", "multiply", "divide", "maximum",
              "minimum", "pow", "remainder", "floor_divide", "atan2",
              "fmax", "fmin", "heaviside", "logaddexp", "hypot"):
    _binary_broadcast(_name)


@infer_check("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False, *a, **k):
    sx, sy = _shape(x), _shape(y)
    enforce(len(sx) >= 1 and len(sy) >= 1, "matmul",
            f"operands need ndim >= 1, got x{list(sx)} y{list(sy)}")
    if len(sx) >= 2 and len(sy) >= 2:
        kx = sx[-1] if not transpose_x else sx[-2]
        ky = sy[-2] if not transpose_y else sy[-1]
        enforce(kx == ky, "matmul",
                f"inner dims must match: x{list(sx)}"
                f"{'^T' if transpose_x else ''} @ y{list(sy)}"
                f"{'^T' if transpose_y else ''} -> {kx} != {ky}")
        bx, by = sx[:-2], sy[:-2]
        enforce(_broadcastable(bx, by), "matmul",
                f"batch dims not broadcastable: {list(bx)} vs {list(by)}")


@infer_check("bmm")
def _bmm(x, y, *a, **k):
    sx, sy = _shape(x), _shape(y)
    enforce(len(sx) == 3 and len(sy) == 3, "bmm",
            f"bmm needs two 3-d operands, got x{list(sx)} y{list(sy)}")
    enforce(sx[0] == sy[0], "bmm",
            f"batch sizes differ: {sx[0]} vs {sy[0]}")
    enforce(sx[2] == sy[1], "bmm",
            f"inner dims must match: {sx[2]} != {sy[1]}")


@infer_check("mv")
def _mv(x, vec, *a, **k):
    sx, sv = _shape(x), _shape(vec)
    enforce(len(sx) == 2 and len(sv) == 1, "mv",
            f"mv needs (matrix, vector), got x{list(sx)} vec{list(sv)}")
    enforce(sx[1] == sv[0], "mv",
            f"matrix cols {sx[1]} != vector size {sv[0]}")


@infer_check("concat")
def _concat(xs, axis=0, *a, **k):
    if not isinstance(xs, (list, tuple)) or not xs:
        return
    nd = _ndim(xs[0])
    _check_axis("concat", int(axis), nd)
    ax = int(axis) % max(nd, 1)
    base = list(_shape(xs[0]))
    for i, t in enumerate(xs[1:], 1):
        s = list(_shape(t))
        enforce(len(s) == nd, "concat",
                f"input {i} has rank {len(s)}, expected {nd}")
        ok = all(s[d] == base[d] for d in range(nd) if d != ax)
        enforce(ok, "concat",
                f"input {i} shape {s} mismatches input 0 shape {base} "
                f"outside concat axis {ax}")


@infer_check("stack")
def _stack(xs, axis=0, *a, **k):
    if not isinstance(xs, (list, tuple)) or not xs:
        return
    base = _shape(xs[0])
    for i, t in enumerate(xs[1:], 1):
        enforce(_shape(t) == base, "stack",
                f"input {i} shape {list(_shape(t))} != input 0 shape "
                f"{list(base)} (stack needs identical shapes)")


@infer_check("reshape")
def _reshape(x, shape, *a, **k):
    import numpy as np
    tgt = [int(s) for s in (shape.tolist() if hasattr(shape, "tolist")
                            else shape)]
    enforce(tgt.count(-1) <= 1, "reshape",
            f"at most one -1 allowed in target shape, got {tgt}")
    n = int(np.prod(_shape(x))) if _shape(x) else 1
    fixed = int(np.prod([s for s in tgt if s != -1])) if tgt else 1
    if -1 in tgt:
        enforce(fixed != 0 and n % fixed == 0, "reshape",
                f"cannot infer -1: {n} elements not divisible by "
                f"{fixed} (shape {list(_shape(x))} -> {tgt})")
    else:
        enforce(fixed == n, "reshape",
                f"element count mismatch: {list(_shape(x))} has {n} "
                f"elements, target {tgt} has {fixed}")


@infer_check("softmax")
def _softmax(x, axis=-1, *a, **k):
    _check_axis("softmax", int(axis), max(_ndim(x), 1))


@infer_check("log_softmax")
def _log_softmax(x, axis=-1, *a, **k):
    _check_axis("log_softmax", int(axis), max(_ndim(x), 1))


@infer_check("gather")
def _gather(x, index, axis=0, *a, **k):
    _check_axis("gather", int(axis), max(_ndim(x), 1))
    enforce(_ndim(index) <= 2, "gather",
            f"index must be 0/1/2-d, got {_ndim(index)}-d")


@infer_check("index_select")
def _index_select(x, index, axis=0, *a, **k):
    _check_axis("index_select", int(axis), max(_ndim(x), 1))


@infer_check("take_along_axis")
def _take_along_axis(arr, indices, axis, *a, **k):
    _check_axis("take_along_axis", int(axis), max(_ndim(arr), 1))
    enforce(_ndim(indices) == _ndim(arr), "take_along_axis",
            f"indices rank {_ndim(indices)} must equal array rank "
            f"{_ndim(arr)}")


@infer_check("one_hot")
def _one_hot(x, num_classes, *a, **k):
    enforce(int(num_classes) > 0, "one_hot",
            f"num_classes must be positive, got {num_classes}")


@infer_check("topk")
def _topk(x, k=1, axis=-1, *a, **kw):
    nd = max(_ndim(x), 1)
    _check_axis("topk", int(axis), nd)
    dim = _shape(x)[int(axis) % nd] if _shape(x) else 1
    enforce(0 < int(k) <= dim, "topk",
            f"k must be in [1, {dim}] for axis size {dim}, got {k}")


@infer_check("squeeze")
def _squeeze(x, axis=None, *a, **k):
    if axis is None:
        return
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    for ax in axes:
        _check_axis("squeeze", int(ax), max(_ndim(x), 1))


@infer_check("unsqueeze")
def _unsqueeze(x, axis, *a, **k):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    out_rank = _ndim(x) + len(axes)
    for ax in axes:
        enforce(-out_rank <= int(ax) < out_rank, "unsqueeze",
                f"axis {ax} out of range for output rank {out_rank}")


@infer_check("transpose")
def _transpose(x, perm, *a, **k):
    p = [int(v) for v in perm]
    enforce(sorted(p) == list(range(_ndim(x))), "transpose",
            f"perm {p} must be a permutation of 0..{_ndim(x) - 1} "
            f"for a {_ndim(x)}-d operand")


@infer_check("embedding")
def _embedding(x, weight, padding_idx=None, *a, **k):
    enforce(_ndim(weight) == 2, "embedding",
            f"weight must be 2-d [vocab, dim], got {list(_shape(weight))}")


@infer_check("linear")
def _linear(x, weight, bias=None, *a, **k):
    sx, sw = _shape(x), _shape(weight)
    enforce(len(sw) == 2, "linear",
            f"weight must be 2-d [in, out], got {list(sw)}")
    enforce(sx and sx[-1] == sw[0], "linear",
            f"input features {sx[-1] if sx else '?'} != weight rows "
            f"{sw[0]} (x{list(sx)} @ w{list(sw)})")
    if bias is not None:
        sb = _shape(bias)
        enforce(sb in ((sw[1],), ()), "linear",
                f"bias shape {list(sb)} != [{sw[1]}]")


@infer_check("conv2d")
def _conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1, data_format="NCHW", *a, **k):
    sx, sw = _shape(x), _shape(weight)
    enforce(len(sx) == 4, "conv2d",
            f"input must be 4-d {data_format}, got {list(sx)}")
    enforce(len(sw) == 4, "conv2d",
            f"weight must be 4-d [out_c, in_c/groups, kh, kw], "
            f"got {list(sw)}")
    ch_axis = 1 if str(data_format).upper().startswith("NC") else -1
    in_c = sx[ch_axis]
    enforce(in_c == sw[1] * groups, "conv2d",
            f"in_channels {in_c} ({data_format}) != weight in_c/groups "
            f"{sw[1]} * groups {groups}")
    enforce(sw[0] % groups == 0, "conv2d",
            f"out_channels {sw[0]} not divisible by groups {groups}")


@infer_check("layer_norm")
def _layer_norm(x, normalized_shape=None, weight=None, bias=None,
                epsilon=1e-5, *a, **k):
    if normalized_shape is None:
        return
    ns = ([int(normalized_shape)]
          if not isinstance(normalized_shape, (list, tuple))
          else [int(v) for v in normalized_shape])
    sx = list(_shape(x))
    enforce(sx[-len(ns):] == ns, "layer_norm",
            f"normalized_shape {ns} must match input trailing dims "
            f"{sx[-len(ns):]} (input {sx})")


@infer_check("cross_entropy")
def _cross_entropy(logits, label, *a, **k):
    sl, sy = _shape(logits), _shape(label)
    enforce(len(sl) >= 1, "cross_entropy",
            f"logits need >=1 dims, got {list(sl)}")
    if len(sy) == len(sl) - 1:
        enforce(sy == sl[:-1], "cross_entropy",
                f"label shape {list(sy)} must equal logits shape minus "
                f"class dim {list(sl[:-1])}")


@infer_check("where")
def _where(cond, x=None, y=None, *a, **k):
    if x is None or y is None:
        return
    enforce(_broadcastable(_shape(x), _shape(y)), "where",
            f"x{list(_shape(x))} and y{list(_shape(y))} not "
            f"broadcastable")
    enforce(_broadcastable(_shape(cond), _shape(x)), "where",
            f"condition{list(_shape(cond))} not broadcastable with "
            f"x{list(_shape(x))}")


@infer_check("expand")
def _expand(x, shape, *a, **k):
    tgt = [int(s) for s in (shape.tolist() if hasattr(shape, "tolist")
                            else shape)]
    sx = _shape(x)
    enforce(len(tgt) >= len(sx), "expand",
            f"target rank {len(tgt)} < input rank {len(sx)}")
    diff = len(tgt) - len(sx)
    for i, s in enumerate(tgt):
        if i < diff or s == -1:
            continue
        enforce(sx[i - diff] in (1, s), "expand",
                f"dim {i}: cannot expand {sx[i - diff]} -> {s} "
                f"(x{list(sx)} -> {tgt})")


@infer_check("tile")
def _tile(x, repeat_times, *a, **k):
    reps = [int(r) for r in (repeat_times.tolist()
                             if hasattr(repeat_times, "tolist")
                             else repeat_times)]
    enforce(all(r > 0 for r in reps), "tile",
            f"repeat_times must be positive, got {reps}")


@infer_check("flatten")
def _flatten(x, start_axis=0, stop_axis=-1, *a, **k):
    nd = max(_ndim(x), 1)
    _check_axis("flatten", int(start_axis), nd)
    _check_axis("flatten", int(stop_axis), nd)
    enforce(int(start_axis) % nd <= int(stop_axis) % nd, "flatten",
            f"start_axis {start_axis} must be <= stop_axis {stop_axis}")


@infer_check("cumsum")
def _cumsum(x, axis=None, *a, **k):
    if axis is not None:
        _check_axis("cumsum", int(axis), max(_ndim(x), 1))


@infer_check("put_along_axis")
def _put_along_axis(arr, indices, values, axis, *a, **k):
    _check_axis("put_along_axis", int(axis), max(_ndim(arr), 1))
    enforce(_ndim(indices) == _ndim(arr), "put_along_axis",
            f"indices rank {_ndim(indices)} must equal array rank "
            f"{_ndim(arr)}")


# ---------------- round-3 breadth: the next failure-magnet families
# (VERDICT r2 Next #7 — slice/pad/gather_nd/scatter/pool/conv-transpose/
# norm; reference paddle/phi/infermeta/unary.cc, binary.cc)

def _is_int(v):
    return isinstance(v, int) and not isinstance(v, bool)


@infer_check("slice")
def _slice(x, axes, starts, ends, *a, **k):
    nd = _ndim(x)
    enforce(len(axes) == len(starts) == len(ends), "slice",
            f"axes/starts/ends must have equal length, got "
            f"{len(axes)}/{len(starts)}/{len(ends)}")
    for ax in axes:
        _check_axis("slice", ax, nd)
    enforce(len(set(a % nd for a in axes)) == len(axes), "slice",
            f"repeated axis in {list(axes)}")


@infer_check("strided_slice")
def _strided_slice(x, axes, starts, ends, strides, *a, **k):
    nd = _ndim(x)
    enforce(len(axes) == len(starts) == len(ends) == len(strides),
            "strided_slice",
            f"axes/starts/ends/strides lengths differ: "
            f"{len(axes)}/{len(starts)}/{len(ends)}/{len(strides)}")
    for ax in axes:
        _check_axis("strided_slice", ax, nd)
    for st in strides:
        enforce(st != 0, "strided_slice", "stride must be non-zero")


@infer_check("pad")
def _pad(x, pad, mode="constant", value=0.0, data_format="NCHW", *a, **k):
    nd = _ndim(x)
    if isinstance(pad, (list, tuple)):
        enforce(len(pad) % 2 == 0, "pad",
                f"pad list must have an even length, got {len(pad)}")
        enforce(len(pad) <= 2 * nd, "pad",
                f"pad list of length {len(pad)} exceeds 2*ndim "
                f"({2 * nd}) for a {nd}-d input")
    enforce(mode in ("constant", "reflect", "replicate", "circular"),
            "pad", f"mode must be one of constant/reflect/replicate/"
            f"circular, got {mode!r}")


@infer_check("gather_nd")
def _gather_nd(x, index, *a, **k):
    sx, si = _shape(x), _shape(index)
    enforce(len(si) >= 1, "gather_nd",
            f"index needs ndim >= 1, got {list(si)}")
    enforce(si[-1] <= len(sx), "gather_nd",
            f"index.shape[-1] ({si[-1]}) must be <= x.ndim "
            f"({len(sx)}) — each index row addresses a prefix of x's "
            f"dims")


@infer_check("scatter")
def _scatter(x, index, updates, *a, **k):
    sx, si, su = _shape(x), _shape(index), _shape(updates)
    enforce(len(si) in (0, 1), "scatter",
            f"index must be 0-d or 1-d, got {list(si)}")
    if not si:  # 0-d index: updates replace one row of x
        enforce(su == sx[1:], "scatter",
                f"with a 0-d index, updates shape {list(su)} must "
                f"match one x row {list(sx[1:])}")
        return
    enforce(len(su) >= 1 and su[0] == si[0], "scatter",
            f"updates.shape[0] ({su[0] if su else '()'}) must equal "
            f"index length ({si[0]})")
    enforce(su[1:] == sx[1:], "scatter",
            f"updates trailing dims {list(su[1:])} must match x "
            f"trailing dims {list(sx[1:])}")


@infer_check("scatter_nd_add")
def _scatter_nd_add(x, index, updates, *a, **k):
    sx, si, su = _shape(x), _shape(index), _shape(updates)
    enforce(len(si) >= 1, "scatter_nd_add",
            f"index needs ndim >= 1, got {list(si)}")
    enforce(si[-1] <= len(sx), "scatter_nd_add",
            f"index.shape[-1] ({si[-1]}) must be <= x.ndim ({len(sx)})")
    expect = si[:-1] + sx[si[-1]:]
    enforce(su == expect, "scatter_nd_add",
            f"updates shape {list(su)} must be "
            f"index.shape[:-1] + x.shape[index.shape[-1]:] "
            f"= {list(expect)}")


def _conv_check(op, nsp):
    @infer_check(op)
    def check(x, weight, bias=None, stride=1, padding=0, dilation=1,
              groups=1, data_format=None, *a, **k):
        sx, sw = _shape(x), _shape(weight)
        enforce(len(sx) == nsp + 2, op,
                f"input must be {nsp + 2}-d, got {list(sx)}")
        enforce(len(sw) == nsp + 2, op,
                f"weight must be {nsp + 2}-d, got {list(sw)}")
        cf = bool(data_format) and str(data_format).endswith("C")
        cin = sx[-1] if cf else sx[1]
        enforce(cin == sw[1] * groups, op,
                f"input channels ({cin}) must equal "
                f"weight.shape[1] * groups ({sw[1]} * {groups})")
        enforce(sw[0] % groups == 0, op,
                f"out channels ({sw[0]}) must divide by groups "
                f"({groups})")
    return check


for _n, _d in (("conv1d", 1), ("conv3d", 3)):
    _conv_check(_n, _d)


def _conv_transpose_check(op, nsp):
    @infer_check(op)
    def check(x, weight, bias=None, stride=1, padding=0,
              output_padding=0, groups=1, dilation=1, data_format=None,
              *a, **k):
        sx, sw = _shape(x), _shape(weight)
        enforce(len(sx) == nsp + 2, op,
                f"input must be {nsp + 2}-d, got {list(sx)}")
        enforce(len(sw) == nsp + 2, op,
                f"weight must be {nsp + 2}-d "
                f"[in, out//groups, *k], got {list(sw)}")
        cf = bool(data_format) and str(data_format).endswith("C")
        cin = sx[-1] if cf else sx[1]
        enforce(cin == sw[0], op,
                f"input channels ({cin}) must equal weight.shape[0] "
                f"({sw[0]}) — transpose weights are [in, out//groups, "
                f"*k]")
    return check


for _n, _d in (("conv1d_transpose", 1), ("conv2d_transpose", 2),
               ("conv3d_transpose", 3)):
    _conv_transpose_check(_n, _d)


def _pool_check(op, nsp):
    @infer_check(op)
    def check(x, kernel_size=None, *a, **k):
        sx = _shape(x)
        enforce(len(sx) == nsp + 2, op,
                f"input must be {nsp + 2}-d "
                f"(N, C + {nsp} spatial dims), got {list(sx)}")
        if isinstance(kernel_size, (list, tuple)):
            enforce(len(kernel_size) == nsp, op,
                    f"kernel_size needs {nsp} entries, got "
                    f"{list(kernel_size)}")
    return check


for _n, _d in (("max_pool1d", 1), ("max_pool2d", 2), ("max_pool3d", 3),
               ("avg_pool1d", 1), ("avg_pool2d", 2), ("avg_pool3d", 3),
               ("adaptive_avg_pool1d", 1), ("adaptive_avg_pool2d", 2),
               ("adaptive_avg_pool3d", 3), ("adaptive_max_pool1d", 1),
               ("adaptive_max_pool2d", 2), ("adaptive_max_pool3d", 3)):
    _pool_check(_n, _d)


@infer_check("batch_norm_train")
def _bn_train(x, weight=None, bias=None, epsilon=1e-5,
              data_format="NCHW", **kw):
    _bn_shapes("batch_norm_train", x, weight, bias, data_format)


@infer_check("batch_norm_infer")
def _bn_infer(x, running_mean=None, running_var=None, weight=None,
              bias=None, epsilon=1e-5, data_format="NCHW", **kw):
    _bn_shapes("batch_norm_infer", x, weight, bias, data_format)


@infer_check("instance_norm")
def _in_check(x, weight=None, bias=None, epsilon=1e-5, **kw):
    _bn_shapes("instance_norm", x, weight, bias, "NCHW")


def _bn_shapes(op, x, weight, bias, data_format):
    sx = _shape(x)
    enforce(len(sx) >= 2, op,
            f"input needs ndim >= 2 (N, C, ...), got {list(sx)}")
    c = sx[-1] if str(data_format).endswith("C") else sx[1]
    for nm, p in (("weight", weight), ("bias", bias)):
        if p is not None:
            enforce(_shape(p) == (c,), op,
                    f"{nm} must have shape [{c}] (the channel "
                    f"count), got {list(_shape(p))}")


@infer_check("group_norm")
def _group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
                data_format="NCHW", *a, **k):
    sx = _shape(x)
    enforce(len(sx) >= 2, "group_norm",
            f"input needs ndim >= 2, got {list(sx)}")
    c = sx[-1] if str(data_format).endswith("C") else sx[1]
    enforce(c % num_groups == 0, "group_norm",
            f"channels ({c}) must divide by num_groups ({num_groups})")


@infer_check("rms_norm")
def _rms_norm(x, weight=None, *a, **k):
    if weight is not None:
        sx, sw = _shape(x), _shape(weight)
        enforce(sx[-len(sw):] == sw, "rms_norm",
                f"weight shape {list(sw)} must match trailing input "
                f"dims of {list(sx)}")


@infer_check("local_response_norm")
def _lrn(x, size, *a, **k):
    enforce(_ndim(x) in (3, 4, 5), "local_response_norm",
            f"input must be 3/4/5-d, got {_ndim(x)}-d")
    enforce(size > 0, "local_response_norm",
            f"size must be positive, got {size}")


@infer_check("interpolate")
def _interpolate(x, size=None, scale_factor=None, mode="nearest",
                 *a, **k):
    enforce(size is not None or scale_factor is not None, "interpolate",
            "one of size= or scale_factor= is required")
    enforce(size is None or scale_factor is None, "interpolate",
            "size= and scale_factor= are mutually exclusive")
    enforce(_ndim(x) in (3, 4, 5), "interpolate",
            f"input must be 3/4/5-d, got {_ndim(x)}-d")


@infer_check("grid_sample")
def _grid_sample(x, grid, *a, **k):
    sx, sg = _shape(x), _shape(grid)
    enforce(len(sx) == 4 and len(sg) == 4, "grid_sample",
            f"x and grid must be 4-d, got x{list(sx)} grid{list(sg)}")
    enforce(sx[0] == sg[0], "grid_sample",
            f"batch sizes differ: x {sx[0]} vs grid {sg[0]}")
    enforce(sg[-1] == 2, "grid_sample",
            f"grid last dim must be 2 (x, y), got {sg[-1]}")


def _pixel_check(op):
    @infer_check(op)
    def check(x, factor, data_format="NCHW", *a, **k):
        sx = _shape(x)
        enforce(len(sx) == 4, op,
                f"input must be 4-d, got {list(sx)}")
        c = sx[-1] if str(data_format).endswith("C") else sx[1]
        if op == "pixel_shuffle":
            enforce(c % (factor * factor) == 0, op,
                    f"channels ({c}) must divide by upscale_factor^2 "
                    f"({factor}^2)")
        else:
            h = sx[1] if str(data_format).endswith("C") else sx[2]
            w = sx[2] if str(data_format).endswith("C") else sx[3]
            enforce(h % factor == 0 and w % factor == 0, op,
                    f"spatial dims ({h}x{w}) must divide by "
                    f"downscale_factor ({factor})")
    return check


for _n in ("pixel_shuffle", "pixel_unshuffle"):
    _pixel_check(_n)


@infer_check("unfold")
def _unfold(x, kernel_sizes, *a, **k):
    enforce(_ndim(x) == 4, "unfold",
            f"input must be 4-d [N, C, H, W], got {_ndim(x)}-d")


@infer_check("roll")
def _roll(x, shifts, axis=None, *a, **k):
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        for ax in axes:
            _check_axis("roll", ax, _ndim(x))
        ns = len(shifts) if isinstance(shifts, (list, tuple)) else 1
        enforce(ns == len(axes), "roll",
                f"shifts ({ns}) and axis ({len(axes)}) counts differ")


@infer_check("cross")
def _cross(x, y, axis=9, *a, **k):
    sx, sy = _shape(x), _shape(y)
    enforce(sx == sy, "cross",
            f"operands must have identical shapes, got x{list(sx)} "
            f"y{list(sy)}")
    if axis == 9:  # paddle sentinel: first dim of size 3
        enforce(3 in sx, "cross",
                f"no dimension of size 3 in shape {list(sx)}")
    else:
        _check_axis("cross", axis, len(sx))
        enforce(sx[axis] == 3, "cross",
                f"dim {axis} must have size 3, got {sx[axis]}")


@infer_check("dot")
def _dot(x, y, *a, **k):
    sx, sy = _shape(x), _shape(y)
    enforce(len(sx) in (1, 2) and sx == sy, "dot",
            f"dot needs two equal-shape 1-d or 2-d operands, got "
            f"x{list(sx)} y{list(sy)}")


@infer_check("index_sample")
def _index_sample(x, index, *a, **k):
    sx, si = _shape(x), _shape(index)
    enforce(len(sx) == 2 and len(si) == 2, "index_sample",
            f"x and index must be 2-d, got x{list(sx)} index{list(si)}")
    enforce(sx[0] == si[0], "index_sample",
            f"batch dims differ: x {sx[0]} vs index {si[0]}")


@infer_check("repeat_interleave")
def _repeat_interleave(x, repeats, axis=None, *a, **k):
    if axis is not None:
        _check_axis("repeat_interleave", axis, _ndim(x))
    if not _is_int(repeats):
        sr = _shape(repeats)
        enforce(len(sr) == 1, "repeat_interleave",
                f"repeats tensor must be 1-d, got {list(sr)}")


@infer_check("kthvalue")
def _kthvalue(x, k=None, axis=-1, keepdim=False, **kw):
    _check_axis("kthvalue", axis, _ndim(x))
    n = _shape(x)[axis]
    if k is not None:
        enforce(1 <= k <= n, "kthvalue",
                f"k must be in [1, {n}] for axis of size {n}, got {k}")


@infer_check("renorm")
def _renorm(x, p, axis, max_norm, *a, **k):
    _check_axis("renorm", axis, _ndim(x))
    enforce(p > 0, "renorm", f"p must be positive, got {p}")


@infer_check("searchsorted")
def _searchsorted(sorted_sequence, values, *a, **k):
    ss, sv = _shape(sorted_sequence), _shape(values)
    if len(ss) > 1:
        enforce(ss[:-1] == sv[:len(ss) - 1], "searchsorted",
                f"leading dims of sorted_sequence {list(ss)} must "
                f"match values {list(sv)}")


@infer_check("diagonal")
def _diagonal(x, offset=0, axis1=0, axis2=1, *a, **k):
    nd = _ndim(x)
    enforce(nd >= 2, "diagonal", f"input needs ndim >= 2, got {nd}")
    _check_axis("diagonal", axis1, nd)
    _check_axis("diagonal", axis2, nd)
    enforce(axis1 % nd != axis2 % nd, "diagonal",
            f"axis1 and axis2 must differ, both resolve to "
            f"{axis1 % nd}")


@infer_check("diag_embed")
def _diag_embed(x, offset=0, dim1=-2, dim2=-1, *a, **k):
    nd = _ndim(x) + 1
    enforce((dim1 % nd) != (dim2 % nd), "diag_embed",
            f"dim1 and dim2 must differ, both resolve to {dim1 % nd}")


@infer_check("temporal_shift")
def _temporal_shift(x, seg_num, *a, **k):
    sx = _shape(x)
    enforce(len(sx) == 4, "temporal_shift",
            f"input must be 4-d, got {list(sx)}")
    enforce(sx[0] % seg_num == 0, "temporal_shift",
            f"batch ({sx[0]}) must divide by seg_num ({seg_num})")


@infer_check("multi_dot")
def _multi_dot(xs, *a, **k):
    enforce(isinstance(xs, (list, tuple)) and len(xs) >= 2, "multi_dot",
            "multi_dot needs a list of >= 2 matrices")
    for i in range(len(xs) - 1):
        a_, b_ = _shape(xs[i]), _shape(xs[i + 1])
        ka = a_[-1]
        kb = b_[0] if len(b_) >= 1 else None
        enforce(ka == kb, "multi_dot",
                f"matrices {i} and {i + 1} have incompatible inner "
                f"dims: {list(a_)} @ {list(b_)}")
