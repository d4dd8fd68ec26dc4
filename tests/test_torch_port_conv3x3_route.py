"""The host side of the fused 3x3 forward and backward (TPU kernel table
rows 17-18, ``csrc/fused_conv3x3.cu``), on the CPU: the one route both
wrappers choose from (H, W, C, O) alone (the window kernels or the
implicit GEMMs on the 1x1 kernels' tile body, ``csrc/conv_gemm.cuh``)
and each route's split of the work, at the four stride-1 3x3 shapes of ResNet-50 at b128; the
GEMM route's tile read from the kernel sources where the library
exports it (``tests/test_torch_port_fused_1x1.py`` holds the built
library to the same on the card).
"""
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.kernels import fused_resnet as fr

_CSRC = Path(fr.__file__).resolve().parent.parent / "csrc"

# (N, H, W, C, O) of ResNet-50's stride-1 3x3 convolutions at b128
# 224x224 (layer1-4), with the route each takes
_RESNET50_3X3 = [((128, 56, 56, 64, 64), "window"),
                 ((128, 28, 28, 128, 128), "gemm"),
                 ((128, 14, 14, 256, 256), "gemm"),
                 ((128, 7, 7, 512, 512), "gemm")]


def _source_geometry():
    """The GEMM route's tile, the 1x1 kernels' (``fused_resnet.cu``'s
    ``paddle_mm_bn_stats_geometry``, which ``_geometry()`` reads from the
    built library): the tile body's constants in ``conv_gemm.cuh`` that
    the entry writes into g[0..3]."""
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);",
        (_CSRC / "conv_gemm.cuh").read_text())}
    src = (_CSRC / "fused_resnet.cu").read_text()
    body = re.search(r"paddle_mm_bn_stats_geometry\(int\* g\) \{(.*?)\}",
                     src, re.S).group(1)
    slots = dict(re.findall(r"g\[(\d)\] = (k\w+)", body))
    assert sorted(slots) == ["0", "1", "2", "3"]
    return tuple(consts[slots[str(i)]] for i in range(4))


@pytest.mark.parametrize("shape,route", _RESNET50_3X3)
def test_route_at_the_resnet50_shapes(shape, route):
    _, h, w, c, o = shape
    assert fr._conv3x3_route(h, w, c, o) == route


@pytest.mark.parametrize("h,w,c,o,route", [
    (7, 7, 64, 512, "window"),      # a 64-channel side idles half a tile
    (7, 7, 512, 64, "window"),
    (56, 56, 256, 256, "window"),   # large images: the windows are dense
    (28, 28, 128, 256, "gemm"),
    (1, 9, 128, 128, "gemm"),
])
def test_route_depends_on_the_shape_alone(h, w, c, o, route):
    assert fr._conv3x3_route(h, w, c, o) == route


@pytest.mark.parametrize("shape,route", _RESNET50_3X3)
def test_backward_split_covers_the_work_once(shape, route):
    """The window route: its dw chunks of whole pixel tiles cover the
    tiles once, within the grid's z limit and the partials' budget. The
    GEMM route: its dw chunks take whole pixel steps and cover the N*H*W
    pixels once; its dscale/dshift partials have a row per row tile."""
    n, h, w, c, o = shape
    geometry = _source_geometry()
    r, wt, g, chunks, per, tiles = fr._conv3x3_bwd_plan(
        n, h, w, c, o, route, geometry)
    assert 1 <= chunks <= 65535
    if route == "window":
        assert (r, wt, g, tiles) == fr._conv3x3_tiles(n, h, w)
        assert (chunks - 1) * per < tiles <= chunks * per
        assert chunks * 36 * c * o <= fr._DW3_SCRATCH
        return
    m = n * h * w
    row_tile, _, _, step = geometry
    assert per % step == 0
    assert (chunks - 1) * per < m <= chunks * per
    covered = torch.zeros(m, dtype=torch.int32)
    for i in range(chunks):
        covered[i * per:(i + 1) * per] += 1
    assert bool((covered == 1).all())
    assert (tiles - 1) * row_tile < m <= tiles * row_tile
    # the dw partials of every chunk, fp32 [chunks, 9C, O], stay modest
    assert chunks * 36 * c * o <= 64 * 2 ** 20


# ---------------------------------------------------------------- forward

def _routes_taken(monkeypatch, n, h, w, c, o):
    """[forward's, backward's] route that the two wrappers hand their
    launches for x [n, h, w, c] and w9 [9c, o]: meta tensors stand for
    CUDA ones, with the shape checks and the launches stubbed out."""
    taken = []
    for name in ("_check3", "_check_bwd3"):
        monkeypatch.setattr(fr, name, lambda *a: None)
    for name in ("_launch_fwd3", "_launch_bwd3"):
        monkeypatch.setattr(fr, name, lambda *a: taken.append(a[-1]))
    for fn in (fr.conv3x3_bn_stats_fwd, fr.conv3x3_bn_stats_bwd):
        monkeypatch.setattr(fn, "launches", 0)

    def meta(*shape):
        return torch.empty(shape, device="meta")
    x, w9, vc, vo = meta(n, h, w, c), meta(9 * c, o), meta(c), meta(o)
    fr.conv3x3_bn_stats_fwd(x, vc, vc, w9)
    y = meta(n, h, w, o)
    fr.conv3x3_bn_stats_bwd(y, y, x, vc, vc, w9, vo, vo, vo)
    return taken


@pytest.mark.parametrize("shape,route", _RESNET50_3X3)
def test_forward_route_at_the_resnet50_shapes(monkeypatch, shape, route):
    """The forward and the backward take one route, ``_conv3x3_route``'s,
    at every ResNet-50 shape."""
    _, h, w, c, o = shape
    assert _routes_taken(monkeypatch, 1, h, w, c, o) == [route, route]


@pytest.mark.parametrize("h,w,c,o,route", [
    (7, 7, 64, 512, "window"),
    (7, 7, 512, 64, "window"),
    (56, 56, 256, 256, "window"),
    (28, 28, 128, 256, "gemm"),
    (1, 9, 128, 128, "gemm"),
    (29, 28, 128, 128, "window"),   # one row past the largest image
])
def test_forward_route_depends_on_the_shape_alone(monkeypatch, h, w, c, o,
                                                  route):
    assert fr._conv3x3_route(h, w, c, o) == route
    assert _routes_taken(monkeypatch, 2, h, w, c, o) == [route, route]


@pytest.mark.parametrize("shape,route", _RESNET50_3X3)
def test_forward_plan_and_grid(shape, route):
    """The window route keeps its tiling. The GEMM route runs the 1x1
    kernels' tile (``_source_geometry``: 128 pixels x 128 output
    channels) and writes one statistics row a row tile; its grid of
    ceil(M / 128) x ceil(O / 128) tiles covers the output once."""
    n, h, w, c, o = shape
    geometry = _source_geometry()
    plan = fr._conv3x3_fwd_plan(n, h, w, route, geometry)
    if route == "window":
        assert plan == fr._conv3x3_tiles(n, h, w)
        return
    rows, cols = geometry[0], geometry[2]
    assert (rows, cols) == (128, 128)
    m = n * h * w
    assert plan == (0, 0, 0, -(-m // rows))
    row_tiles, col_tiles = -(-m // rows), -(-o // cols)
    assert (row_tiles - 1) * rows < m <= row_tiles * rows
    assert (col_tiles - 1) * cols < o <= col_tiles * cols
