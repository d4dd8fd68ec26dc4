"""The host side of the port's fused 1x1 conv + BN-statistics kernels
(TPU kernel table rows 13-16, ``csrc/fused_resnet.cu``), on the CPU: the
tile geometry the wrapper sizes its buffers and dw chunks by, read from
the kernel source where the library exports it; the dw kernel's split of
the rows at every 1x1 shape of ResNet-50 at b128; and ``route``'s
arguments. One test needs the card (the built library's geometry against
the source's) and skips elsewhere.
"""
import re
import shutil
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.kernels import fused_resnet as fr

_CSRC = Path(fr.__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "fused_resnet.cu"
# the tile body and its constants, which fused_resnet.cu includes
_BODY = _CSRC / "conv_gemm.cuh"

# (M, K, N) of every 1x1 convolution of ResNet-50 at b128 224x224 (the
# stride on the 3x3, so a stage's first conv1 runs at the previous
# stage's resolution; the downsample reads its strided input)
_RESNET50_1X1 = [
    (401408, 64, 64), (401408, 64, 256), (401408, 256, 64),     # layer1
    (401408, 256, 128), (100352, 128, 512), (100352, 256, 512),  # layer2
    (100352, 512, 128),
    (100352, 512, 256), (25088, 256, 1024), (25088, 512, 1024),  # layer3
    (25088, 1024, 256),
    (25088, 1024, 512), (6272, 512, 2048), (6272, 1024, 2048),   # layer4
    (6272, 2048, 512),
]


def _source_geometry():
    """``paddle_mm_bn_stats_geometry``'s four values, read from the
    kernel source: the constants (of the tile body it includes) it writes
    into g[0..3]."""
    src = _SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);",
                         _BODY.read_text())}
    body = re.search(r"paddle_mm_bn_stats_geometry\(int\* g\) \{(.*?)\}",
                     src, re.S).group(1)
    slots = dict(re.findall(r"g\[(\d)\] = (k\w+)", body))
    assert sorted(slots) == ["0", "1", "2", "3"]
    return tuple(consts[slots[str(i)]] for i in range(4))


@pytest.mark.parametrize("m,k,n", _RESNET50_1X1)
def test_dw_split_covers_every_row_once(m, k, n):
    """The dw kernel's chunks take whole row steps and cover the rows
    exactly once (the last chunk may be short), within the grid's z
    limit; the statistics' row tiles cover the rows once."""
    geometry = _source_geometry()
    row_tile, _, _, step = geometry
    chunks, rows = fr._dw_chunks(m, k, n, geometry)
    assert rows % step == 0 and 1 <= chunks <= 65535
    assert (chunks - 1) * rows < m <= chunks * rows
    covered = torch.zeros(m, dtype=torch.int32)
    for c in range(chunks):
        covered[c * rows:(c + 1) * rows] += 1
    assert bool((covered == 1).all())
    tiles = -(-m // row_tile)
    assert (tiles - 1) * row_tile < m <= tiles * row_tile


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_route_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fr.route(dtype)


def test_coefficients_are_aligned_for_8_wide_reads():
    """The kernels read scale, shift, perch, dvar2 and mean 8 floats at a
    time: a misaligned view is copied, an aligned one kept."""
    t = torch.arange(9, dtype=torch.float32)[1:]
    assert t.data_ptr() % 16
    out = fr._f32(t)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, t)
    aligned = torch.arange(8, dtype=torch.float32)
    assert fr._f32(aligned).data_ptr() == aligned.data_ptr()


@pytest.mark.cuda
def test_library_geometry_is_the_sources():
    ok = torch.cuda.is_available() and \
        torch.cuda.get_device_capability(0) >= (9, 0) and \
        (shutil.which("nvcc") is not None
         or Path("/usr/local/cuda/bin/nvcc").exists())
    if not ok:
        pytest.skip("needs an sm_90 GPU and nvcc")
    assert fr._geometry() == _source_geometry()
