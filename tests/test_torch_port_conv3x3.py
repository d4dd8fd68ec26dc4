"""The port's fused 3x3 conv + BN-statistics pair (TPU kernel table rows
17-18) against the JAX package's, on the CPU in fp32, inputs made with
numpy.

The JAX side runs its Pallas kernels in interpret mode, as its own
tests do, and its jnp mirrors ``_conv3x3_ref_fwd`` / ``_conv3x3_ref_bwd``,
under ``jax.default_matmul_precision("highest")``. The port runs the
plain versions of its kernels (CPU tensors) and its autograd Function.

Tolerances: y, mean and var within 1e-5, and dx, dw, dscale, dshift and
the gradients within 1e-4 (relative and absolute): fp32 sums of the same
products in another order, the JAX statistics one-pass shifted by image
0's means, the port's two-pass. The cases cover H != W, C != O, a
1-pixel-high image, a positive shift (relu(shift) > 0, so a border read
as relu(shift) instead of 0 shows) and a weight with no symmetry, so a
wrong or unflipped tap shows.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.fused_resnet as jfr
from paddle_tpu_torch.kernels import fused_resnet as tfr

HIGHEST = jax.default_matmul_precision("highest")

# (n, h, w, c, o, shift offset)
_CASES = [
    (2, 5, 7, 8, 16, 0.0),      # H != W, C != O
    (2, 6, 6, 16, 8, 0.4),      # positive shift: relu(shift) > 0
    (3, 1, 9, 8, 8, 0.3),       # a 1-pixel-high image
    (1, 9, 4, 24, 16, -0.1),
]


def _inputs(case, seed):
    n, h, w, c, o, off = case
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, w, c) + 0.3).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = (rng.randn(c) * 0.3 + off).astype(np.float32)
    # no symmetry: every tap, input and output channel differs
    w9 = (rng.randn(9 * c, o) * (9 * c) ** -0.5
          + np.linspace(0.0, 0.2, 9 * c * o).reshape(9 * c, o)
          ).astype(np.float32)
    return x, scale, shift, w9


def _bwd_inputs(case, seed, y, mean):
    n, h, w, c, o, _ = case
    rng = np.random.RandomState(seed + 100)
    dy = rng.randn(n, h, w, o).astype(np.float32)
    perch, dvar2 = (np.asarray(v) for v in jfr._stats_cotangent_coeffs(
        jnp.asarray(rng.randn(o).astype(np.float32)),
        jnp.asarray(rng.randn(o).astype(np.float32)), n * h * w))
    return dy, np.asarray(y), perch, dvar2, np.asarray(mean)


def _close(out, ref, tol, what=""):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("case", _CASES)
def test_plain_forward_matches_pallas_and_mirror(case):
    x, scale, shift, w9 = _inputs(case, sum(case[:5]))
    with HIGHEST:
        jy, jmean, jvar = jfr.conv3x3_bn_act_stats(
            *map(jnp.asarray, (x, scale, shift, w9)))
        ry, s, q, k = jfr._conv3x3_ref_fwd(
            *map(jnp.asarray, (x, scale, shift, w9)))
        rmean, rvar = jfr._finish_shifted_stats(s, q, k,
                                                int(np.prod(x.shape[:3])))
    tfr.reset_counts()
    y, mean, var = tfr.conv3x3_bn_stats_fwd(
        *map(torch.tensor, (x, scale, shift, w9)))
    assert tfr.conv3x3_bn_stats_fwd_plain.calls == 1
    assert tfr.conv3x3_bn_stats_fwd.launches == 0
    for out, refs, name in ((y, (jy, ry), "y"), (mean, (jmean, rmean), "mean"),
                            (var, (jvar, rvar), "var")):
        for ref in refs:
            _close(out.numpy(), ref, 1e-5, name)


@pytest.mark.parametrize("case", _CASES)
def test_plain_backward_matches_pallas_and_mirror(case):
    n, h, w, c, o, _ = case
    x, scale, shift, w9 = _inputs(case, sum(case[:5]))
    with HIGHEST:
        jx = tuple(map(jnp.asarray, (x, scale, shift, w9)))
        y, mean, _ = jfr.conv3x3_bn_act_stats(*jx)
        dy, y, perch, dvar2, mean = _bwd_inputs(case, sum(case[:5]), y, mean)
        wf9 = jfr._conv3x3_flip(jx[3], c, o)
        pallas = jfr._conv3x3_bwd_pallas(
            jnp.asarray(dy), jnp.asarray(y), jx[0], jx[1], jx[2], jx[3], wf9,
            jnp.asarray(perch), jnp.asarray(dvar2), jnp.asarray(mean),
            interpret=True)
        mirror = jfr._conv3x3_ref_bwd(
            jnp.asarray(dy), jnp.asarray(y), jx[0], jx[1], jx[2], jx[3],
            jnp.asarray(perch), jnp.asarray(dvar2), jnp.asarray(mean))
    tfr.reset_counts()
    dx, dw, dscale, dshift = tfr.conv3x3_bn_stats_bwd(
        *map(torch.tensor, (dy, y, x, scale, shift, w9, perch, dvar2, mean)))
    assert tfr.conv3x3_bn_stats_bwd_plain.calls == 1
    assert tfr.conv3x3_bn_stats_bwd.launches == 0
    assert dw.shape == (9 * c, o) and dw.dtype == torch.float32
    # the Pallas kernel returns (dx, dw, ds, dt), the mirror (dx, ds, dt, dw)
    refs = {"dx": (pallas[0], mirror[0]), "dw": (pallas[1], mirror[3]),
            "dscale": (pallas[2], mirror[1]), "dshift": (pallas[3], mirror[2])}
    for name, out in (("dx", dx), ("dw", dw), ("dscale", dscale),
                      ("dshift", dshift)):
        for ref in refs[name]:
            _close(out.numpy(), ref, 1e-4, name)


def _loss_jax(x, scale, shift, w9):
    y, m, v = jfr.conv3x3_bn_act_stats(x, scale, shift, w9)
    return jnp.sum(y * y) + jnp.sum(m * 3.0) + jnp.sum(v * 0.5)


@pytest.mark.parametrize("case", _CASES)
def test_autograd_function_matches_jax_grad(case):
    args = _inputs(case, 7 + sum(case[:5]))
    with HIGHEST:
        jgrads = jax.grad(_loss_jax, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tfr.reset_counts()
    y, mean, var = tfr.conv3x3_bn_act_stats(*targs)
    ((y * y).sum() + (mean * 3.0).sum() + (var * 0.5).sum()).backward()
    assert [tfr.conv3x3_bn_stats_fwd_plain.calls,
            tfr.conv3x3_bn_stats_bwd_plain.calls] == [1, 1]
    for t, g, name in zip(targs, jgrads, ("x", "scale", "shift", "w9")):
        _close(t.grad.numpy(), g, 1e-4, name)


def test_paddle_weight_entry_matches_jax():
    """``bn_relu_conv3x3_bn_stats`` builds w9 from the Paddle [O, I, 3, 3]
    weight as the JAX package does: outputs and gradients (the weight's
    included) through both."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6, 5, 16) + 0.2).astype(np.float32)
    scale = (rng.rand(16) + 0.5).astype(np.float32)
    shift = (rng.randn(16) * 0.3 + 0.2).astype(np.float32)
    weight = (rng.randn(8, 16, 3, 3) / 12).astype(np.float32)

    def loss(fn, *a):
        y, m, v = fn(*a)
        return (y * y).sum() + (m * 3.0).sum() + (v * 0.5).sum()

    with HIGHEST:
        jargs = tuple(map(jnp.asarray, (x, scale, shift, weight)))
        jout = jfr.bn_relu_conv3x3_bn_stats(*jargs)
        jgrads = jax.grad(lambda *a: loss(jfr.bn_relu_conv3x3_bn_stats, *a),
                          argnums=(0, 1, 2, 3))(*jargs)
    targs = [torch.tensor(a, requires_grad=True)
             for a in (x, scale, shift, weight)]
    tout = tfr.bn_relu_conv3x3_bn_stats(*targs)
    for out, ref in zip(tout, jout):
        _close(out.detach().numpy(), ref, 1e-5)
    loss(tfr.bn_relu_conv3x3_bn_stats, *targs).backward()
    for t, g in zip(targs, jgrads):
        _close(t.grad.numpy(), g, 1e-4)


def test_border_reads_zero_in_the_activation_domain():
    """With shift > 0 everywhere relu(shift) > 0: the border of a zero
    input must still read 0, so y is 0 at the corner where only the
    (zero) border and zero inputs meet the one nonzero tap."""
    x = torch.zeros((1, 3, 3, 8))
    scale, shift = torch.ones(8), torch.full((8,), 0.5)
    w9 = torch.zeros((72, 8))
    w9[:8] = 1.0            # tap (0, 0): reads the pixel up and left
    y, _, _ = tfr.conv3x3_bn_stats_fwd(x, scale, shift, w9)
    assert float(y[0, 0, 0].abs().max()) == 0.0       # the border
    np.testing.assert_allclose(y[0, 1, 1].numpy(), 4.0)   # 8 * relu(0.5)


def _gemm_route_forward(x, scale, shift, w9, row_tile=128):
    """The forward's implicit GEMM route in torch, as its kernels take it:
    the pre-pass a = T(relu(x*scale + shift)) [M, C]; A [M, 9C] gathers
    tap t of pixel p from a, zero where the tap leaves the image (the
    activation domain's zero); y = T(A @ w9) from fp32 sums; each
    ``row_tile``-pixel row tile its (count, mean, M2), two-pass over the
    rounded y; Chan's combine of the tiles in row order."""
    n, h, w, c = x.shape
    a = torch.relu(x.float() * scale + shift).to(x.dtype)
    ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    taps = [ap[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]
    big = torch.cat(taps, dim=-1).reshape(n * h * w, 9 * c)
    y = (big.float() @ w9.float()).to(x.dtype)
    yf = y.float()
    cnt, mean, m2 = 0, torch.zeros(w9.shape[1]), torch.zeros(w9.shape[1])
    for t0 in range(0, yf.shape[0], row_tile):
        tile = yf[t0:t0 + row_tile]
        nb, mb = tile.shape[0], tile.mean(0)
        qb = ((tile - mb) ** 2).sum(0)
        tot = cnt + nb
        delta = mb - mean
        mean = mean + delta * (nb / tot)
        m2 = m2 + qb + delta * delta * (cnt * nb / tot)
        cnt = tot
    return y.reshape(n, h, w, -1), mean, m2 / cnt


@pytest.mark.parametrize("case", _CASES)
def test_gemm_route_mirror_matches_pallas(case):
    """The GEMM route's algorithm (a written once, taps gathered with
    zero fill, per-tile statistics combined in a fixed order) against the
    Pallas forward in interpret mode, fp32, including a positive shift
    (relu(shift) > 0: a border read as relu(shift) would show). A row
    tile of 16 pixels gives the small cases several tiles."""
    x, scale, shift, w9 = _inputs(case, sum(case[:5]))
    with HIGHEST:
        jy, jmean, jvar = jfr.conv3x3_bn_act_stats(
            *map(jnp.asarray, (x, scale, shift, w9)))
    y, mean, var = _gemm_route_forward(
        *map(torch.tensor, (x, scale, shift, w9)), row_tile=16)
    _close(y.numpy(), jy, 1e-5, "y")
    _close(mean.numpy(), jmean, 1e-5, "mean")
    _close(var.numpy(), jvar, 1e-5, "var")


def test_gemm_route_mirror_matches_the_plain_version_in_bf16():
    """In bf16 the mirror rounds a and y where the plain version does:
    y within one bf16 ulp (fp32 sums in another order), the statistics
    of the rounded y within 1e-5."""
    x, scale, shift, w9 = _inputs((2, 7, 7, 16, 24, 0.4), 5)
    xt, wt = torch.tensor(x).bfloat16(), torch.tensor(w9).bfloat16()
    st, sh = torch.tensor(scale), torch.tensor(shift)
    y, mean, var = _gemm_route_forward(xt, st, sh, wt, row_tile=32)
    py, pmean, pvar = tfr.conv3x3_bn_stats_fwd_plain(xt, st, sh, wt)
    diff = (y.float() - py.float()).abs()
    assert bool((diff <= 2.0 ** -7 * py.float().abs() + 1e-6).all())
    ym, yv = tfr._two_pass_stats(y)
    _close(mean.numpy(), ym.numpy(), 1e-5)
    _close(var.numpy(), yv.numpy(), 1e-5)


_VMEM_SHAPES = [  # ResNet-50's stride-1 3x3s at b128 224x224 and 448x448
    (56, 56, 64, 64), (28, 28, 128, 128), (14, 14, 256, 256),
    (7, 7, 512, 512), (112, 112, 64, 64), (56, 56, 128, 128),
    (28, 28, 256, 256), (14, 14, 512, 512)]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_conv3x3_vmem_ok_is_the_references(itemsize):
    rng = np.random.RandomState(itemsize)
    grid = _VMEM_SHAPES + [tuple(int(v) for v in rng.choice(
        (1, 3, 7, 14, 28, 56, 90, 112, 200), 2)) + tuple(int(v) for v in
        rng.choice((8, 64, 128, 256, 512, 1024), 2)) for _ in range(40)]
    for h, w, c, o in grid:
        assert tfr.conv3x3_vmem_ok(h, w, c, o, itemsize) == \
            jfr.conv3x3_vmem_ok(h, w, c, o, itemsize), (h, w, c, o)
    ok = [tfr.conv3x3_vmem_ok(*s, itemsize=2) for s in _VMEM_SHAPES]
    # every stride-1 3x3 at 224 takes the fused route; at 448 layer1's
    # does not
    assert ok[:4] == [True] * 4 and ok[4] is False


@pytest.mark.parametrize("n,h,w", [(128, 56, 56), (128, 28, 28),
                                   (128, 14, 14), (128, 7, 7), (2, 1, 9),
                                   (3, 300, 5), (1, 2, 300)])
def test_tiling_covers_every_pixel_once(n, h, w):
    """The kernels' tile geometry, as the wrapper gives it: at most 128
    pixels and 512 window positions a tile, and the tiles' slabs cover
    every pixel of the batch exactly once."""
    r, wt, g, tiles = tfr._conv3x3_tiles(n, h, w)
    assert g * r * wt <= tfr._PIX3 and g * (r + 2) * (wt + 2) <= tfr._WIN3
    bands, ctiles = -(-h // r), -(-w // wt)
    seen = np.zeros((n, h, w), np.int64)
    for sg in range(min(tiles * g, n * bands * ctiles)):
        img, rest = divmod(sg, bands * ctiles)
        b, ct = divmod(rest, ctiles)
        seen[img, b * r:(b + 1) * r, ct * wt:(ct + 1) * wt] += 1
    assert (seen == 1).all()
    assert (tiles - 1) * g < n * bands * ctiles <= tiles * g
    chunks, per = tfr._dw3_chunks(tiles, 64, 64)
    assert (chunks - 1) * per < tiles <= chunks * per


def test_kernel_wrappers_check_their_inputs():
    x = torch.zeros((1, 4, 4, 12))
    with pytest.raises(ValueError, match=r"\[9C,O\]"):
        tfr.conv3x3_bn_stats_fwd(x, torch.ones(12), torch.zeros(12),
                                 torch.zeros((12, 8)))
    with pytest.raises(ValueError, match="scale"):
        tfr.conv3x3_bn_stats_fwd(x, torch.ones(8), torch.zeros(12),
                                 torch.zeros((108, 8)))
    with pytest.raises(ValueError, match="dy"):
        tfr.conv3x3_bn_stats_bwd(torch.zeros((1, 4, 4, 4)),
                                 torch.zeros((1, 4, 4, 8)), x,
                                 torch.ones(12), torch.zeros(12),
                                 torch.zeros((108, 8)), torch.zeros(8),
                                 torch.zeros(8), torch.zeros(8))


def test_conv3x3_module_imports_no_jax():
    code = ("import sys, paddle_tpu_torch.kernels.fused_resnet as k; "
            "assert callable(k.conv3x3_bn_stats_fwd); "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
