#!/usr/bin/env python3
"""Time the fused CE backward (TPU kernel table row 12) and the fused
3x3 conv + BN-statistics forward (row 17) through their public
wrappers only, so that the same script times any tree of the port and
two trees can be compared in one call on one card:

    python3 experiments/ce_conv3x3_probe.py [TREE] [--only=ce|conv]
                                            [--route=gemm|window]

TREE (default: this checkout) is the root whose ``paddle_tpu_torch`` is
imported and built. Row 12 runs at gpt2-small's LM head at b16 s1024
(h [16368, 768], tied W [50257, 768] bf16, every 7th label ignored),
two input sets in turn; its line gives the device ms per call
(``chip_smoke.DeviceTimer``), the device ms per call of each kernel it
launches (a profile of 3 calls), the scratch the wrapper plans
(``ce_bwd_plan``, 0 where the tree has none) and the peak of
``torch.cuda.max_memory_allocated`` over the call above what was
allocated before it, beside the yardstick (``torch.autograd.grad`` of
the saved-logits forward in PyTorch calls, ``chip_smoke._ce_library``),
the bound (``chip_smoke._ce_bound``) and the share of it. Row 17 runs at
ResNet-50's four stride-1 3x3 shapes at b128 (``chip_smoke.
_CONV3_SHAPES``), three input sets in turn, with a shift that makes
relu(shift) > 0 on some channels; each line gives the route the wrapper
takes, the device ms per call, the ms by kernel (pre-pass, product,
combine), the yardstick (the prologue in torch, ``F.conv2d`` on
channels-last bf16 and ``torch.var_mean``), the bound
(``chip_smoke._conv3x3_bound``) and the share. ``--route`` sends row 17
down that route at every shape (``fused_resnet._launch_fwd3``; a tree
that has the route). The first line is the card's name and power
limit.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = os.path.abspath(ARGS[0]) if ARGS else REPO
ONLY = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--only=")]
ROUTE = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--route=")]
sys.path.insert(0, TREE)

import importlib.util  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import fused_ce as fc  # noqa: E402
from paddle_tpu_torch.kernels import fused_resnet as fr  # noqa: E402

# this checkout's chip_smoke (its timer, bounds and shapes), whatever
# TREE is
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def ce_row(timer, card):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 8)
    n, hd, vocab = 16368, 768, 50257

    def make():
        h = torch.randn(n, hd, generator=gen, device=dev).bfloat16()
        w = (torch.randn(vocab, hd, generator=gen, device=dev)
             * 0.02).bfloat16()
        y = torch.randint(0, vocab, (n,), generator=gen, device=dev)
        y[::7] = -1
        dce = torch.rand(n, generator=gen, device=dev) / n
        lse, _ = fc.ce_fwd(h, w, y)
        return h, w, y, lse, dce

    sets = [make(), make()]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fc.ce_bwd(*sets[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    ms = timer.ms(fc.ce_bwd, sets, n=5)
    by = chip_smoke._kernel_ms(torch, fc.ce_bwd, sets[0], n=3)
    graphs = []
    for h, w, y, _, dce in sets:
        hg, wg = h.detach().requires_grad_(), w.detach().requires_grad_()
        graphs.append((chip_smoke._ce_library(torch, hg, wg, y), hg, wg,
                       dce))
    lib_ms = timer.ms(lambda o, hg, wg, d: torch.autograd.grad(
        o, (hg, wg), d, retain_graph=True), graphs, n=3)
    del graphs
    plan = getattr(fc, "ce_bwd_plan", None)
    scratch = plan(n, vocab, hd, 2)[2] if plan else 0
    bms, by_what = chip_smoke._ce_bound(n, hd, vocab, 2, True)
    print(json.dumps(dict(
        row=12, tree=TREE, card=card, shape=[n, hd, vocab], dtype="bf16",
        ms=ms, ms_by_kernel=by, scratch_bytes=scratch,
        peak_bytes_over_inputs=peak, library_ms=lib_ms, bound_ms=bms,
        bound_by=by_what, share_of_bound=bms / ms,
        over_library=ms / lib_ms)), flush=True)
    del sets
    torch.cuda.empty_cache()


def conv_rows(timer, card):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 6)
    bf16 = torch.bfloat16
    route_of = getattr(fr, "_conv3x3_route", lambda *_: "window")
    call = fr.conv3x3_bn_stats_fwd
    if ROUTE:
        def route_of(*_):
            return ROUTE[0]

        def call(*args):
            return fr._launch_fwd3(*args, ROUTE[0])
    for shape in chip_smoke._CONV3_SHAPES:
        nb, h, w, c, o = shape

        def r(*s, scale=1.0):
            return torch.randn(s, generator=gen, device=dev) * scale

        sets, lib_sets = [], []
        for _ in range(3):
            x = (r(nb, h, w, c) + 0.5).to(bf16)
            w9 = r(9 * c, o, scale=(9 * c) ** -0.5).to(bf16)
            scale, shift = r(c).abs() + 0.5, r(c, scale=0.3) + 0.1
            sets.append((x, scale, shift, w9))
            wl = w9.reshape(3, 3, c, o).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_sets.append((x, scale, shift, wl))

        def lib_fwd(x, scale, shift, wl):
            a = torch.relu(x.float() * scale + shift).to(bf16)
            y = TF.conv2d(a.permute(0, 3, 1, 2), wl, padding=1)
            return y, torch.var_mean(y.float(), (0, 2, 3), correction=0)

        ms = timer.ms(call, sets)
        lib_ms = timer.ms(lib_fwd, lib_sets)
        by = chip_smoke._kernel_ms(torch, call, sets[0], n=10)
        bms, by_what = chip_smoke._conv3x3_bound(*shape, False)
        print(json.dumps(dict(
            row=17, tree=TREE, card=card, shape=list(shape),
            route=route_of(h, w, c, o), ms=ms, ms_by_kernel=by,
            library_ms=lib_ms, bound_ms=bms, bound_by=by_what,
            share_of_bound=bms / ms, over_library=ms / lib_ms)), flush=True)
        del sets, lib_sets
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.build_all(["fused_ce", "fused_conv3x3"])
    timer = chip_smoke.DeviceTimer(torch)
    if not ONLY or "ce" in ONLY:
        ce_row(timer, card)
    if not ONLY or "conv" in ONLY:
        conv_rows(timer, card)


if __name__ == "__main__":
    main()
