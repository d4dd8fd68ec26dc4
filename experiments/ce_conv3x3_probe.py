#!/usr/bin/env python3
"""Time the fused CE forward and backward (TPU kernel table rows 11 and
12) and the fused 3x3 conv + BN-statistics forward (row 17) through
their public wrappers only, so that the same script times any tree of
the port and two trees can be compared in one call on one card:

    python3 experiments/ce_conv3x3_probe.py [TREE] [--only=fwd|ce|conv]
                                            [--route=gemm|window]
                                            [--fwd-variant=VARIANT]

TREE (default: this checkout) is the root whose ``paddle_tpu_torch`` is
imported and built. Row 11 (``--only=fwd``) runs ``ce_fwd`` at the same
shape and data as row 12 below; its line gives the device ms per call,
the ms by kernel, the saved-logits forward in PyTorch calls
(``chip_smoke._ce_library``) as the yardstick, the bound and the share.
Row 12 runs at gpt2-small's LM head at b16 s1024
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
that has the route). ``--fwd-variant`` times row 11 on a copy of
TREE's package (in TREE's ``build/fwd_variants/``) whose
``csrc/fused_ce.cu`` is edited: ``product-only`` cuts the bf16
forward's softmax step out (the ring, the products and the fold alone,
its lse meaningless), which says what the softmax costs; ``splits=K``
folds K vocabulary splits in place of 8. The first line is the card's
name and power limit.
"""
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = os.path.abspath(ARGS[0]) if ARGS else REPO
ONLY = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--only=")]
ROUTE = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--route=")]
VARIANT = [a.split("=", 1)[1] for a in sys.argv[1:]
           if a.startswith("--fwd-variant=")]
# the bf16 forward's softmax step, as fused_ce.cu calls it (two calls)
_STEP = re.compile(r"fwd_step<(?:true|false)>\(acc\[c\], hh, tw, lim, yc, "
                   r"rm\[hh\], rl\[hh\], gold\);")


def variant_tree(tree, variant):
    """The root of a copy of ``tree``'s package with the forward edited
    as ``variant`` says."""
    root = os.path.join(tree, "build", "fwd_variants", variant)
    pkg = os.path.join(root, "paddle_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "paddle_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(pkg, "csrc", "fused_ce.cu")
    text = open(src).read()
    if variant == "product-only":
        # keep the accumulators, the label and gold live, as the step does
        text, n = _STEP.subn(
            "rl[hh] += acc[c][hh] + yc + (gold != nullptr);", text)
        want = 2
    elif variant.startswith("splits="):
        text, n = re.subn(r"constexpr int kFwdSplits = \d+;",
                          f"constexpr int kFwdSplits = {int(variant[7:])};",
                          text)
        want = 1
    else:
        sys.exit(f"unknown --fwd-variant {variant}")
    if n != want:
        sys.exit(f"{variant}: {n} places in fused_ce.cu, {want} expected")
    with open(src, "w") as f:
        f.write(text)
    return root


if VARIANT:
    TREE = variant_tree(TREE, VARIANT[0])
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


def _lm_head_sets(n, hd, vocab):
    """Two input sets at the LM head (W is 77 MB: a call does not find
    the last one's W in L2): h, W, y with every 7th label ignored, the
    forward's lse and a cotangent of a mean."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 8)

    def make():
        h = torch.randn(n, hd, generator=gen, device=dev).bfloat16()
        w = (torch.randn(vocab, hd, generator=gen, device=dev)
             * 0.02).bfloat16()
        y = torch.randint(0, vocab, (n,), generator=gen, device=dev)
        y[::7] = -1
        dce = torch.rand(n, generator=gen, device=dev) / n
        lse, _ = fc.ce_fwd(h, w, y)
        return h, w, y, lse, dce

    return [make(), make()]


def fwd_row(timer, card):
    n, hd, vocab = 16368, 768, 50257
    sets = [s[:3] for s in _lm_head_sets(n, hd, vocab)]
    ms = timer.ms(fc.ce_fwd, sets, n=10)
    by = chip_smoke._kernel_ms(torch, fc.ce_fwd, sets[0], n=3)
    lib_ms = timer.ms(lambda h, w, y: chip_smoke._ce_library(torch, h, w, y),
                      sets, n=10)
    bms, by_what = chip_smoke._ce_bound(n, hd, vocab, 2, False)
    print(json.dumps(dict(
        row=11, tree=TREE, variant=VARIANT[0] if VARIANT else None,
        card=card, shape=[n, hd, vocab], dtype="bf16",
        ms=ms, ms_by_kernel=by, library_ms=lib_ms, bound_ms=bms, bound_by=by_what,
        share_of_bound=bms / ms, over_library=ms / lib_ms)), flush=True)
    del sets
    torch.cuda.empty_cache()


def ce_row(timer, card):
    n, hd, vocab = 16368, 768, 50257
    sets = _lm_head_sets(n, hd, vocab)
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
    if not ONLY or "fwd" in ONLY:
        fwd_row(timer, card)
    if not ONLY or "ce" in ONLY:
        ce_row(timer, card)
    if not ONLY or "conv" in ONLY:
        conv_rows(timer, card)


if __name__ == "__main__":
    main()
