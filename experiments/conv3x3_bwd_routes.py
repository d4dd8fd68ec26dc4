#!/usr/bin/env python3
"""Time both routes of the fused 3x3 backward (TPU kernel table row 18)
at ResNet-50's four stride-1 3x3 shapes at b128, on one CUDA card:

    python3 experiments/conv3x3_bwd_routes.py

The window kernels and the implicit GEMMs on the 1x1 kernels' tile body
(``kernels.fused_resnet._launch_bwd3(..., route)``), each timed with
``chip_smoke.DeviceTimer`` on three input sets and split by kernel with
``chip_smoke._split_ms``, beside the route the wrapper chooses
(``_conv3x3_route``). Prints the card's name and power limit, then
one JSON line per (shape, route). Where the two routes cross is what
sets ``_GEMM3_MAX_HW`` and ``_GEMM3_MIN_CH``.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import fused_resnet as fr  # noqa: E402


def inputs(gen, n, h, w, c, o):
    dev = torch.device("cuda", 0)

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s
    x = (r(n, h, w, c) + 0.5).to(torch.bfloat16)
    w9 = r(9 * c, o, s=(9 * c) ** -0.5).to(torch.bfloat16)
    scale, shift = r(c).abs() + 0.5, r(c, s=0.3) + 0.1
    y, mean, _ = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
    perch, dvar2 = fr._stats_cotangent_coeffs(r(o), r(o), n * h * w)
    dy = r(n, h, w, o, s=1e-2).to(torch.bfloat16)
    return dy, y, x, scale, shift, w9, perch, dvar2, mean


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    timer = chip_smoke.DeviceTimer(torch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape in chip_smoke._CONV3_SHAPES:
        sets = [inputs(gen, *shape) for _ in range(3)]
        chosen = fr._conv3x3_route(*shape[1:])
        for route in ("window", "gemm"):
            def fn(*args):
                return fr._launch_bwd3(*args, route)
            ms = timer.ms(fn, sets)
            print(json.dumps(dict(
                shape=list(shape), route=route, chosen=route == chosen,
                ms=ms, ms_by_kernel=chip_smoke._split_ms(torch, fn, sets))),
                flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
