#!/usr/bin/env python3
"""Time the chunk-prefill kernel (TPU kernel table row 6) and the fused
3x3 backward (row 18) through their public wrappers only, so that the
same script runs in any tree of the port and two trees can be compared
in one call on one card:

    cd <tree> && python3 experiments/chunk_conv3x3_probe.py

Row 6: ``flash_attention_chunk`` on a 128-query bf16 chunk of 12 heads
(head_dim 64) against a [1, 640, 12, 64] layer slice of a side cache at
kv_len 128, 256 and 512, wide and int8 (bf16 scales). Row 18:
``conv3x3_bn_stats_bwd`` at ResNet-50's four stride-1 3x3 shapes at
b128. Each time is ``chip_smoke.DeviceTimer``'s over several input sets.
Prints the card's name and power limit, then one JSON line per shape.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import fused_resnet as fr  # noqa: E402

CONV3_SHAPES = ((128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
                (128, 14, 14, 256, 256), (128, 7, 7, 512, 512))


def chunk_sets(gen, kv_len, int8, n=8):
    dev = torch.device("cuda", 0)
    sets = []
    for _ in range(n):
        q = torch.randn((1, 128, 12, 64), generator=gen, device=dev)
        kv = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        if int8:
            k, v = (torch.randint(-127, 128, (2, 1, 640, 12, 64),
                                  generator=gen, device=dev,
                                  dtype=torch.int8)[1] for _ in range(2))
            ks, vs = ((torch.rand((2, 1, 640, 12), generator=gen, device=dev)
                       * 0.015 + 0.005).bfloat16()[1] for _ in range(2))
            sets.append((q.bfloat16(), k, v, kv, ks, vs))
        else:
            k, v = (torch.randn((2, 1, 640, 12, 64), generator=gen,
                                device=dev).bfloat16()[1] for _ in range(2))
            sets.append((q.bfloat16(), k, v, kv, None, None))
    return sets


def chunk(q, k, v, kv, ks, vs):
    if ks is None:
        return fa.flash_attention_chunk(q, k, v, kv)
    return fa.flash_attention_chunk(q, k, v, kv, k_scale=ks, v_scale=vs)


def conv_inputs(gen, n, h, w, c, o):
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
    gen = torch.Generator(device="cuda").manual_seed(5)
    for int8 in (False, True):
        for kv_len in (128, 256, 512):
            ms = timer.ms(chunk, chunk_sets(gen, kv_len, int8))
            print(json.dumps(dict(kernel="flash_chunk" + ("_int8" if int8
                                                          else ""),
                                  kv_len=kv_len, ms=ms)), flush=True)
    for shape in CONV3_SHAPES:
        sets = [conv_inputs(gen, *shape) for _ in range(3)]
        ms = timer.ms(fr.conv3x3_bn_stats_bwd, sets)
        print(json.dumps(dict(kernel="conv3x3_bn_stats_bwd",
                              shape=list(shape), ms=ms)), flush=True)
        del sets
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
