#!/usr/bin/env python3
"""Time ``row_gemm`` (the cached forward's products, ``csrc/row_gemm.cu``)
through its public wrapper only, so that the same script times any tree
of the port and two trees can be compared in one call on one card:

    python3 experiments/row_gemm_probe.py [TREE] [--decode-step]

TREE (default: this checkout) is the root whose ``paddle_tpu_torch`` is
imported and built. At gpt2-small's five products (``chip_smoke.py``'s
``_ROW_SHAPES``: qkv, out_proj, fc1, fc2 and the tied head) in bf16, at
M 8 (a decode step of the 8-slot engine) and M 512 (a bucket-512
prefill), it prints one JSON line a product: the kernel's device ms per
call by ``chip_smoke.DeviceTimer`` over enough weight sets (64 MB) that
no call finds its weight in L2, one cuBLAS call's (``F.linear``;
``torch.matmul`` for the head), the bound (``chip_smoke.bound_ms``) and,
at M 8, host microseconds a call of each (``chip_smoke._host_us``). Then
one line with a decode step's 49 products (12 x 4 Linears and the head)
summed at each M. ``--decode-step`` also builds gpt2-small (random
weights, bf16) and the dense 8-slot serving engine of ``chip_smoke.py``
and runs its decode-step profile (``chip_smoke._decode_step_profile``:
wall and device-busy ms a step, and ``row_gemm``'s device ms and share
of the busy time). Prints the card's name and power limit first.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = os.path.abspath(ARGS[0]) if ARGS else REPO
sys.path.insert(0, TREE)

import torch  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from paddle_tpu_torch.kernels import row_linear as rl  # noqa: E402

# this checkout's chip_smoke (its timers, shapes and engine), whatever
# TREE is
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def cublas(x, w, b):
    return torch.matmul(x, w) if b is None else TF.linear(x, w.t(), b)


def products(timer):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 21)
    bf16 = torch.bfloat16
    t = {}
    for m in (8, 512):
        for name, k, n in chip_smoke._ROW_SHAPES:
            sets = []
            for _ in range(max(2, -(-(64 << 20) // (k * n * 2)))):
                w, b = chip_smoke._row_operands(torch, gen, name, k, n, bf16)
                sets.append((torch.randn((m, k), generator=gen,
                                         device=dev).to(bf16), w, b))
            row = dict(ms=timer.ms(rl.row_linear, sets),
                       library_ms=timer.ms(cublas, sets))
            if m == 8:
                row["host_us"] = chip_smoke._host_us(torch, rl.row_linear,
                                                     sets)
                row["library_host_us"] = chip_smoke._host_us(torch, cublas,
                                                             sets)
            n_bytes = 2 * (m * k + k * n + m * n + (0 if name == "lm_head"
                                                    else n))
            row["bound_ms"], row["bound_by"] = chip_smoke.bound_ms(
                n_bytes, 2 * m * n * k)
            t[(m, name)] = row
            chip_smoke.say("row_gemm_probe", tree=TREE, product=name, m=m,
                           k=k, n=n, **row)
            del sets
    step = {}
    for m in (8, 512):
        for key in ("ms", "library_ms", "bound_ms"):
            step[f"{key}_m{m}"] = 12 * sum(
                t[(m, nm)][key] for nm, _, _ in chip_smoke._ROW_SHAPES[:4]) \
                + t[(m, "lm_head")][key]
    host = [t[(8, nm)]["host_us"] for nm, _, _ in chip_smoke._ROW_SHAPES]
    lib_host = [t[(8, nm)]["library_host_us"]
                for nm, _, _ in chip_smoke._ROW_SHAPES]
    chip_smoke.say("row_gemm_probe_step", tree=TREE,
                   products="12 x (qkv, out_proj, fc1, fc2) + lm_head",
                   host_us_m8=[min(host), max(host)],
                   library_host_us_m8=[min(lib_host), max(lib_host)],
                   **step)


def decode_step():
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    dev = torch.device("cuda", 0)
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(
                    chip_smoke.SEED)).eval()
    prompts = chip_smoke._serve_prompts(model)
    engine = ServingEngine(chip_smoke._serve_config(model))
    # one short request first: every kernel is built and loaded before
    # the profile
    engine.serve_forever([(prompts[0], RequestParams(max_new_tokens=4))])
    chip_smoke._decode_step_profile(torch, engine, prompts[8:], 0.0,
                                    "dense (" + TREE + ")")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    products(chip_smoke.DeviceTimer(torch))
    if "--decode-step" in sys.argv:
        decode_step()


if __name__ == "__main__":
    main()
