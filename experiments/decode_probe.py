#!/usr/bin/env python3
"""Time the decode and paged decode kernels (TPU kernel table rows 5 and
7), wide and int8, at batch 8 and batch 1, through their public wrappers
only, so that the same script times any tree of the port and two trees
can be compared in one call on one card:

    python3 experiments/decode_probe.py [TREE] [--define=NAME=VALUE ...]

TREE (default: this checkout) is the root whose ``paddle_tpu_torch`` is
imported and built. The shapes are ``chip_smoke.py``'s: batch 8 is one
decode step of the 8-slot engine, q [8,1,12,64] bf16 against a
[8,640,12,64] cache (ragged kv_len 1..640), the paged kernel on the
same content in a 41-page pool of 128 through a shuffled [8,5] table;
batch 1 is ``generate``'s step, q [1,1,12,64] at kv_len 512 in a
640-row cache (a [1,5] table). int8 caches come from ``quantize_kv``.
Each is timed by ``chip_smoke.DeviceTimer`` over 8 input sets (more
than L2 holds at batch 8), beside SDPA with a length mask on the dense
layout (int8: over the dequantized cache, the dequantization not
timed), the bytes bound (``chip_smoke.decode_bytes``) and the share of
it. ``--define`` builds the tree's ``csrc/flash_decode.cu`` and
``flash_decode_paged.cu`` again with ``-DNAME=VALUE`` (the split body's
constants: ``PADDLE_DECODE_SPLIT``, and ``PADDLE_DECODE_CLUSTER_SPLITS``,
which at 1 folds every capacity through scratch) into
``build/decode_variants/`` and times those
in place of the tree's libraries (``--build-only`` builds them and
stops, so several builds can run side by side). Prints the card's name
and power limit, then one JSON line per timing; each line also says
whether the paged output equals the dense one bit for bit, and gives the
device ms per call of each kernel the call launches, by name (a profile
of 20 calls; kernels that overlap, as the combine kernel's start
overlaps the split kernel's tail, each count their whole span).
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = os.path.abspath(ARGS[0]) if ARGS else REPO
DEFINES = [a.split("=", 1)[1] for a in sys.argv[1:]
           if a.startswith("--define=")]
sys.path.insert(0, TREE)

import importlib.util  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from paddle_tpu_torch.generation.kv_cache import quantize_kv  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

# this checkout's chip_smoke (its timer, bytes count and pool layout),
# whatever TREE is
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

H, D, T, PAGE = 12, 64, 640, 128
BATCHES = {8: [1, 1, 17, 200, 333, 512, 577, 640], 1: [512]}


def load_variants():
    """The tree's two decode libraries built with ``DEFINES``, loaded in
    place of its own; the wrapper's split length follows the build."""
    tag = "_".join(d.replace("=", "") for d in DEFINES)
    out_dir = os.path.join(TREE, "build", "decode_variants", tag)
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(TREE, "paddle_tpu_torch", "csrc")
    procs = {}
    for name in ("flash_decode", "flash_decode_paged"):
        lib = os.path.join(out_dir, name + ".so")
        if os.path.exists(lib) and "--build-only" not in sys.argv:
            procs[name] = None   # built by an earlier --build-only run
            continue
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS,
               *[f"-D{d}" for d in DEFINES], "-o",
               os.path.join(out_dir, name + ".so"),
               os.path.join(csrc, name + ".cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        if proc is None:
            continue
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name} {DEFINES}:\n{log}")
    if "--build-only" in sys.argv:
        sys.exit(0)
    for name in procs:
        lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        sig = fa._DECODE_SIG if name == "flash_decode" else fa._PAGED_SIG
        for fn, (res, args) in sig.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = list(args)
        _build._LIBS[name] = lib
    fa.DECODE_SPLIT_KEYS = _build._LIBS[
        "flash_decode"].paddle_flash_decode_split_keys()
    for d in DEFINES:   # the wrapper's scratch rule follows the build
        if d.startswith("PADDLE_DECODE_CLUSTER_SPLITS="):
            fa.DECODE_CLUSTER_SPLITS = int(d.split("=")[1])


def kernel_ms(call, args, n=20):
    """Device ms per call of each kernel ``call`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    call(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call(*args)
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.split("<")[0].split("(")[0].split()[-1]
            by[name] = by.get(name, 0.0) + e.device_time_total / 1e3 / n
    return by


def main():
    if "--build-only" in sys.argv:
        load_variants()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if DEFINES:
        load_variants()
    timer = chip_smoke.DeviceTimer(torch)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 11)
    cpu_gen = torch.Generator().manual_seed(chip_smoke.SEED + 11)
    bf16 = torch.bfloat16

    def layer_slice(b, int8):
        """k or v [b, T, H, D] (int8: and its scales), the layer-1 slice
        of a two-layer cache."""
        x = torch.randn((2, b, T, H, D), generator=gen, device=dev)
        if not int8:
            return (x[1].to(bf16),)
        vals = torch.empty((2, b, T, H, D), dtype=torch.int8, device=dev)
        scales = torch.empty((2, b, T, H), dtype=bf16, device=dev)
        vals[1], scales[1], _ = quantize_kv(x[1])
        return vals[1], scales[1]

    for int8 in (False, True):
        for b, lens in BATCHES.items():
            kv = torch.tensor(lens, dtype=torch.int32, device=dev)
            dense, paged, lib = [], [], []
            for _ in range(8):
                q = torch.randn((b, 1, H, D), generator=gen,
                                device=dev).to(bf16)
                k, v = layer_slice(b, int8), layer_slice(b, int8)
                perm = torch.randperm(b * -(-T // PAGE),
                                      generator=cpu_gen).to(dev)
                pools = [chip_smoke._pool_of(torch, gen, c, PAGE, perm)
                         for c in (*k, *v)]
                table = pools[0][1]
                if int8:
                    dense.append((q, k[0], v[0], kv, k[1], v[1]))
                    paged.append((q, pools[0][0], pools[2][0], table, kv,
                                  pools[1][0], pools[3][0]))
                    wide = [(c.float() * s.float()[..., None]).to(bf16)
                            for c, s in (k, v)]
                else:
                    dense.append((q, k[0], v[0], kv))
                    paged.append((q, pools[0][0], pools[1][0], table, kv))
                    wide = [k[0], v[0]]
                lib.append((q.transpose(1, 2), wide[0].transpose(1, 2),
                            wide[1].transpose(1, 2)))
            mask = (torch.arange(T, device=dev)[None, :]
                    < kv[:, None].long())[:, None, None, :]

            def dense_call(q, k, v, kv, ks=None, vs=None):
                if ks is None:
                    return fa.flash_attention_decode(q, k, v, kv)
                return fa.flash_attention_decode(q, k, v, kv, k_scale=ks,
                                                 v_scale=vs)

            def paged_call(q, kp, vp, table, kv, ks=None, vs=None):
                if ks is None:
                    return fa.flash_attention_decode_paged(q, kp, vp, table,
                                                           kv)
                return fa.flash_attention_decode_paged(
                    q, kp, vp, table, kv, k_scale=ks, v_scale=vs)

            bits = torch.equal(dense_call(*dense[0]), paged_call(*paged[0]))
            lib_ms = timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), lib)
            for name, call, sets, page in (
                    ("flash_decode", dense_call, dense, None),
                    ("flash_decode_paged", paged_call, paged, PAGE)):
                t = chip_smoke.decode_timing(timer, call, sets, lens, H, D,
                                             int8, page=page)
                print(json.dumps(dict(
                    kernel=name + ("_int8" if int8 else ""), batch=b,
                    tree=os.path.basename(TREE), defines=DEFINES,
                    ms=t["ms"], sdpa_dense_ms=lib_ms,
                    bound_ms=t["bound_ms"],
                    share_of_bound=t["share_of_bound"],
                    paged_bits_equal_dense=bits,
                    kernels=kernel_ms(call, sets[0]))), flush=True)
            del dense, paged, lib
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
