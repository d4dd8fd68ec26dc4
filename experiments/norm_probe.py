#!/usr/bin/env python3
"""Time the fused LayerNorm/RMSNorm forward and dx kernels (TPU kernel
table rows 8-9) through their public wrappers only, so that the same
script times any tree of the port and two trees can be compared in one
call on one card:

    python3 experiments/norm_probe.py [TREE] [--variants] [--lib=SO]

TREE (default: this checkout) is the root whose ``paddle_tpu_torch`` is
imported and built. The timings are ``chip_smoke.py``'s
``norm_adamw_kernels``: bf16 x [16384, 768] and [4096, 4096], bf16 w and
b, LayerNorm and RMSNorm, forward and dx, each by
``chip_smoke.DeviceTimer`` over three input sets (more than L2 holds),
beside ``F.layer_norm`` / ``F.rms_norm`` (dx: their autograd backward),
the bytes bound, the achieved TB/s and the share of the bound.
``--variants`` also builds ``experiments/norm_variants.cu`` (the same
kernels with the next rows brought in by a second set of registers,
"regs", or for rows of a block by ``cp.async.bulk`` into a two-stage
ring, "bulk"; the tree's kernels use a per-thread ``cp.async`` ring)
and times each beside the tree's kernels, after checking that it gives
their bits. ``--lib=SO`` times another build of ``csrc/fused_norm.cu``
(the same C entry points, say with other constants) in place of the
tree's. Prints the card's name and power limit, then one JSON line per
timing.
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
sys.path.insert(0, TREE)

import importlib.util  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as TF  # noqa: E402

from paddle_tpu_torch.kernels import fused_norm as fn  # noqa: E402

# this checkout's chip_smoke (its timer and bytes count), whatever TREE is
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SHAPES = ((16384, 768), (4096, 4096))
EPS = {False: 1e-5, True: 1e-6}


def variants_library():
    """``experiments/norm_variants.cu`` built into ``build/`` of the
    checkout, with its ctypes signatures."""
    from paddle_tpu_torch.kernels import _build
    out = os.path.join(REPO, "build", "norm_variants.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I",
           os.path.join(REPO, "paddle_tpu_torch", "csrc"), "-o", out,
           os.path.join(HERE, "norm_variants.cu")]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        sys.exit(f"nvcc failed:\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(out)
    for name, (res, args) in fn._SIG.items():
        f = getattr(lib, name.replace("paddle_norm", "paddle_norm_variant"))
        f.restype, f.argtypes = res, [ctypes.c_int, *args]
    return lib


def variant_call(lib, variant, dx):
    """A function with ``norm_fwd``'s or ``norm_dx``'s arguments that
    launches a variant (0 regs, 1 bulk) on contiguous bf16 inputs."""
    def call(x, w, t, eps, rms):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        rows, d = x.shape
        if dx:
            err = lib.paddle_norm_variant_dx(
                variant, x.data_ptr(), w.data_ptr(), t.data_ptr(),
                out.data_ptr(), rows, d, d, d, eps, int(rms), 1, 1, stream)
        else:
            err = lib.paddle_norm_variant_fwd(
                variant, x.data_ptr(), w.data_ptr(), t.data_ptr(),
                out.data_ptr(), rows, d, d, eps, int(rms), 1, 1, 1, stream)
        if err:
            raise RuntimeError(f"variant {variant}: CUDA error {err}")
        return out
    return call


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    timer = chip_smoke.DeviceTimer(torch)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 7)
    variants = variants_library() if "--variants" in sys.argv else None
    other = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--lib=")]
    if other:
        lib = ctypes.CDLL(os.path.abspath(other[0]))
        for name, (res, args) in fn._SIG.items():
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = list(args)
        fn._library = lambda: lib
    bf16 = torch.bfloat16

    def r(*shape, s=1.0, o=0.0):
        return torch.randn(shape, generator=gen, device=dev) * s + o

    for rows, d in SHAPES:
        sets = [dict(x=r(rows, d, s=2.0, o=0.5).to(bf16),
                     dy=r(rows, d).to(bf16), w=r(d, s=0.1, o=1.0).to(bf16),
                     b=r(d, s=0.1).to(bf16),
                     zero=torch.zeros(d, dtype=bf16, device=dev))
                for _ in range(3)]
        for rms in (False, True):
            eps = EPS[rms]
            fwd_args = [(t["x"], t["w"], t["zero" if rms else "b"], eps, rms)
                        for t in sets]
            dx_args = [(t["x"], t["w"], t["dy"], eps, rms) for t in sets]
            graphs = []
            for t in sets:
                xg = t["x"].detach().clone().requires_grad_()
                yg = TF.rms_norm(xg, (d,), t["w"], eps) if rms else \
                    TF.layer_norm(xg, (d,), t["w"], t["b"], eps)
                graphs.append((yg, xg, t["dy"]))
            for dx in (False, True):
                kernel = fn.norm_dx if dx else fn.norm_fwd
                args = dx_args if dx else fwd_args
                if dx:
                    lib_ms = timer.ms(lambda y, x, g: torch.autograd.grad(
                        y, x, g, retain_graph=True), graphs)
                else:
                    lib_ms = timer.ms(
                        lambda x, w, b, eps, rms: TF.rms_norm(
                            x, (d,), w, eps) if rms else
                        TF.layer_norm(x, (d,), w, b, eps), args)
                ms = timer.ms(kernel, args)
                n_bytes = chip_smoke._norm_bytes(rows, d, dx)
                bound = n_bytes / chip_smoke.PEAK_BYTES * 1e3
                line = dict(kernel="norm_dx" if dx else "norm_fwd",
                            norm="rms" if rms else "layer", shape=[rows, d],
                            tree=os.path.basename(TREE),
                            lib=other[0] if other else None, ms=ms,
                            library_ms=lib_ms, bound_ms=bound,
                            tb_per_s=n_bytes / ms / 1e9,
                            share_of_bound=bound / ms)
                for variant, tag in ((0, "regs"), (1, "bulk")):
                    if variants is None or (variant == 1 and d <= 1024):
                        continue
                    call = variant_call(variants, variant, dx)
                    same = torch.equal(call(*args[0]), kernel(*args[0]))
                    line.update({f"{tag}_ms": timer.ms(call, args),
                                 f"{tag}_bits_equal": same})
                print(json.dumps(line), flush=True)
        del sets, graphs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
