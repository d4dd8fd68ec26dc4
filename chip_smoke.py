#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an sm_90 card (H100)
and the CUDA toolkit. It builds the hand-written kernels from
``paddle_tpu_torch/csrc``, holds each against its plain PyTorch version
at the shapes the serving and training paths give it (``row_gemm``, the
cached forward's products, also bit for bit row-invariant at 1 to 4096
rows; the paged decode
kernel also bit for bit against the dense one, in the wide and the
int8 mode; the flash forward and backward, on the tensor-core route in
bf16, also to repeating bit for bit and to giving each batch row the
bits of a batch-1 run), runs gpt2-small (random weights from a seed,
bf16) through the kernel path and the plain path, serves 16 requests through
``ServingEngine`` on its dense cache (the first 8 streams equal to
batch-1 ``generate``), the same 16 and 8 shared-prefix requests on a
paged cache (token streams equal to the dense engine's), the 16 again
with chunked prefill, all three again on an int8 KV cache, the same
traffic on speculative slots (ngram, k 4: dense, paged, int8, chunked;
the decode kernels at a verify window of 5 query rows) and speculative
``generate`` in both modes, each speculative stream equal bit for bit
to its batch-1 speculative one and to its non-speculative one (every
product of the cached forward on the row-invariant ``row_gemm``, 49
launches a forward), the same traffic with telemetry
on and off, two replicas (dense and paged) behind the fleet router on
pump threads through a rolling deploy that re-homes queued work (each
stream equal to the dense serve run's), a preemption drain through
``serve_forever``, the Predictor in generation mode on the same 16
prompts (no kernel built after ``create_predictor``, streams equal to
the serve run's bit for bit, ``run()`` bitwise to the
served module and timed by ``device_time_per_run``), int8 and int4
weight-only engines and an int4 paged engine on the int8 cache (the
first 8 streams equal batch-1 ``generate`` on the quantized module,
every weight within its step, the decode step beside bf16's, the int8
compute layer's accumulators equal to the CPU's), holds the
int8 cache's logits to the wide cache's, trains gpt2-small with
``bench.py``'s recipe (AdamW with fp32 masters, the fused LM-head loss,
``TrainStep``) at batch 16 x 1024 tokens, then trains ResNet-50 with
``bench.py``'s fused conv+BN recipe (NHWC, bf16, Momentum, ``TrainStep``)
at batch 128 x 224 x 224 through the 1x1 and the 3x3 conv + BN-stats
kernels (and times the same recipe with its 3x3s on cuDNN), holds the
fused LayerNorm/RMSNorm and AdamW kernels against their plain versions
and runs them on the trained gpt2-small's 25 LayerNorm inputs and
gradients and on copies of its optimizer state, holds the fused
linear + cross-entropy kernels against their plain versions and runs
them on the trained gpt2-small's LM head (hidden states and tied
embedding) beside the model's own fused loss, trains gpt2-small again
under activation recompute (per block, selective and full, and the
whole loss as one region; losses held to the plain run's, the flash
forward twice a block; with dropout, gradients bitwise equal to no
recompute), with the optimizer state offloaded to pinned host memory
(bitwise to resident), under AMP O1 (bf16 from fp32 weights) and O2
(fp16 with ``GradScaler``), each first held to the plain path, and
under quantization-aware training, trains ResNet-50 with its first two
stages recomputed (losses held to the run without, BN running
statistics frozen), holds rows 1-4 non-causal at ERNIE's and BERT's
training shapes, trains ernie-3.0-base (b32) and bert-large (b16) at
sequence 512 with ``bench.py``'s MLM + SOP recipe (each first held at
b4 to the plain kernels), encodes incrementally with ernie-3.0-base (a
4-token append against four 1-token appends) and runs its sequence
classifier against the plain kernels, trains ``nn.Transformer()`` at
its defaults (the Transformer-base) on ``Tensor`` inputs through rows
1-4 and ``sdpa_xla`` (first held at b4 to the same weights in fp32 on
the CPU), and checks
that each path went through its kernels and never through a plain
version. Phases
print one line each; the line before the last is the kernel table as
JSON, and the last line is ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero with no result line. Imports neither JAX
nor the JAX package.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
#: H100 SXM published peaks (dense bf16 tensor rate, HBM3 bandwidth)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 output of both versions is rounded from fp32 sums taken in other
# orders, so they may land one output ulp apart: 1e-2 absolute plus
# 1e-2 relative covers one bf16 ulp for |x| < 4
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# the training shapes in bf16, per tensor (out, dq, dk, dv): one bf16
# ulp of the element (at most 2^-7 of its magnitude) for the two final
# roundings, plus 1e-3 of the tensor's largest magnitude for the fp32
# sums taken in other orders; no fixed absolute term, which would let
# the many small gradient elements drift unseen
ULP_BF16 = 2.0 ** -7
SCALED_FRAC = 1e-3
# fp32 inputs: both versions do the same fp32 arithmetic in other
# orders, with exp2's last bits (as tests/test_torch_port_cuda.py holds
# at small shapes)
F32_ATOL = F32_RTOL = 1e-4
# the forward's natural-log LSE is fp32 in both versions, whatever the
# input dtype
LSE_ATOL = LSE_RTOL = 1e-4
# gpt2-small in bf16, kernel path against plain path: attention outputs
# may differ by one bf16 ulp (2^-8 relative) in a fraction of elements;
# the residual stream re-rounds to bf16 in each of 12 layers and the
# logits have a spread of about 1, so a few hundredths of drift are
# expected and 0.1 flags a real divergence
LOGIT_TOL = 0.1
# gpt2-small bf16 training, kernel path against plain path: both are
# exact to bf16 rounding (2^-8 relative) at every op, and differ where
# the attention kernels' bf16 outputs and gradients land one ulp from
# the plain versions'; through 12 layers forward and back that drifts
# by a few roundings, so the loss (about 10.8) may move by ~1e-3, a
# gradient by ~1e-2 of its norm. A fault (a dropped or mis-scaled
# gradient, an LSE in the wrong base) moves them by order 1. The loss
# gap measured 3.7e-5 on an H100.
TRAIN_LOSS_TOL = 1e-3        # absolute
GRAD_NORM_TOL = 3e-2         # |g_kernel - g_plain| / |g_plain|
GRAD_MAX_TOL = 0.1           # max|g_kernel - g_plain| / max|g_plain|
#: H100 SXM published fp32 rate outside the tensor cores, for the
#: elementwise part of a fused kernel's work
PEAK_FLOPS_F32 = 67e12
# the fused ResNet kernels (rows 13-16) in bf16 against their plain
# versions: y and dx by the training rule above (both round the same
# fp32 values, summed in another order); per channel the mean within
# 1e-3*sqrt(var) + 1e-6 and the var within 1e-3*var + 1e-6 of the
# plain's (the kernel's Chan combine of 128-row tiles against a
# two-pass sum); the fp32 sums dw, dscale and dshift, over up to
# 401,408 rows in another order, within 1e-3 of the tensor's largest
# magnitude
STATS_FRAC = 1e-3
SUM_FRAC = 1e-3
# ResNet-50 training at b128, kernel path against plain path from the
# same weights: the loss (about 7.6) within 1e-2. Every gradient within
# 5e-2 of its norm in fp32; in bf16 within max(5e-2, 4*chaos), chaos
# being the plain path against itself under +-1-ulp input noise (the
# JAX package's own rule, tests/test_fused_resnet.py). At this random
# initialization the gradients are ill-conditioned: on an H100 the
# plain path moved by 2.1% of a gradient's norm (median) under fp32
# input noise and by 1.32 under bf16 noise, so no implementation meets
# a fixed bound in bf16.
RESNET_LOSS_TOL = 1e-2       # absolute
RESNET_GRAD_TOL = 5e-2       # |g_kernel - g_plain| / |g_plain|


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ------------------------------------------------------------- timing

class DeviceTimer:
    """Device time per call of a function on the card, host issue cost
    excluded: a spin kernel holds the stream while the host enqueues
    the start event, ``n`` calls and the end event, so the events time
    only the calls running back to back. Each call gets the next of
    several input sets in turn, so its inputs are not left in L2 by the
    call before."""

    def __init__(self, torch):
        self.torch = torch
        cuda = torch.cuda
        cuda._sleep(1000)
        cuda.synchronize()
        s, e = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        s.record()
        cuda._sleep(1 << 22)
        e.record()
        e.synchronize()
        self.cycles_per_ms = (1 << 22) / s.elapsed_time(e)

    def ms(self, fn, input_sets, n=30):
        """Device ms per call of ``fn`` (which must launch fewer than a
        few tens of kernels, or the launch queue fills and the host
        catches up with the spin kernel)."""
        cuda = self.torch.cuda
        for args in input_sets[:2]:
            fn(*args)
        cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(*input_sets[i % len(input_sets)])
        issue_ms = (time.perf_counter() - t0) * 1e3
        cuda.synchronize()
        s, e = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        cuda._sleep(int(self.cycles_per_ms * (2 * issue_ms + 2)))
        s.record()
        for i in range(n):
            fn(*input_sets[i % len(input_sets)])
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n


def span_ms(torch, fn, n=5):
    """Device and host-clock ms per call of ``fn`` over ``n`` calls in a
    row after one warm call: for a step of many launches, which
    ``DeviceTimer`` cannot hold behind its spin kernel."""
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n, (time.perf_counter() - t0) * 1e3 / n


def bound_ms(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def decode_bytes(kv_lens, h, d, int8, page=None, sq=1):
    """Bytes a decode call must move (TPU kernel table rows 5 and 7):
    each row's valid K/V prefix (int8: and its bf16 scales), ``sq`` bf16
    q and o rows per head, kv_len, and with ``page`` the table entries of
    the pages read."""
    n_kv, b = sum(kv_lens), len(kv_lens)
    kv_bytes = 2 * n_kv * h * d + 2 * n_kv * h * 2 if int8 \
        else 2 * n_kv * h * d * 2
    pages = 0 if page is None else sum(-(-k // page) for k in kv_lens)
    return kv_bytes + 2 * b * sq * h * d * 2 + b * 4 + pages * 4


def decode_timing(timer, call, sets, kv_lens, h, d, int8, page=None,
                  lib_call=None, lib_sets=None):
    """A decode kernel's device ms on ``sets``, one PyTorch call's on
    ``lib_sets`` (None without one), the bytes bound and the kernel's
    share of it."""
    ms = timer.ms(call, sets)
    bms, by = bound_ms(decode_bytes(kv_lens, h, d, int8, page),
                       4 * sum(kv_lens) * h * d)
    return dict(ms=ms, library_ms=None if lib_call is None else
                timer.ms(lib_call, lib_sets), bound_ms=bms, bound_by=by,
                share_of_bound=bms / ms)


# batch 1 (``generate``'s decode step): one row at kv_len 512 in a
# 640-row cache
B1_KV_LEN, B1_T = 512, 640


# ------------------------------------------------------------- phases

def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("device", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)))
    return card


def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all(force=True)
    spills = []
    for r in report.values():
        fn = None
        for line in r["log"].splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            elif "spill" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill"):
                spills.append(f"{fn}: {line.strip()}")
    say("build", seconds=round(time.perf_counter() - t0, 2),
        libraries=sorted(report), kernels_with_spills=spills)


def _err(out, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    """max |out - ref| and the count of elements beyond atol + rtol *
    |ref| (a NaN counts as beyond)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    bad = ~(diff <= atol + rtol * ref.abs())
    return float(diff.max()), int(bad.sum())


def _err_scaled(out, ref):
    """max |out - ref| and the count of elements beyond ULP_BF16 * |ref|
    + SCALED_FRAC * max |ref| of the tensor (a NaN counts as beyond)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    bad = ~(diff <= ULP_BF16 * ref.abs() + SCALED_FRAC * ref.abs().max())
    return float(diff.max()), int(bad.sum())


def _bitwise(torch, fa, shape, q, k, v, do=None, row=1):
    """flash_fwd (and flash_bwd, given ``do``) repeat bit for bit over two
    calls, and row ``row`` of the batch equals, bit for bit, the same row
    run at batch 1 (no atomics, no sum across blocks); one line, and a
    failure unless both hold."""
    def run(q, k, v, do):
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        grads = () if do is None else fa.flash_attention_bwd(
            q, k, v, out, lse, do, True)
        return (out, lse, *grads)

    first = run(q, k, v, do)
    repeat = all(torch.equal(a, b) for a, b in zip(first, run(q, k, v, do)))
    one = run(*(None if t is None else t[row:row + 1] for t in (q, k, v, do)))
    batch = all(torch.equal(a, b[row:row + 1]) for a, b in zip(one, first))
    kernels = ["flash_fwd"] + ([] if do is None else ["flash_bwd"])
    say("kernel_bitwise", kernels=kernels, shape=shape,
        route=fa.route(q.dtype, q.shape[-1]), repeats_bitwise=repeat,
        row=row, row_equals_batch_1=batch)
    if not (repeat and batch):
        fail(f"{kernels} at {shape}: repeat {repeat}, batch invariance "
             f"{batch}")


def phase_kernels(torch, timer):
    """Each kernel against its plain version at the serving path's
    shapes, in bf16, with times; flash_fwd also repeated and against
    batch 1 at the prefill shape."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    rows = {}
    # -- flash forward: the bucket-512 prefill of one request, causal,
    # plus a ragged length off every tile grid
    b, h, d = 1, 12, 64
    worst = 0.0
    for s in (512, 300):
        q, k, v = randn(b, s, h, d), randn(b, s, h, d), randn(b, s, h, d)
        out = fa.flash_attention(q, k, v, causal=True)
        ref = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, n_bad = _err(out, ref)
        say("kernel_check", kernel="flash_fwd", shape=[b, s, h, d],
            causal=True, route=fa.route(bf16, d), max_abs_err=err,
            tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad)
        if n_bad:
            fail(f"flash_fwd disagrees with its plain version at S={s}")
        worst = max(worst, err)
    s = 512
    sets = [(randn(b, s, h, d), randn(b, s, h, d), randn(b, s, h, d))
            for _ in range(16)]
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in st)
                for st in sets]
    ms = timer.ms(lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
                  sets)
    plain_ms = timer.ms(
        lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=True), sets)
    lib_ms = timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
        q, k, v, is_causal=True), lib_sets)
    pairs = s * (s + 1) // 2                       # causal (row, col) pairs
    n_bytes = 4 * b * s * h * d * 2                # q, k, v read; o written
    bms, by = bound_ms(n_bytes, 4 * b * h * pairs * d)
    rows["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:205",
        shape="q,k,v [1,512,12,64] bf16 causal",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, flash_route=fa.route(bf16, d))
    # the prefill shape's rows, repeated and against batch 1
    _bitwise(torch, fa, [4, s, h, d], randn(4, s, h, d), randn(4, s, h, d),
             randn(4, s, h, d), row=2)

    # -- flash decode: one decode step of the 8-slot engine (cache 640),
    # ragged lengths, some lanes at 1
    B, T = 8, 640
    kv = torch.tensor([1, 1, 17, 200, 333, 512, 577, 640],
                      dtype=torch.int32, device=dev)
    dsets = []
    for _ in range(8):   # 8 x 15.7 MB of cache: more than L2 holds
        ck, cv = randn(2, B, T, h, d), randn(2, B, T, h, d)
        dsets.append((randn(B, 1, h, d), ck[1], cv[1], kv))
    q, kc, vc, _ = dsets[0]
    out = fa.flash_attention_decode(q, kc, vc, kv)
    ref = fa.flash_attention_decode_plain(q, kc, vc, kv)
    torch.cuda.synchronize()
    err, n_bad = _err(out, ref)
    say("kernel_check", kernel="flash_decode", shape=[B, T, h, d], sq=1,
        kv_len=kv.tolist(), max_abs_err=err,
        tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad)
    if n_bad:
        fail("flash_decode disagrees with its plain version")
    plain_ms = timer.ms(fa.flash_attention_decode_plain, dsets)

    def sdpa(lens, t):
        cols = torch.arange(t, device=dev)
        mask = (cols[None, :] < torch.tensor(lens, device=dev)[:, None])
        return lambda q, k, v: TF.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None, None, :])

    def lib_sets(sets):
        return [tuple(t.transpose(1, 2) for t in st[:3]) for st in sets]

    lens = kv.tolist()
    t8 = decode_timing(timer, fa.flash_attention_decode, dsets, lens, h, d,
                       False, lib_call=sdpa(lens, T),
                       lib_sets=lib_sets(dsets))
    # batch 1: generate's decode step
    kv1 = torch.tensor([B1_KV_LEN], dtype=torch.int32, device=dev)
    b1_sets = []
    for _ in range(8):
        ck, cv = randn(2, 1, B1_T, h, d), randn(2, 1, B1_T, h, d)
        b1_sets.append((randn(1, 1, h, d), ck[1], cv[1], kv1))
    err1, n_bad = _err(fa.flash_attention_decode(*b1_sets[0]),
                       fa.flash_attention_decode_plain(*b1_sets[0]))
    say("kernel_check", kernel="flash_decode", shape=[1, B1_T, h, d], sq=1,
        kv_len=[B1_KV_LEN], max_abs_err=err1,
        tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad)
    if n_bad:
        fail("flash_decode disagrees with its plain version at batch 1")
    t1 = decode_timing(timer, fa.flash_attention_decode, b1_sets,
                       [B1_KV_LEN], h, d, False,
                       lib_call=sdpa([B1_KV_LEN], B1_T),
                       lib_sets=lib_sets(b1_sets))
    rows["flash_decode"] = dict(
        name="flash_decode", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:942",
        shape="q [8,1,12,64], cache [8,640,12,64] bf16, ragged kv_len",
        max_abs_err=max(err, err1), ms=t8["ms"], plain_ms=plain_ms,
        bound_ms=t8["bound_ms"], bound_by=t8["bound_by"],
        library_ms=t8["library_ms"], share_of_bound=t8["share_of_bound"],
        batch_1=dict(shape="q [1,1,12,64], cache [1,640,12,64], kv_len 512",
                     **t1))
    for r in rows.values():
        say("kernel_time", kernel=r["name"], kernel_ms=r["ms"],
            plain_ms=r["plain_ms"], library_ms=r["library_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            **({"route": r["flash_route"]} if "flash_route" in r else {}),
            **({"share_of_bound": r["share_of_bound"],
                "batch_1": r["batch_1"]} if "batch_1" in r else {}))
    return rows, (dsets, b1_sets)


def _pool_of(torch, gen, cache, page, perm):
    """The logical rows of one dense cache [B, T, ...] (values [B, T, H,
    D] or scales [B, T, H]) laid out in a pool of shuffled pages, as the
    layer-1 slice of a [2, n_pages, page, ...] pool (page 0 is the null
    page; unused rows hold noise), and the [B, ceil(T / page)] int32
    page table that names them."""
    b, t = cache.shape[:2]
    rest = tuple(cache.shape[2:])
    n_slots = -(-t // page)
    pool = torch.randn((2, 1 + b * n_slots, page) + rest, generator=gen,
                       device=cache.device).to(cache.dtype)
    table = (perm[:b * n_slots] + 1).reshape(b, n_slots).to(torch.int32)
    rows = (table.long()[:, :, None] * page + torch.arange(
        page, device=cache.device)).reshape(b, -1)[:, :t]
    pool[1].view((-1,) + rest)[rows] = cache
    return pool[1], table


def phase_paged_chunk_kernels(torch, timer, decode_sets, dense_row):
    """The paged decode kernel on the dense decode check's content laid
    out in a 41-page pool of 128 (and 48) with a shuffled table: within
    the kernel tolerance of its plain version and BITWISE equal to
    flash_decode on the same logical rows; timed there and on the batch-1
    content. The chunk kernel at the chunked prefill's shapes, in bf16
    and fp32. Both timed."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = {}
    h, d = 12, 64
    dsets, b1_sets = decode_sets
    q, kc, vc, kv = dsets[0]
    B, T = kc.shape[:2]
    cpu_gen = torch.Generator().manual_seed(SEED + 3)
    for page in (128, 48):
        perm = torch.randperm(B * -(-T // page), generator=cpu_gen).to(dev)
        kp, table = _pool_of(torch, gen, kc, page, perm)
        vp, _ = _pool_of(torch, gen, vc, page, perm)
        out = fa.flash_attention_decode_paged(q, kp, vp, table, kv)
        ref = fa.flash_attention_decode_paged_plain(q, kp, vp, table, kv)
        dense = fa.flash_attention_decode(q, kc, vc, kv)
        torch.cuda.synchronize()
        err, n_bad = _err(out, ref)
        bitwise = bool(torch.equal(out, dense))
        say("kernel_check", kernel="flash_decode_paged", page=page,
            pool=list(kp.shape), table=list(table.shape),
            kv_len=kv.tolist(), max_abs_err=err,
            tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad,
            bitwise_equal_to_flash_decode=bitwise)
        if n_bad:
            fail(f"flash_decode_paged disagrees with its plain version at "
                 f"page {page}")
        if not bitwise:
            fail(f"flash_decode_paged differs from flash_decode at page "
                 f"{page}")
        if page == 128:
            paged_err = err
    def pooled(sets):
        out = []
        for st in sets:
            b = st[1].shape[0]
            perm = torch.randperm(b * -(-T // 128),
                                  generator=cpu_gen).to(dev)
            kp, table = _pool_of(torch, gen, st[1], 128, perm)
            vp, _ = _pool_of(torch, gen, st[2], 128, perm)
            out.append((st[0], kp, vp, table, st[3]))
        return out

    psets = pooled(dsets)
    t8 = decode_timing(timer, fa.flash_attention_decode_paged, psets,
                       kv.tolist(), h, d, False, page=128)
    plain_ms = timer.ms(fa.flash_attention_decode_paged_plain, psets)
    p1 = pooled(b1_sets)
    if not torch.equal(fa.flash_attention_decode_paged(*p1[0]),
                       fa.flash_attention_decode(*b1_sets[0])):
        fail("flash_decode_paged differs from flash_decode at batch 1")
    t1 = decode_timing(timer, fa.flash_attention_decode_paged, p1,
                       [B1_KV_LEN], h, d, False, page=128)
    rows["flash_decode_paged"] = dict(
        name="flash_decode_paged", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode_paged.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:1323",
        shape="q [8,1,12,64] bf16, 41-page pool [41,128,12,64] through a "
              "shuffled [8,5] table, ragged kv_len",
        max_abs_err=paged_err, ms=t8["ms"], plain_ms=plain_ms,
        bound_ms=t8["bound_ms"], bound_by=t8["bound_by"], library_ms=None,
        library_note="none: no PyTorch call takes a page table",
        share_of_bound=t8["share_of_bound"],
        yardstick_sdpa_dense_ms=dense_row["library_ms"],
        flash_decode_ms=dense_row["ms"],
        batch_1=dict(shape="q [1,1,12,64], pool [6,128,12,64] through a "
                           "[1,5] table, kv_len 512",
                     yardstick_sdpa_dense_ms=dense_row["batch_1"][
                         "library_ms"], **t1))

    # -- chunk: a 128-token chunk of a long prompt against the batch-1
    # side cache, at the 2nd and 4th chunks of a 500-token prompt; one
    # GQA window
    def chunk_inputs(sq, hq, hk, kv_len, dtype):
        q = torch.randn((1, sq, hq, d), generator=gen, device=dev)
        kc = torch.randn((2, 1, 640, hk, d), generator=gen, device=dev)
        vc = torch.randn((2, 1, 640, hk, d), generator=gen, device=dev)
        return (q.to(dtype), kc[1].to(dtype), vc[1].to(dtype),
                torch.tensor([kv_len], dtype=torch.int32, device=dev))

    worst = 0.0
    for dtype, sq, hq, hk, kv_len in (
            (torch.bfloat16, 128, 12, 12, 256),
            (torch.bfloat16, 128, 12, 12, 512),
            (torch.bfloat16, 200, 12, 4, 450),
            (torch.float32, 128, 12, 12, 512),
            (torch.float32, 200, 12, 4, 450)):
        args = chunk_inputs(sq, hq, hk, kv_len, dtype)
        out = fa.flash_attention_chunk(*args)
        ref = fa.flash_attention_chunk_plain(*args)
        torch.cuda.synchronize()
        if dtype is torch.float32:
            err, n_bad = _err(out, ref, F32_ATOL, F32_RTOL)
            tol = f"{F32_ATOL}+{F32_RTOL}*|plain|"
        else:
            err, n_bad = _err(out, ref)
            tol = f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|"
            worst = max(worst, err)
        say("kernel_check", kernel="flash_chunk",
            dtype=str(dtype).split(".")[-1], q=[1, sq, hq, d],
            cache=[1, 640, hk, d], kv_len=kv_len, max_abs_err=err, tol=tol,
            out_of_tol=n_bad)
        if n_bad:
            fail(f"flash_chunk disagrees with its plain version at sq={sq} "
                 f"kv_len={kv_len} {dtype}")
    route = fa.chunk_route(torch.bfloat16, d)
    rep = chunk_inputs(128, 12, 12, 512, torch.bfloat16)
    repeats = bool(torch.equal(fa.flash_attention_chunk(*rep),
                               fa.flash_attention_chunk(*rep)))
    say("kernel_bitwise", kernels=["flash_chunk"], route=route,
        repeats_bitwise=repeats)
    if route != "mma" or not repeats:
        fail(f"flash_chunk in bf16: route {route}, repeats {repeats}")
    times = {}
    for kv_len in (128, 256, 512):
        csets = [chunk_inputs(128, 12, 12, kv_len, torch.bfloat16)
                 for _ in range(8)]
        cols = torch.arange(640, device=dev)
        rws = torch.arange(128, device=dev)
        mask = cols[None, :] <= kv_len - 128 + rws[:, None]     # [128, 640]
        lib_sets = [tuple(t.transpose(1, 2) for t in st[:3])
                    for st in csets]
        pairs = sum(kv_len - 128 + i + 1 for i in range(128))
        n_bytes = (2 * 128 * h * d + 2 * kv_len * h * d) * 2 + 4
        times[kv_len] = dict(
            ms=timer.ms(fa.flash_attention_chunk, csets),
            plain_ms=timer.ms(fa.flash_attention_chunk_plain, csets),
            library_ms=timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), lib_sets),
            bound=bound_ms(n_bytes, 4 * pairs * h * d))
        say("kernel_time", kernel="flash_chunk", kv_len=kv_len,
            kernel_ms=times[kv_len]["ms"],
            plain_ms=times[kv_len]["plain_ms"],
            library_ms=times[kv_len]["library_ms"],
            bound_ms=times[kv_len]["bound"][0],
            bound_by=times[kv_len]["bound"][1])
    t4 = times[512]
    rows["flash_chunk"] = dict(
        name="flash_chunk", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:1163",
        shape="q [1,128,12,64] bf16 against a [1,640,12,64] side cache at "
              "kv_len 512 (the 4th chunk of a 500-token prompt)",
        max_abs_err=worst, ms=t4["ms"], plain_ms=t4["plain_ms"],
        bound_ms=t4["bound"][0], bound_by=t4["bound"][1],
        library_ms=t4["library_ms"],
        library_note="scaled_dot_product_attention with a boolean mask",
        product_route=route,
        **{f"at_kv_len_{kv}": {k: (v if k != "bound" else v[0])
                               for k, v in times[kv].items()}
           for kv in (128, 256)})
    r = rows["flash_decode_paged"]
    say("kernel_time", kernel="flash_decode_paged", kernel_ms=r["ms"],
        plain_ms=r["plain_ms"], library_ms=None, bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], share_of_bound=r["share_of_bound"],
        flash_decode_ms=dense_row["ms"],
        yardstick_sdpa_dense_ms=dense_row["library_ms"],
        batch_1=r["batch_1"])
    return rows


def phase_int8_kernels(torch, timer):
    """The int8 modes at the serving shapes, q in bf16, caches quantized
    by ``quantize_kv`` from normal draws and held as layer slices: each
    against its plain version, the paged mode BITWISE equal to the dense
    one at page 128 and 48, the chunk mode also in fp32; all timed. The
    library yardstick is SDPA over the dequantized bf16 cache of the same
    content (the dequantization not timed)."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.generation.kv_cache import quantize_kv
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    cpu_gen = torch.Generator().manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    h, d = 12, 64
    rows = {}

    def int8_cache(b, t, hk):
        """int8 k, v [b, t, hk, d] and bf16 scales [b, t, hk], each the
        layer-1 slice of a two-layer cache."""
        out = []
        for _ in range(2):
            vals = torch.empty((2, b, t, hk, d), dtype=torch.int8,
                               device=dev)
            scales = torch.empty((2, b, t, hk), dtype=bf16, device=dev)
            vals[1], scales[1], _ = quantize_kv(torch.randn(
                (b, t, hk, d), generator=gen, device=dev))
            out.append((vals[1], scales[1]))
        (k, ks), (v, vs) = out
        return k, v, ks, vs

    def dequant(c, sc):
        return (c.float() * sc.float()[..., None]).to(bf16).transpose(1, 2)

    def decode(q, k, v, ks, vs, kv):
        return fa.flash_attention_decode(q, k, v, kv, k_scale=ks, v_scale=vs)

    def decode_plain(q, k, v, ks, vs, kv):
        return fa.flash_attention_decode_plain(q, k, v, kv, k_scale=ks,
                                               v_scale=vs)

    # -- decode: one decode step of the 8-slot engine (cache 640)
    B, T = 8, 640
    kv = torch.tensor([1, 1, 17, 200, 333, 512, 577, 640],
                      dtype=torch.int32, device=dev)
    dsets = [(torch.randn((B, 1, h, d), generator=gen, device=dev).to(bf16),
              *int8_cache(B, T, h), kv) for _ in range(8)]
    out, ref = decode(*dsets[0]), decode_plain(*dsets[0])
    torch.cuda.synchronize()
    err, n_bad = _err(out, ref)
    say("kernel_check", kernel="flash_decode_int8", shape=[B, T, h, d], sq=1,
        kv_len=kv.tolist(), max_abs_err=err,
        tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad)
    if n_bad:
        fail("flash_decode_int8 disagrees with its plain version")
    plain_ms = timer.ms(decode_plain, dsets)

    def sdpa(lens, sets):
        """SDPA with a length mask over the dequantized caches of
        ``sets``, and those inputs."""
        cols = torch.arange(T, device=dev)
        mask = cols[None, :] < torch.tensor(lens, device=dev)[:, None]
        return (lambda q, k, v: TF.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask[:, None, None, :]),
                [(st[0].transpose(1, 2), dequant(st[1], st[3]),
                  dequant(st[2], st[4])) for st in sets])

    lens = kv.tolist()
    lib_call, lib_sets = sdpa(lens, dsets)
    t8 = decode_timing(timer, decode, dsets, lens, h, d, True,
                       lib_call=lib_call, lib_sets=lib_sets)
    del lib_sets
    # batch 1: generate's decode step
    kv1 = torch.tensor([B1_KV_LEN], dtype=torch.int32, device=dev)
    b1_sets = [(torch.randn((1, 1, h, d), generator=gen,
                            device=dev).to(bf16),
                *int8_cache(1, B1_T, h), kv1) for _ in range(8)]
    err1, n_bad = _err(decode(*b1_sets[0]), decode_plain(*b1_sets[0]))
    say("kernel_check", kernel="flash_decode_int8", shape=[1, B1_T, h, d],
        sq=1, kv_len=[B1_KV_LEN], max_abs_err=err1,
        tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad)
    if n_bad:
        fail("flash_decode_int8 disagrees with its plain version at batch 1")
    lib_call, lib_sets = sdpa([B1_KV_LEN], b1_sets)
    t1 = decode_timing(timer, decode, b1_sets, [B1_KV_LEN], h, d, True,
                       lib_call=lib_call, lib_sets=lib_sets)
    del lib_sets
    rows["flash_decode_int8"] = dict(
        name="flash_decode_int8", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:942",
        shape="q [8,1,12,64] bf16, int8 cache [8,640,12,64] with bf16 "
              "scales [8,640,12], ragged kv_len",
        max_abs_err=max(err, err1), ms=t8["ms"], plain_ms=plain_ms,
        bound_ms=t8["bound_ms"], bound_by=t8["bound_by"],
        library_ms=t8["library_ms"],
        library_note="scaled_dot_product_attention with a length mask over "
                     "the dequantized bf16 cache (dequantization not timed)",
        share_of_bound=t8["share_of_bound"],
        batch_1=dict(shape="q [1,1,12,64] bf16, int8 cache [1,640,12,64], "
                           "kv_len 512", **t1))

    # -- paged: the decode check's content in a 41-page pool of 128 (and
    # 48), scale pages through the same shuffled table
    def paged_of(st, page):
        b = st[1].shape[0]
        perm = torch.randperm(b * -(-T // page), generator=cpu_gen).to(dev)
        (kp, table), (vp, _), (ksp, _), (vsp, _) = (
            _pool_of(torch, gen, c, page, perm) for c in st[1:5])
        return st[0], kp, vp, ksp, vsp, table, st[5]

    def paged(q, kp, vp, ksp, vsp, table, kv):
        return fa.flash_attention_decode_paged(q, kp, vp, table, kv,
                                               k_scale=ksp, v_scale=vsp)

    def paged_plain(q, kp, vp, ksp, vsp, table, kv):
        return fa.flash_attention_decode_paged_plain(
            q, kp, vp, table, kv, k_scale=ksp, v_scale=vsp)

    for page in (128, 48):
        pst = paged_of(dsets[0], page)
        out, ref = paged(*pst), paged_plain(*pst)
        dense = decode(*dsets[0])
        torch.cuda.synchronize()
        err, n_bad = _err(out, ref)
        bitwise = bool(torch.equal(out, dense))
        say("kernel_check", kernel="flash_decode_paged_int8", page=page,
            pool=list(pst[1].shape), scale_pool=list(pst[3].shape),
            table=list(pst[5].shape), kv_len=kv.tolist(), max_abs_err=err,
            tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=n_bad,
            bitwise_equal_to_flash_decode_int8=bitwise)
        if n_bad:
            fail(f"flash_decode_paged_int8 disagrees with its plain version "
                 f"at page {page}")
        if not bitwise:
            fail(f"flash_decode_paged_int8 differs from flash_decode_int8 at "
                 f"page {page}")
        if page == 128:
            paged_err = err
    psets = [paged_of(st, 128) for st in dsets]
    p8 = decode_timing(timer, paged, psets, lens, h, d, True, page=128)
    pplain_ms = timer.ms(paged_plain, psets)
    del psets
    p1_sets = [paged_of(st, 128) for st in b1_sets]
    if not torch.equal(paged(*p1_sets[0]), decode(*b1_sets[0])):
        fail("flash_decode_paged_int8 differs from flash_decode_int8 at "
             "batch 1")
    p1 = decode_timing(timer, paged, p1_sets, [B1_KV_LEN], h, d, True,
                       page=128)
    rows["flash_decode_paged_int8"] = dict(
        name="flash_decode_paged_int8", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode_paged.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:1323",
        shape="q [8,1,12,64] bf16, int8 pool [41,128,12,64] with bf16 "
              "scales [41,128,12] through a shuffled [8,5] table, ragged "
              "kv_len",
        max_abs_err=paged_err, ms=p8["ms"], plain_ms=pplain_ms,
        bound_ms=p8["bound_ms"], bound_by=p8["bound_by"], library_ms=None,
        library_note="none: no PyTorch call takes a page table",
        share_of_bound=p8["share_of_bound"],
        yardstick_sdpa_dense_dequantized_ms=t8["library_ms"],
        flash_decode_int8_ms=t8["ms"],
        batch_1=dict(shape="q [1,1,12,64] bf16, int8 pool [6,128,12,64] "
                           "through a [1,5] table, kv_len 512",
                     yardstick_sdpa_dense_dequantized_ms=t1["library_ms"],
                     **p1))
    del dsets, b1_sets, p1_sets

    # -- chunk: a 128-token chunk against the batch-1 int8 side cache at
    # the 2nd and 4th chunks of a 500-token prompt; one GQA window
    def chunk_inputs(sq, hq, hk, kv_len, dtype):
        q = torch.randn((1, sq, hq, d), generator=gen, device=dev).to(dtype)
        return (q, *int8_cache(1, 640, hk),
                torch.tensor([kv_len], dtype=torch.int32, device=dev))

    def chunk(q, k, v, ks, vs, kv):
        return fa.flash_attention_chunk(q, k, v, kv, k_scale=ks, v_scale=vs)

    def chunk_plain(q, k, v, ks, vs, kv):
        return fa.flash_attention_chunk_plain(q, k, v, kv, k_scale=ks,
                                              v_scale=vs)

    worst = 0.0
    for dtype, sq, hq, hk, kv_len in (
            (bf16, 128, 12, 12, 256), (bf16, 128, 12, 12, 512),
            (bf16, 200, 12, 4, 450), (torch.float32, 128, 12, 12, 512),
            (torch.float32, 200, 12, 4, 450)):
        args = chunk_inputs(sq, hq, hk, kv_len, dtype)
        out, ref = chunk(*args), chunk_plain(*args)
        torch.cuda.synchronize()
        if dtype is torch.float32:
            err, n_bad = _err(out, ref, F32_ATOL, F32_RTOL)
            tol = f"{F32_ATOL}+{F32_RTOL}*|plain|"
        else:
            err, n_bad = _err(out, ref)
            tol = f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|"
            worst = max(worst, err)
        say("kernel_check", kernel="flash_chunk_int8",
            dtype=str(dtype).split(".")[-1], q=[1, sq, hq, d],
            cache=[1, 640, hk, d], kv_len=kv_len, max_abs_err=err, tol=tol,
            out_of_tol=n_bad)
        if n_bad:
            fail(f"flash_chunk_int8 disagrees with its plain version at "
                 f"sq={sq} kv_len={kv_len} {dtype}")
    rep = chunk_inputs(128, 12, 12, 512, bf16)
    repeats = bool(torch.equal(chunk(*rep), chunk(*rep)))
    say("kernel_bitwise", kernels=["flash_chunk_int8"],
        route=fa.chunk_route(bf16, d), repeats_bitwise=repeats)
    if not repeats:
        fail("flash_chunk_int8 is not bitwise repeatable")
    times = {}
    for kv_len in (128, 256, 512):
        csets = [chunk_inputs(128, 12, 12, kv_len, bf16) for _ in range(8)]
        cols = torch.arange(640, device=dev)
        rws = torch.arange(128, device=dev)
        cmask = cols[None, :] <= kv_len - 128 + rws[:, None]    # [128, 640]
        lib_sets = [(st[0].transpose(1, 2), dequant(st[1], st[3]),
                     dequant(st[2], st[4])) for st in csets]
        pairs = sum(kv_len - 128 + i + 1 for i in range(128))
        c_bytes = 2 * 128 * h * d * 2 + 2 * kv_len * h * d \
            + 2 * kv_len * h * 2 + 4
        times[kv_len] = dict(
            ms=timer.ms(chunk, csets), plain_ms=timer.ms(chunk_plain, csets),
            library_ms=timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
                q, k, v, attn_mask=cmask), lib_sets),
            bound=bound_ms(c_bytes, 4 * pairs * h * d))
        say("kernel_time", kernel="flash_chunk_int8", kv_len=kv_len,
            kernel_ms=times[kv_len]["ms"], plain_ms=times[kv_len]["plain_ms"],
            library_ms=times[kv_len]["library_ms"],
            bound_ms=times[kv_len]["bound"][0],
            bound_by=times[kv_len]["bound"][1])
    t4 = times[512]
    rows["flash_chunk_int8"] = dict(
        name="flash_chunk_int8", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:1163",
        shape="q [1,128,12,64] bf16 against an int8 [1,640,12,64] side cache "
              "with bf16 scales at kv_len 512",
        max_abs_err=worst, ms=t4["ms"], plain_ms=t4["plain_ms"],
        bound_ms=t4["bound"][0], bound_by=t4["bound"][1],
        library_ms=t4["library_ms"],
        library_note="scaled_dot_product_attention with a boolean mask over "
                     "the dequantized bf16 cache (dequantization not timed)",
        product_route=fa.chunk_route(bf16, d),
        **{f"at_kv_len_{kv}": {k: (v if k != "bound" else v[0])
                               for k, v in times[kv].items()}
           for kv in (128, 256)})
    for name in ("flash_decode_int8", "flash_decode_paged_int8"):
        r = rows[name]
        say("kernel_time", kernel=name, kernel_ms=r["ms"],
            plain_ms=r["plain_ms"], library_ms=r["library_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            share_of_bound=r["share_of_bound"], batch_1=r["batch_1"])
    return rows


#: the serving phases' speculative configuration: k = 4 draft tokens,
#: so a verify window is Sq = 5 query rows; prompt-lookup on 3-grams
SPEC_K, SPEC_NGRAM = 4, 3


def phase_verify_window_kernels(torch, timer, rows):
    """Rows 5 and 7 at the verify window of the 8-slot engine's k = 4
    speculative step: q [8,5,12,64] bf16 against the [8,640,12,64] cache
    (paged: the 41-page pool of 128 through a shuffled [8,5] table),
    ragged lengths, query row i of a batch row attending to its own
    position, full width and int8. Each against its plain version, paged
    bitwise equal to dense; timed beside the Sq = 1 step with the bytes
    bound and SDPA under the window's mask (int8: over the dequantized
    cache, dequantization not timed). Adds ``verify_window_k4`` to each
    of the four rows."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.generation.kv_cache import quantize_kv
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    cpu_gen = torch.Generator().manual_seed(SEED + 16)
    bf16 = torch.bfloat16
    B, T, h, d, sq = 8, 640, 12, 64, SPEC_K + 1
    # the mask lengths of a window: each slot's kv_len before it, + 5
    kv = torch.tensor([5, 6, 22, 205, 338, 517, 582, 640], dtype=torch.int32,
                      device=dev)
    lens = kv.tolist()
    cols = torch.arange(T, device=dev)
    mask = cols[None, None, :] <= (kv[:, None, None] - sq + torch.arange(
        sq, device=dev)[None, :, None])                      # [B, sq, T]
    # the (row, column) pairs the window attends
    pairs = sum(k - sq + i + 1 for k in lens for i in range(sq))

    def layer_slice(shape, dtype):
        return torch.randn((2,) + shape, generator=gen,
                           device=dev).to(dtype)[1]

    def inputs(int8):
        q = torch.randn((B, sq, h, d), generator=gen, device=dev).to(bf16)
        if not int8:
            return (q, layer_slice((B, T, h, d), bf16),
                    layer_slice((B, T, h, d), bf16), None, None, kv)
        out = []
        for _ in range(2):
            vals = torch.empty((2, B, T, h, d), dtype=torch.int8, device=dev)
            scales = torch.empty((2, B, T, h), dtype=bf16, device=dev)
            vals[1], scales[1], _ = quantize_kv(torch.randn(
                (B, T, h, d), generator=gen, device=dev))
            out.append((vals[1], scales[1]))
        (k, ks), (v, vs) = out
        return q, k, v, ks, vs, kv

    def dense(q, k, v, ks, vs, kv):
        return fa.flash_attention_decode(q, k, v, kv, k_scale=ks, v_scale=vs)

    def dense_plain(q, k, v, ks, vs, kv):
        return fa.flash_attention_decode_plain(q, k, v, kv, k_scale=ks,
                                               v_scale=vs)

    def paged_of(st):
        perm = torch.randperm(B * 5, generator=cpu_gen).to(dev)
        pools = [None if c is None else _pool_of(torch, gen, c, 128, perm)
                 for c in st[1:5]]
        table = pools[0][1]
        return (st[0],) + tuple(None if p is None else p[0]
                                for p in pools) + (table, st[5])

    def paged(q, kp, vp, ksp, vsp, table, kv):
        return fa.flash_attention_decode_paged(q, kp, vp, table, kv,
                                               k_scale=ksp, v_scale=vsp)

    def paged_plain(q, kp, vp, ksp, vsp, table, kv):
        return fa.flash_attention_decode_paged_plain(
            q, kp, vp, table, kv, k_scale=ksp, v_scale=vsp)

    def dequant(c, sc):
        if sc is None:
            return c.transpose(1, 2)
        return (c.float() * sc.float()[..., None]).to(bf16).transpose(1, 2)

    for int8 in (False, True):
        sfx = "_int8" if int8 else ""
        sets = [inputs(int8) for _ in range(8)]
        psets = [paged_of(st) for st in sets]
        out, ref = dense(*sets[0]), dense_plain(*sets[0])
        pout, pref = paged(*psets[0]), paged_plain(*psets[0])
        torch.cuda.synchronize()
        err, n_bad = _err(out, ref)
        perr, p_bad = _err(pout, pref)
        bitwise = bool(torch.equal(pout, out))
        for name, e, nb, extra in (
                ("flash_decode" + sfx, err, n_bad, {}),
                ("flash_decode_paged" + sfx, perr, p_bad,
                 {"bitwise_equal_to_flash_decode" + sfx: bitwise})):
            say("kernel_check", kernel=name, shape=[B, T, h, d], sq=sq,
                kv_len=lens, max_abs_err=e,
                tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|", out_of_tol=nb,
                **extra)
            if nb:
                fail(f"{name} disagrees with its plain version at sq={sq}")
        if not bitwise:
            fail(f"flash_decode_paged{sfx} differs from flash_decode{sfx} "
                 f"at sq={sq}")
        lib_sets = [(st[0].transpose(1, 2), dequant(st[1], st[3]),
                     dequant(st[2], st[4])) for st in sets]
        lib_ms = timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None]), lib_sets)
        del lib_sets
        for name, call, plain, tsets, page, e in (
                ("flash_decode" + sfx, dense, dense_plain, sets, None, err),
                ("flash_decode_paged" + sfx, paged, paged_plain, psets, 128,
                 perr)):
            ms = timer.ms(call, tsets)
            bms, by = bound_ms(decode_bytes(lens, h, d, int8, page, sq),
                               4 * pairs * h * d)
            row = dict(
                shape=f"q [8,{sq},12,64] bf16, "
                      + ("pool [41,128,12,64] through a shuffled [8,5] "
                         "table" if page else "cache [8,640,12,64]")
                      + (" int8 with bf16 scales" if int8 else "")
                      + ", ragged kv_len",
                sq=sq, max_abs_err=e, ms=ms, plain_ms=timer.ms(plain, tsets),
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
                yardstick_sdpa_ms=lib_ms, sq1_ms=rows[name]["ms"])
            rows[name]["verify_window_k4"] = row
            say("kernel_time", kernel=name, sq=sq, kernel_ms=ms,
                plain_ms=row["plain_ms"], library_ms=lib_ms if not page
                else None, yardstick_sdpa_ms=lib_ms, bound_ms=bms,
                bound_by=by, share_of_bound=row["share_of_bound"],
                sq1_kernel_ms=row["sq1_ms"])
        del sets, psets


def phase_train_kernels(torch, timer):
    """The training path's kernels against their plain versions: the
    forward with its LSE, as ``_FlashAttentionFn`` calls it, and
    flash_bwd on the forward's output and LSE, in bf16 at the flagship
    shape q, k, v [16, 1024, 12, 64] causal and three more, and in fp32
    at the flagship shape. Self-attention inputs are strided views of one
    fused qkv buffer, as the model gives them. Then, at the flagship
    shape, both on the tensor-core route, repeated and against batch 1,
    and flash_bwd and flash_fwd timed."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def inputs(b, sq, sk, hq, hk, d, causal, dtype=bf16):
        if sq == sk and hq == hk:     # views of the qkv projection
            q, k, v = randn(b, sq, 3, hq, d, dtype=dtype).unbind(2)
        else:
            q = randn(b, sq, hq, d, dtype=dtype)
            k, v = randn(b, sk, hk, d, dtype=dtype), randn(b, sk, hk, d,
                                                           dtype=dtype)
        out, lse = fa.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
        return q, k, v, out, lse, randn(b, sq, hq, d, dtype=dtype)

    def check(kernel, errs, tol, **shape):
        n_bad = {n: e[1] for n, e in errs.items()}
        say("kernel_check", kernel=kernel, **shape,
            route=fa.route(getattr(torch, shape["dtype"]), 64),
            max_abs_err={n: e[0] for n, e in errs.items()},
            err_over_max_plain={n: e[2] for n, e in errs.items()},
            tol=tol, out_of_tol=n_bad)
        if sum(n_bad.values()):
            fail(f"{kernel} disagrees with its plain version at {shape}")

    def errs_of(pairs, measure):
        return {n: measure(a, r) + (float((a.float() - r.float()).abs().max()
                                          / r.float().abs().max()),)
                for n, a, r in pairs}

    lse_tol = f"lse {LSE_ATOL}+{LSE_RTOL}*|plain|"
    worst = 0.0
    for dtype, b, sq, sk, hq, hk, causal in (
            (bf16, 16, 1024, 1024, 12, 12, True),
            (bf16, 2, 300, 300, 12, 12, True),
            (bf16, 2, 512, 512, 12, 4, True),
            (bf16, 2, 200, 520, 12, 12, False),
            (f32, 16, 1024, 1024, 12, 12, True)):
        q, k, v, out, lse, do = inputs(b, sq, sk, hq, hk, 64, causal, dtype)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                    return_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        if dtype is bf16:
            measure = _err_scaled
            tol = f"{ULP_BF16}*|plain|+{SCALED_FRAC}*max|plain| per tensor"
        else:
            def measure(a, r):
                return _err(a, r, F32_ATOL, F32_RTOL)
            tol = f"{F32_ATOL}+{F32_RTOL}*|plain|"
        shape = dict(dtype=str(dtype).split(".")[-1], q=[b, sq, hq, 64],
                     kv=[b, sk, hk, 64], causal=causal,
                     qkv_views=sq == sk and hq == hk)
        fwd = errs_of([("out", out, ref_out)], measure)
        fwd.update(errs_of([("lse", lse, ref_lse)],
                           lambda a, r: _err(a, r, LSE_ATOL, LSE_RTOL)))
        check("flash_fwd", fwd, f"{tol}; {lse_tol}", **shape)
        bwd = errs_of(zip(("dq", "dk", "dv"), grads, ref), measure)
        check("flash_bwd", bwd, tol, **shape)
        if dtype is bf16:
            worst = max([worst] + [e[0] for e in bwd.values()])
        del q, k, v, out, lse, do, grads, ref, ref_out, ref_lse

    b, s, h, d = 16, 1024, 12, 64
    if fa.route(bf16, d) != "mma":
        fail(f"flash attention in bf16 at head_dim {d} is not on the "
             "tensor-core route")
    sets = [inputs(b, s, s, h, h, d, True) for _ in range(3)]
    q, k, v, _, _, do = sets[0]
    _bitwise(torch, fa, [b, s, h, d], q, k, v, do, row=5)
    del q, k, v, do
    ms = timer.ms(lambda q, k, v, o, l, do: fa.flash_attention_bwd(
        q, k, v, o, l, do, True), sets)
    plain_ms = timer.ms(lambda q, k, v, o, l, do: fa.flash_attention_bwd_plain(
        q, k, v, o, l, do, True), sets, n=5)
    lib = []
    for q, k, v, _, _, do in sets:
        qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        lib.append((TF.scaled_dot_product_attention(qh, kh, vh,
                                                    is_causal=True),
                    (qh, kh, vh), do.transpose(1, 2).contiguous()))
    lib_ms = timer.ms(lambda o, ins, do: torch.autograd.grad(
        o, ins, do, retain_graph=True), lib)
    pairs = b * h * s * (s + 1) // 2          # visible (row, col) pairs
    elems = b * s * h * d
    n_bytes = 8 * elems * 2 + 2 * b * h * s * 4
    bms, by = bound_ms(n_bytes, 10 * pairs * d)
    row = dict(
        name="flash_bwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_bwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:714",
        also_replaces=["paddle_tpu/kernels/flash_attention.py:628",
                       "paddle_tpu/kernels/flash_attention.py:673"],
        shape="q,k,v,dO [16,1024,12,64] bf16 causal (delta included)",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, flash_route=fa.route(bf16, d))
    say("kernel_time", kernel="flash_bwd", kernel_ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by, shape=row["shape"],
        route=row["flash_route"])
    del lib

    qkv = [st[:3] for st in sets]
    fwd_ms = timer.ms(lambda q, k, v: fa.flash_attention(q, k, v,
                                                         causal=True), qkv)
    fwd_plain = timer.ms(lambda q, k, v: fa.flash_attention_plain(
        q, k, v, causal=True), qkv, n=5)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in st)
                for st in qkv]
    fwd_lib = timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
        q, k, v, is_causal=True), lib_sets)
    fbms, fby = bound_ms(4 * elems * 2, 4 * pairs * d)
    fwd_train = dict(shape="q,k,v [16,1024,12,64] bf16 causal", ms=fwd_ms,
                     plain_ms=fwd_plain, library_ms=fwd_lib, bound_ms=fbms,
                     bound_by=fby)
    say("kernel_time", kernel="flash_fwd", kernel_ms=fwd_ms,
        plain_ms=fwd_plain, library_ms=fwd_lib, bound_ms=fbms, bound_by=fby,
        shape=fwd_train["shape"], route=fa.route(bf16, d))
    return row, fwd_train


_FUSED_ROWS = (  # name, prologue, backward, TPU kernel it replaces
    ("mm_bn_stats", False, False, "paddle_tpu/kernels/fused_resnet.py:267"),
    ("bn_relu_mm_bn_stats", True, False,
     "paddle_tpu/kernels/fused_resnet.py:297"),
    ("mm_bn_stats_bwd", False, True, "paddle_tpu/kernels/fused_resnet.py:192"),
    ("bn_relu_mm_bn_stats_bwd", True, True,
     "paddle_tpu/kernels/fused_resnet.py:225"),
)
# ResNet-50 at b128 224x224: layer1's widest product (the downsample
# and conv3, 64 -> 256 over 401,408 rows) and layer4's deepest (conv1
# 2048 -> 512, conv3 512 -> 2048, over 6,272 rows)
_FUSED_SHAPES = {False: ((401408, 64, 256), (6272, 2048, 512)),
                 True: ((401408, 64, 256), (6272, 512, 2048))}


def _fused_bound(m, k, n, pro, bwd):
    """Least time for one fused call: each input read once and each
    output written once at the HBM rate, against the products at the
    bf16 tensor rate plus the elementwise work at the fp32 rate."""
    if bwd:
        n_bytes = 2 * (2 * m * n + 2 * m * k + k * n) + 4 * k * n + 12 * n
        flops, ew = 4 * m * k * n, 4 * m * n + (7 * m * k if pro else 0)
        n_bytes += 16 * k if pro else 0
    else:
        n_bytes = 2 * (m * k + k * n + m * n) + 8 * n + (8 * k if pro else 0)
        flops, ew = 2 * m * k * n, 3 * m * n + (3 * m * k if pro else 0)
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS + ew / PEAK_FLOPS_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _gemm_args(key):
    """The template arguments of a kernel of ``csrc/conv_gemm.cuh``'s
    tile body (``mm_stats_kernel<T, Kind, prologue, tap>``) from its
    profiler name, or None for another kernel. ``tap`` "true" is the 3x3
    pair's implicit GEMM route, "false" a 1x1 kernel."""
    if "mm_stats_kernel<" not in key:
        return None
    return _template_args(key, "mm_stats_kernel<")


def _template_args(key, name):
    """The template arguments after ``name`` in a kernel's profiler name,
    casts dropped and bools as "true"/"false" (demanglers print
    "(bool)1" or "true")."""
    args = []
    for a in key.split(name, 1)[1].split(">", 1)[0].split(","):
        a = a.strip()
        if a.startswith("("):
            kind, a = a[1:].split(")", 1)
            if kind == "bool":
                a = "true" if a == "1" else "false"
        args.append(a)
    return args


def _split_ms(torch, fn, input_sets, n=5):
    """Device ms per call of each kernel ``fn`` launches, by part: the
    products ("fwd", "dx", "dw": the 1x1 and 3x3 GEMM kernels by their
    Kind, the 3x3 window kernels by theirs), the 3x3 GEMM route's
    pre-passes ("prep": a, e and the flipped weights) and the fixed-order
    combines ("stats_finish", and "column_total" with the GEMM route's
    chunk sums), from a profile of ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn(*input_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*input_sets[i % len(input_sets)])
        torch.cuda.synchronize()
    def part(key):
        for name in ("stats_finish", "column_total"):
            if name in key:
                return name
        if "chunk_total_kernel" in key:
            return "column_total"
        if "conv3x3_prep_kernel" in key or "conv3x3_flip_kernel" in key:
            return "prep"
        if "conv3x3_dw_kernel" in key:
            return "dw"
        if "conv3x3_kernel<" in key:
            dx = _template_args(key, "conv3x3_kernel<")[1] == "true"
            return "dx" if dx else "fwd"
        args = _gemm_args(key)
        if args is None:
            return "other"
        return {"0": "fwd", "1": "dx", "2": "dw"}[args[1]]

    parts = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            p = part(e.key)
            parts[p] = parts.get(p, 0.0) + e.device_time_total / 1e3 / n
    return parts


def phase_fused_resnet_kernels(torch, timer):
    """Rows 13-16 (the 1x1 conv + BN-stats kernels and their backwards)
    against their plain versions in bf16 at ResNet-50's layer1 and
    layer4 shapes, on the tensor-core route, each kernel twice on the
    same inputs (the bits must repeat), then timed beside the plain
    version and the PyTorch yardstick (cuBLAS products with torch's
    reductions and elementwise ops) at both shapes, with each call's
    device time split by kernel (``_split_ms``)."""
    from paddle_tpu_torch.kernels import fused_resnet as fr
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    product_route = fr.route(bf16)
    if product_route != "mma":
        fail(f"the fused 1x1 kernels in bf16 are on route {product_route}, "
             "not the tensor cores")

    def inputs(m, k, n):
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s
        x = (r(m, k) + 0.5).to(bf16)
        w2 = r(k, n, s=k ** -0.5).to(bf16)
        perch, dvar2 = fr._stats_cotangent_coeffs(r(n), r(n), m)
        return dict(x=x, w2=w2, scale=r(k).abs() + 0.5, shift=r(k, s=0.3),
                    dy=r(m, n, s=1e-2).to(bf16), perch=perch, dvar2=dvar2)

    def fwd_args(t, pro):
        return (t["x"], t["scale"], t["shift"], t["w2"]) if pro \
            else (t["x"], t["w2"])

    def bwd_args(t, pro):
        return ((t["dy"], t["y"], t["x"])
                + ((t["scale"], t["shift"]) if pro else ())
                + (t["w2"], t["perch"], t["dvar2"], t["mean"]))

    def lib_fwd(x, *rest):
        a = x if len(rest) == 1 else \
            torch.relu(x.float() * rest[0] + rest[1]).to(bf16)
        y = torch.matmul(a, rest[-1])
        return y, torch.var_mean(y.float(), 0, correction=0)

    def lib_bwd(dy, y, x, *rest):
        scale, shift = rest[:2] if len(rest) == 6 else (None, None)
        w2, perch, dvar2, mean = rest[-4:]
        e = (dy.float() + perch + dvar2 * (y.float() - mean)).to(bf16)
        if scale is None:
            return torch.matmul(e, w2.t()), torch.matmul(x.t(), e)
        pre = x.float() * scale + shift
        gated = torch.where(pre > 0, torch.matmul(e, w2.t()).float(), 0.0)
        return ((gated * scale).to(bf16),
                torch.matmul(torch.relu(pre).to(bf16).t(), e),
                (gated * x.float()).sum(0), gated.sum(0))

    rows = {}
    for name, pro, bwd, replaces in _FUSED_ROWS:
        kernel = {(False, False): fr.matmul_bn_stats_fwd,
                  (True, False): fr.bn_relu_matmul_bn_stats_fwd,
                  (False, True): fr.matmul_bn_stats_bwd,
                  (True, True): fr.bn_relu_matmul_bn_stats_bwd}[pro, bwd]
        plain = fr.PLAIN_VERSIONS[fr.KERNEL_WRAPPERS.index(kernel)]
        args_of = bwd_args if bwd else fwd_args
        worst, by_shape = 0.0, []
        for m, k, n in _FUSED_SHAPES[pro]:
            sets = []
            for _ in range(3):      # three sets: more than L2 holds
                t = inputs(m, k, n)
                if bwd:     # the forward's y and mean, as saved
                    t["y"], t["mean"], _ = fr.matmul_bn_stats_fwd_plain(
                        t["x"], t["w2"])
                sets.append(args_of(t, pro))
            outs = kernel(*sets[0])
            again = kernel(*sets[0])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                fail(f"{name} is not bitwise repeatable at {(m, k, n)}")
            worst = max(worst, _check_fused(name, (m, k, n), outs,
                                            plain(*sets[0]), not bwd))
            del outs, again
            ms = timer.ms(kernel, sets)
            plain_ms = timer.ms(plain, sets, n=5)
            lib_ms = timer.ms(lib_bwd if bwd else lib_fwd, sets)
            split = _split_ms(torch, kernel, sets)
            bms, by = _fused_bound(m, k, n, pro, bwd)
            by_shape.append(dict(m=m, k=k, n=n, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bms,
                                 bound_by=by, split_ms=split))
            say("kernel_time", kernel=name, shape=[m, k, n], kernel_ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, route=product_route, split_ms=split)
            del sets
            torch.cuda.empty_cache()
        first = by_shape[0]
        rows[name] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/fused_resnet.cu",
            replaces=replaces,
            shape=f"M={first['m']}, K={first['k']} -> N={first['n']} bf16 "
                  "(ResNet-50 layer1 at b128)",
            max_abs_err=worst, ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], by_shape=by_shape,
            product_route=product_route)
    return rows


_CONV3_ROWS = (  # name, backward, TPU kernel it replaces
    ("conv3x3_bn_stats", False, "paddle_tpu/kernels/fused_resnet.py:595"),
    ("conv3x3_bn_stats_bwd", True, "paddle_tpu/kernels/fused_resnet.py:628"),
)
# ResNet-50 at b128 224x224: the stride-1 3x3 of layer1 (56x56, 64 -> 64),
# layer2 (28x28, 128 -> 128), layer3 (14x14, 256 -> 256) and layer4 (7x7,
# 512 -> 512); 3, 3, 5 and 2 of them a step (13)
_CONV3_SHAPES = ((128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
                 (128, 14, 14, 256, 256), (128, 7, 7, 512, 512))


def _conv3x3_bound(n, h, w, c, o, bwd):
    """Least time for one fused 3x3 call, by the rule of
    ``_fused_bound``: each input read once and each output written once
    at the HBM rate, against the products at the bf16 tensor rate plus
    the elementwise work at the fp32 rate."""
    m, k = n * h * w, 9 * c
    if bwd:
        n_bytes = 2 * (2 * m * o + 2 * m * c + k * o) + 4 * k * o \
            + 12 * o + 16 * c
        flops, ew = 4 * m * k * o, 4 * m * o + 7 * m * c
    else:
        n_bytes = 2 * (m * c + k * o + m * o) + 8 * o + 8 * c
        flops, ew = 2 * m * k * o, 3 * m * o + 3 * m * c
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS + ew / PEAK_FLOPS_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_fused(name, shape, outs, refs, stats):
    """Each output of a fused kernel against its plain version by the
    rules of rows 13-16: y and dx within ULP_BF16*|plain| +
    SCALED_FRAC*max|plain|, per channel the mean within
    STATS_FRAC*sqrt(var) + 1e-6 and the var within STATS_FRAC*var +
    1e-6, the fp32 sums within SUM_FRAC*max|plain|. Fails the run on any
    element out of bounds; returns the first output's max |error|."""
    errs, n_bad = {}, 0
    labels = ("y", "mean", "var") if stats else \
        ("dx", "dw", "dscale", "dshift")
    for i, (label, a, r) in enumerate(zip(labels, outs, refs)):
        a, r = a.float(), r.float()
        diff = (a - r).abs()
        if i == 0:
            lim = ULP_BF16 * r.abs() + SCALED_FRAC * r.abs().max()
        elif stats and label == "mean":
            lim = STATS_FRAC * refs[2].float().sqrt() + 1e-6
        elif stats:
            lim = STATS_FRAC * r + 1e-6
        else:
            lim = SUM_FRAC * r.abs().max().expand_as(r)
        bad = int((~(diff <= lim)).sum())
        errs[label] = [float(diff.max()),
                       float(diff.max() / r.abs().max().clamp_min(1e-30)),
                       bad]
        n_bad += bad
    say("kernel_check", kernel=name, shape=list(shape), dtype="bfloat16",
        errors={k: dict(max_abs=v[0], over_max_plain=v[1], out_of_tol=v[2])
                for k, v in errs.items()},
        tol=f"{labels[0]} {ULP_BF16}*|plain|+{SCALED_FRAC}*max|plain|; "
        + ("mean 1e-3*sqrt(var)+1e-6, var 1e-3*var+1e-6" if stats else
           f"dw/dscale/dshift {SUM_FRAC}*max|plain|"))
    if n_bad:
        fail(f"{name} disagrees with its plain version at {shape}")
    return errs[labels[0]][0]


def phase_fused_conv3x3_kernels(torch, timer):
    """Rows 17-18 (the fused 3x3 conv + BN-stats kernel and its backward)
    against their plain versions in bf16 at ResNet-50's four stride-1
    3x3 shapes, with a shift that makes relu(shift) > 0 on some
    channels (the border must read 0, not relu(shift)), each kernel twice
    on the same inputs (the bits must repeat), then timed beside the
    plain version and the PyTorch yardstick, which the port never calls:
    the prologue in torch, ``F.conv2d`` on channels-last bf16 (cuDNN)
    and ``torch.var_mean``; for the backward, ``torch.autograd.grad`` of
    the same graph. Each time is also split by kernel (``_split_ms``),
    with the route the wrapper chose at each shape."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import fused_resnet as fr
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    bf16 = torch.bfloat16

    def inputs(n, h, w, c, o):
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s
        x = (r(n, h, w, c) + 0.5).to(bf16)
        w9 = r(9 * c, o, s=(9 * c) ** -0.5).to(bf16)
        scale, shift = r(c).abs() + 0.5, r(c, s=0.3) + 0.1
        y, mean, _ = fr.conv3x3_bn_stats_fwd_plain(x, scale, shift, w9)
        perch, dvar2 = fr._stats_cotangent_coeffs(r(o), r(o), n * h * w)
        return dict(x=x, w9=w9, scale=scale, shift=shift, y=y, mean=mean,
                    dy=r(n, h, w, o, s=1e-2).to(bf16), perch=perch,
                    dvar2=dvar2, dmean=r(o), dvar=r(o))

    def fwd_args(t):
        return t["x"], t["scale"], t["shift"], t["w9"]

    def bwd_args(t):
        return (t["dy"], t["y"], t["x"], t["scale"], t["shift"], t["w9"],
                t["perch"], t["dvar2"], t["mean"])

    def lib_inputs(t, grad=False):
        """x, scale, shift and the channels-last [O, C, 3, 3] weight."""
        c, o = t["x"].shape[-1], t["w9"].shape[1]
        w = t["w9"].reshape(3, 3, c, o).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        return [v.detach().clone().requires_grad_(grad) for v in
                (t["x"], t["scale"], t["shift"], w)]

    def lib_graph(t):
        """The yardstick's forward on t, differentiable in its inputs:
        (outputs, inputs, cotangents) for ``lib_bwd``."""
        ins = lib_inputs(t, grad=True)
        return lib_fwd(*ins), ins, (t["dy"].permute(0, 3, 1, 2), t["dvar"],
                                    t["dmean"])

    def lib_fwd(x, scale, shift, w):
        a = torch.relu(x.float() * scale + shift).to(bf16)
        y = TF.conv2d(a.permute(0, 3, 1, 2), w, padding=1)
        return (y, *torch.var_mean(y.float(), (0, 2, 3), correction=0))

    def lib_bwd(outs, ins, cts):
        return torch.autograd.grad(outs, ins, cts, retain_graph=True)

    rows = {}
    for name, bwd, replaces in _CONV3_ROWS:
        kernel = fr.conv3x3_bn_stats_bwd if bwd else fr.conv3x3_bn_stats_fwd
        plain = fr.PLAIN_VERSIONS[fr.KERNEL_WRAPPERS.index(kernel)]
        args_of = bwd_args if bwd else fwd_args
        worst, by_shape = 0.0, []
        for shape in _CONV3_SHAPES:
            sets = [inputs(*shape) for _ in range(3)]  # more than L2 holds
            args = [args_of(t) for t in sets]
            outs = kernel(*args[0])
            again = kernel(*args[0])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                fail(f"{name} is not bitwise repeatable at {shape}")
            worst = max(worst, _check_fused(name, shape, outs,
                                            plain(*args[0]), not bwd))
            del outs, again
            ms = timer.ms(kernel, args)
            plain_ms = timer.ms(plain, args, n=5)
            if bwd:
                graphs = [lib_graph(t) for t in sets]
                lib_ms = timer.ms(lib_bwd, graphs, n=10)
                del graphs
            else:
                lib_ms = timer.ms(lib_fwd, [lib_inputs(t) for t in sets])
            bms, by = _conv3x3_bound(*shape, bwd)
            extra = dict(route=fr._conv3x3_route(*shape[1:]),
                         ms_by_kernel=_split_ms(torch, kernel, args),
                         share_of_bound=bms / ms)
            by_shape.append(dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bms,
                                 bound_by=by, **extra))
            say("kernel_time", kernel=name, shape=list(shape), kernel_ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, **extra)
            del sets, args
            torch.cuda.empty_cache()
        first = by_shape[0]
        rows[name] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/fused_conv3x3.cu",
            replaces=replaces,
            shape="x [128,56,56,64], w9 [576,64] bf16 (ResNet-50 layer1 at "
                  "b128)",
            max_abs_err=worst, ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], by_shape=by_shape)
    return rows


_NORM_ROWS = (  # name, dx, TPU kernel it replaces
    ("norm_fwd", False, "paddle_tpu/kernels/fused_norm.py:66"),
    ("norm_dx", True, "paddle_tpu/kernels/fused_norm.py:83"),
)
# x [rows, D] in bf16: gpt2-small's hidden at b16 s1024, and the
# gpt3-6.7b width (paddle_tpu/models/gpt.py:549) at 4096 tokens
_NORM_SHAPES = ((16384, 768), (4096, 4096))
_NORM_EPS = {False: 1e-5, True: 1e-6}     # the public functions' defaults


def _norm_bytes(rows, d, dx):
    """Bytes one bf16 norm call must move: x (and dy) read once, the
    output written once, the bf16 w (and b) read once."""
    return (6 if dx else 4) * rows * d + (2 if dx else 4) * d


def _norm_bound(rows, d, dx):
    """Least time for one bf16 norm call: its bytes (``_norm_bytes``)
    against the elementwise work (8 operations an element forward, 14
    for dx) at the fp32 rate."""
    t_bytes = _norm_bytes(rows, d, dx) / PEAK_BYTES
    t_ops = (14 if dx else 8) * rows * d / PEAK_FLOPS_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _adamw_bound(n, p_bytes, g_bytes):
    """Least time for AdamW on n values: p, m and v (fp32) read and
    written and g read once, against 18 fp32 operations a value."""
    t_bytes = n * (2 * p_bytes + 16 + g_bytes) / PEAK_BYTES
    t_ops = 18 * n / PEAK_FLOPS_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_norm_adamw_kernels(torch, timer):
    """Rows 8-10 against their plain versions and timed. The LayerNorm
    and RMSNorm kernels, forward and dx, in bf16 at [16384, 768] and
    [4096, 4096], within the training rule (y and dx within
    ULP_BF16*|plain| + SCALED_FRAC*max|plain|), beside the PyTorch
    yardsticks ``F.layer_norm`` / ``F.rms_norm`` and their autograd
    backward (dx only). AdamW on the tied embedding [50257, 768] (fp32
    master and moments, bf16 gradient) bit for bit against its plain
    version, beside ``torch.optim.AdamW(fused=True)`` on fp32 copies.
    The port never calls a yardstick."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import fused_adamw as fad
    from paddle_tpu_torch.kernels import fused_norm as fn
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16

    def r(*shape, s=1.0, o=0.0):
        return torch.randn(shape, generator=gen, device=dev) * s + o

    by_shape = {name: [] for name, _, _ in _NORM_ROWS}
    worst = {name: 0.0 for name, _, _ in _NORM_ROWS}
    for rows_, d in _NORM_SHAPES:
        sets = [dict(x=r(rows_, d, s=2.0, o=0.5).to(bf16),
                     dy=r(rows_, d).to(bf16), w=r(d, s=0.1, o=1.0).to(bf16),
                     b=r(d, s=0.1).to(bf16), zero=torch.zeros(
                         d, dtype=bf16, device=dev))
                for _ in range(3)]          # three sets: more than L2 holds
        for rms in (False, True):
            eps = _NORM_EPS[rms]
            fwd_args = [(t["x"], t["w"], t["zero" if rms else "b"], eps, rms)
                        for t in sets]
            dx_args = [(t["x"], t["w"], t["dy"], eps, rms) for t in sets]
            graphs = []
            for t in sets:
                xg = t["x"].detach().clone().requires_grad_()
                yg = TF.rms_norm(xg, (d,), t["w"], eps) if rms else \
                    TF.layer_norm(xg, (d,), t["w"], t["b"], eps)
                graphs.append((yg, xg, t["dy"]))
            lib = {
                False: lambda x, w, b, eps, rms: (
                    TF.rms_norm(x, (x.shape[1],), w, eps) if rms else
                    TF.layer_norm(x, (x.shape[1],), w, b, eps)),
                True: lambda y, x, dy: torch.autograd.grad(
                    y, x, dy, retain_graph=True)}
            for name, dx, replaces in _NORM_ROWS:
                kernel = fn.norm_dx if dx else fn.norm_fwd
                plain = fn.norm_dx_plain if dx else fn.norm_fwd_plain
                args = dx_args if dx else fwd_args
                out = kernel(*args[0])
                again = kernel(*args[0])
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    fail(f"{name} is not bitwise repeatable at {(rows_, d)}")
                err, bad = _err_scaled(out, plain(*args[0]))
                kind = "rms" if rms else "layer"
                say("kernel_check", kernel=name, norm=kind, shape=[rows_, d],
                    dtype="bfloat16", max_abs_err=err, out_of_tol=bad,
                    tol=f"{ULP_BF16}*|plain|+{SCALED_FRAC}*max|plain|")
                if bad:
                    fail(f"{name} ({kind}) disagrees with its plain version "
                         f"at {(rows_, d)}")
                worst[name] = max(worst[name], err)
                del out, again
                ms = timer.ms(kernel, args)
                plain_ms = timer.ms(plain, args, n=5)
                lib_ms = timer.ms(lib[dx], graphs if dx else args)
                bms, bby = _norm_bound(rows_, d, dx)
                by_shape[name].append(dict(
                    norm=kind, rows=rows_, d=d, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bms, bound_by=bby))
                say("kernel_time", kernel=name, norm=kind, shape=[rows_, d],
                    kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, bound_by=bby,
                    tb_per_s=_norm_bytes(rows_, d, dx) / ms / 1e9,
                    share_of_bound=bms / ms)
            del graphs
        del sets
        torch.cuda.empty_cache()
    rows = {}
    for name, dx, replaces in _NORM_ROWS:
        first = by_shape[name][0]
        rows[name] = dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/fused_norm.cu", replaces=replaces,
            shape="x [16384,768] bf16 LayerNorm (gpt2-small b16 s1024)",
            max_abs_err=worst[name], ms=first["ms"],
            plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
            by_shape=by_shape[name])

    # -- AdamW on the tied embedding
    shape = (50257, 768)
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.01, step=11)
    sets = [(r(*shape, s=0.02), r(*shape).to(bf16), r(*shape, s=1e-3),
             r(*shape, s=1e-3).square()) for _ in range(3)]
    kern = [t.clone() for t in sets[0]]
    plain = [t.clone() for t in sets[0]]
    fad.fused_adamw_update(*kern, **hyper)
    fad.fused_adamw_update_plain(*plain, **hyper)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
        fail("fused_adamw_update differs from its plain version on the "
             "[50257, 768] embedding")
    err = float((kern[0] - plain[0]).abs().max())
    say("kernel_check", kernel="fused_adamw", shape=list(shape),
        dtype="float32 master, bfloat16 grad", max_abs_err=err,
        bitwise_equal=True)
    del kern, plain

    def adamw(p, g, m, v):
        fad.fused_adamw_update(p, g, m, v, **hyper)

    def adamw_plain(p, g, m, v):
        fad.fused_adamw_update_plain(p, g, m, v, **hyper)

    ms = timer.ms(adamw, sets)
    plain_ms = timer.ms(adamw_plain, sets, n=5)
    libs = []
    for p, g, m, v in sets:
        q = torch.nn.Parameter(p.clone())
        q.grad = g.float()
        libs.append((torch.optim.AdamW(
            [q], lr=hyper["lr"], betas=(hyper["beta1"], hyper["beta2"]),
            eps=hyper["epsilon"], weight_decay=hyper["weight_decay"],
            fused=True),))
    lib_ms = timer.ms(lambda o: o.step(), libs)
    del libs, sets
    torch.cuda.empty_cache()
    bms, bby = _adamw_bound(shape[0] * shape[1], 4, 2)
    say("kernel_time", kernel="fused_adamw", shape=list(shape), kernel_ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=bby)
    rows["fused_adamw"] = dict(
        name="fused_adamw", route="cuda",
        source="paddle_tpu_torch/csrc/fused_adamw.cu",
        replaces="paddle_tpu/kernels/fused_adamw.py:46",
        shape="[50257,768] fp32 master, m, v; bf16 grad (gpt2-small's tied "
              "embedding)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=bby, library_ms=lib_ms)
    return rows


def _kernel_ms(torch, fn, args, n=3):
    """Device ms per call of each kernel ``fn(*args)`` launches, by its
    name (template arguments cut off), from a profile of ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"([A-Za-z_]\w*)[<(]", e.key)
            name = m.group(1) if m else e.key
            by[name] = by.get(name, 0.0) + e.device_time_total / 1e3 / n
    return by


_CE_ROWS = (  # name, TPU kernel it replaces
    ("fused_ce_fwd", "paddle_tpu/kernels/fused_ce.py:101"),
    ("fused_ce_bwd", "paddle_tpu/kernels/fused_ce.py:223"),
)
# (N, H, V, dtype, vocab_major): gpt2-small's LM head at b16 s1024 (the
# probe's shape: 16 x 1023 shifted positions, tied [V, H] embedding),
# the [H, V] layout, and fp32 at a smaller shape; N and V ragged to
# every tile; then hidden sizes past one 768-column slice (gpt2-medium's
# 1024, gpt2-xl's 1600) and one off a multiple of 8 (100, zero-padded)
_CE_SHAPES = ((16368, 768, 50257, "bfloat16", True),
              (4093, 768, 50257, "bfloat16", False),
              (2045, 768, 8191, "float32", True),
              (4093, 1024, 50257, "bfloat16", True),
              (2045, 1600, 50257, "bfloat16", False),
              (1027, 100, 8191, "float32", True))


def _ce_bound(n, hd, vocab, elem, bwd):
    """Least time for the fused CE on h [n, hd] and W [vocab, hd]: h and
    W read once, y (and lse, dce) read and the outputs written once,
    against the products at the tensor-core rate (bf16) or the fp32
    rate: one (forward) or three (backward: the logits again, dh, dW)
    of 2*n*vocab*hd operations."""
    io = (n + vocab) * hd * elem      # h and W; dh and dW as much again
    n_bytes = io + 12 * n + (io if bwd else 0)   # y, lse and ce or dce
    flops = (6 if bwd else 2) * n * vocab * hd
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / (PEAK_FLOPS if elem == 2 else PEAK_FLOPS_F32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _ce_library(torch, h, w, y):
    """The saved-logits forward in PyTorch calls: bf16 ``torch.matmul``,
    ``.float()``, ``logsumexp``, ``gather``. The yardstick of rows
    11-12; the port never calls it."""
    logits = torch.matmul(h, w.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, y.clamp_min(0)[:, None])[:, 0]
    return torch.where(y >= 0, lse - gold, torch.zeros_like(lse))


def phase_fused_ce_kernels(torch, timer):
    """Rows 11-12 against their plain versions: at gpt2-small's LM head
    (h [16368, 768], tied W [50257, 768], bf16), the [H, V] layout and
    fp32 at a smaller shape, every 7th label -1; ce and lse within the
    LSE rule, dh and dW by the training rule, ignored rows 0, a repeat
    bitwise equal. Timed at the first shape, each call also by kernel,
    beside the saved-logits forward in PyTorch calls and its
    ``torch.autograd.grad``; there the backward's scratch is measured
    (one call's peak allocation less its outputs) and held to
    ``ce_bwd_plan``'s bytes."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = {name: 0.0 for name, _ in _CE_ROWS}
    rows = {}
    for shape in _CE_SHAPES:
        n, hd, vocab, dtype, vm = shape
        dt = getattr(torch, dtype)

        def make():
            h = torch.randn(n, hd, generator=gen, device=dev).to(dt)
            w = (torch.randn(vocab, hd, generator=gen, device=dev)
                 * 0.02).to(dt)
            y = torch.randint(0, vocab, (n,), generator=gen, device=dev)
            y[::7] = -1
            dce = torch.rand(n, generator=gen, device=dev) / n
            return h, (w if vm else w.t().contiguous()), y, dce

        h, w, y, dce = make()
        lse, ce = fc.ce_fwd(h, w, y, vm)
        dh, dw = fc.ce_bwd(h, w, y, lse, dce, vm)
        again = fc.ce_fwd(h, w, y, vm) + fc.ce_bwd(h, w, y, lse, dce, vm)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((lse, ce, dh, dw),
                                                     again)):
            fail(f"fused CE kernels not bitwise repeatable at "
                 f"{(n, hd, vocab, dtype, vm)}")
        del again
        lse_p, ce_p = fc.ce_fwd_plain(h, w, y, vm)
        dh_p, dw_p = fc.ce_bwd_plain(h, w, y, lse_p, dce, vm)
        e_lse, b_lse = _err(lse, lse_p, LSE_ATOL, LSE_RTOL)
        e_ce, b_ce = _err(ce, ce_p, LSE_ATOL, LSE_RTOL)
        e_dh, b_dh = _err_scaled(dh, dh_p)
        e_dw, b_dw = _err_scaled(dw, dw_p)
        ignored = y < 0
        zero_rows = bool((ce[ignored] == 0).all() and (dh[ignored] == 0).all())
        say("kernel_check", kernel="fused_ce", shape=dict(
            n=n, h=hd, v=vocab, vocab_major=vm), dtype=dtype,
            max_abs_err=dict(lse=e_lse, ce=e_ce, dh=e_dh, dw=e_dw),
            out_of_tol=dict(lse=b_lse, ce=b_ce, dh=b_dh, dw=b_dw),
            ignored_rows_zero=zero_rows, bitwise_repeat=True,
            tol=f"ce, lse {LSE_ATOL}+{LSE_RTOL}*|plain|; dh, dW "
                f"{ULP_BF16}*|plain|+{SCALED_FRAC}*max|plain|")
        if b_lse or b_ce or b_dh or b_dw or not zero_rows:
            fail(f"fused CE kernels disagree with their plain versions at "
                 f"{(n, hd, vocab, dtype, vm)}")
        worst["fused_ce_fwd"] = max(worst["fused_ce_fwd"], e_ce, e_lse)
        worst["fused_ce_bwd"] = max(worst["fused_ce_bwd"], e_dh, e_dw)
        del lse_p, ce_p, dh_p, dw_p, dh, dw
        if shape is not _CE_SHAPES[0]:
            del h, w, y, dce
            torch.cuda.empty_cache()
            continue
        # -- times at the LM head's shape; two input sets: W is 77 MB
        sets = [(h, w, y, dce), make()]
        fwd_args = [(a, b, c, vm) for a, b, c, _ in sets]
        lses = [fc.ce_fwd(*args)[0] for args in fwd_args]
        bwd_args = [(a, b, c, l, d, vm) for (a, b, c, d), l in zip(sets,
                                                                 lses)]
        ms = {"fused_ce_fwd": timer.ms(fc.ce_fwd, fwd_args, n=10),
              "fused_ce_bwd": timer.ms(fc.ce_bwd, bwd_args, n=5)}
        fwd_by_kernel = _kernel_ms(torch, fc.ce_fwd, fwd_args[0], n=3)
        bwd_by_kernel = _kernel_ms(torch, fc.ce_bwd, bwd_args[0], n=3)
        # the backward's scratch, measured: one call's peak above what
        # its inputs hold, less its outputs, against the wrapper's plan
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs = fc.ce_bwd(*bwd_args[0])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        scratch = peak - sum(t.numel() * t.element_size() for t in outs)
        del outs
        planned = fc.ce_bwd_plan(n, vocab, hd, 2)[2]
        if not planned <= scratch <= planned + 2 ** 20:
            fail(f"fused CE backward's scratch {scratch} bytes, planned "
                 f"{planned}")
        plain_ms = {"fused_ce_fwd": timer.ms(fc.ce_fwd_plain, fwd_args, n=3),
                    "fused_ce_bwd": timer.ms(fc.ce_bwd_plain, bwd_args,
                                             n=3)}
        lib_fwd = timer.ms(lambda a, b, c, _: _ce_library(torch, a, b, c),
                           fwd_args, n=10)
        graphs = []
        for a, b, c, d in sets:
            hg = a.detach().requires_grad_()
            wg = b.detach().requires_grad_()
            graphs.append((_ce_library(torch, hg, wg, c), hg, wg, d))
        lib_bwd = timer.ms(lambda out, hg, wg, d: torch.autograd.grad(
            out, (hg, wg), d, retain_graph=True), graphs, n=5)
        del graphs, sets, fwd_args, bwd_args, lses
        torch.cuda.empty_cache()
        lib_ms = {"fused_ce_fwd": lib_fwd, "fused_ce_bwd": lib_bwd}
        for name, replaces in _CE_ROWS:
            bwd = name == "fused_ce_bwd"
            bms, bby = _ce_bound(n, hd, vocab, 2, bwd)
            extra, plan = dict(share_of_bound=bms / ms[name]), {}
            if not bwd:   # one launch: the splits fold in a cluster
                extra.update(ms_by_kernel=fwd_by_kernel)
            else:
                # the backward's products: the logits with d, then dW and
                # dh in one grid; its scratch, d and the dh accumulator
                extra.update(ms_by_kernel=bwd_by_kernel,
                             scratch_bytes=scratch,
                             peak_bytes_over_inputs=peak)
                plan = dict(planned_scratch_bytes=planned)
            say("kernel_time", kernel=name, shape=[n, hd, vocab],
                kernel_ms=ms[name], plain_ms=plain_ms[name],
                library_ms=lib_ms[name], bound_ms=bms, bound_by=bby,
                **extra, **plan)
            rows[name] = dict(
                name=name, route="cuda",
                source="paddle_tpu_torch/csrc/fused_ce.cu",
                replaces=replaces,
                shape="h [16368,768], W [50257,768] bf16 (gpt2-small's LM "
                      "head, b16 s1024)" + (", dh and dW" if bwd else ""),
                ms=ms[name], plain_ms=plain_ms[name], bound_ms=bms,
                bound_by=bby, library_ms=lib_ms[name], **extra)
        del h, w, y, dce
        torch.cuda.empty_cache()
    for name, _ in _CE_ROWS:
        rows[name]["max_abs_err"] = worst[name]
    return rows


#: gpt2-small's cached-forward products (name, K, N): 12 each of the
#: first four a forward, and the tied head once
_ROW_SHAPES = (("qkv", 768, 2304), ("out_proj", 768, 768),
               ("fc1", 768, 3072), ("fc2", 3072, 768),
               ("lm_head", 768, 50257))
#: row counts held: one token, a batch-1 verify window, a decode step, an
#: 8-slot verify window, both sides of the 64-row tile's edges, a prefill
#: bucket, a batch-8 bucket-512 prefill
_ROW_COUNTS = (1, 5, 8, 40, 63, 64, 65, 127, 128, 129, 512, 4096)
#: single rows held against the 4096-row run: inside, at and past the
#: edges of 64-row tiles, the last
_ROW_ALONE = (0, 5, 37, 63, 64, 65, 127, 128, 129, 4095)
#: the other products held (name, K, N), on a 520-row run, in both W
#: layouts with and without a bias in each dtype: gpt2-small's fc2 and
#: qkv, K and N ragged to the tile and the TMA box (multiples of 8: the
#: warpgroup route) and ragged to 8 (the CUDA-core route)
_ROW_EXTRA = (("fc2", 3072, 768), ("qkv_head_layout", 768, 2304),
              ("ragged_box", 200, 328), ("ragged_8", 60, 37))
_ROW_EXTRA_COUNTS = (1, 5, 8, 63, 64, 65, 129, 512)
_ROW_EXTRA_ALONE = (0, 63, 64, 65, 519)


def _row_operands(torch, gen, name, k, n, dtype):
    """(w, b) of one product: Paddle's [K, N] Linear weight and bias, or
    for the head the transposed view of a [V, H] embedding, no bias."""
    dev = torch.device("cuda", 0)

    def randn(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            dtype)
    if name == "lm_head":
        return randn(n, k).t(), None
    return randn(k, n), randn(n)


def _host_us(torch, fn, sets, n=400):
    """Host microseconds to issue one call of ``fn`` (the card runs
    behind: at a decode step's size every call here is host-bound)."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*sets[i % len(sets)])
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _row_invariance(torch, rl, x, w, b, counts, alone, tol):
    """Hold ``row_linear`` on x's rows: within ``tol`` of the plain
    version at each row count, each count's rows equal to the same rows
    of the whole run, the rows of ``alone`` alone too, and the whole run
    repeating bit for bit. Returns (worst error, out-of-tolerance count,
    per-count equal, per-row equal, repeat)."""
    full = rl.row_linear(x, w, b)
    repeat = bool(torch.equal(rl.row_linear(x, w, b), full))
    same, errs, bad = [], [], 0
    for m in counts:
        y = full if m == x.shape[0] else rl.row_linear(x[:m], w, b)
        same.append(bool(torch.equal(y, full[:m])))
        err, n_bad = _err(y, rl.row_linear_plain(x[:m], w, b), *tol)
        errs.append(err)
        bad += n_bad
    one = [bool(torch.equal(rl.row_linear(x[r:r + 1], w, b), full[r:r + 1]))
           for r in alone]
    return max(errs), bad, same, one, repeat


def phase_row_gemm_kernels(torch, timer):
    """row_gemm (``kernels/row_linear.py``, ``csrc/row_gemm.cu``: the
    cached forward's x @ W + b, ROADMAP C12) at gpt2-small's five product
    shapes in bf16: at each row count of ``_ROW_COUNTS`` within the
    serving rule of its plain version, and bit for bit row-invariant
    (each count's rows equal the same rows of the 4096-row run, and the
    rows of ``_ROW_ALONE`` alone do too, and the run repeats bit for
    bit); then ``_ROW_EXTRA``: both W layouts with and without a bias in
    bf16, fp16 and fp32 (each within its rule: the serving rule, or
    ``F32_ATOL``/``F32_RTOL``), ragged K and N, and a row view at an
    address TMA cannot take, the same way on 520 rows. Then timed at a
    decode step (M 8) and a bucket-512 prefill (M 512) beside the plain
    version and one cuBLAS call (``F.linear``; ``torch.matmul`` for the
    head), each call on a weight not left in L2 by the one before, with
    host microseconds a call at M 8. The kernel row is one decode step's
    49 products (12 x 4 Linears and the head)."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import row_linear as rl
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    bf16 = torch.bfloat16
    serving = (KERNEL_ATOL, KERNEL_RTOL)
    worst = 0.0

    def plan_of(w):
        p = rl.plan_for(w)
        return dict(route=p.route, tile=list(p.tile), splits=p.splits)

    for name, k, n in _ROW_SHAPES:
        w, b = _row_operands(torch, gen, name, k, n, bf16)
        x = torch.randn((4096, k), generator=gen, device=dev).to(bf16)
        err, n_bad, same, alone, repeat = _row_invariance(
            torch, rl, x, w, b, _ROW_COUNTS, _ROW_ALONE, serving)
        worst = max(worst, err)
        say("kernel_check", kernel="row_gemm", product=name, k=k, n=n,
            dtype="bfloat16", **plan_of(w),
            rows=list(_ROW_COUNTS), max_abs_err=err, out_of_tol=n_bad,
            tol=f"{KERNEL_ATOL}+{KERNEL_RTOL}*|plain|",
            rows_equal_the_4096_row_run=same, rows_alone=list(_ROW_ALONE),
            row_alone_equal=alone, repeats_bitwise=repeat)
        if n_bad:
            fail(f"row_gemm {name}: {n_bad} elements beyond the serving rule")
        if not (all(same) and all(alone) and repeat):
            fail(f"row_gemm {name}: a row's bits depend on the row count: "
                 f"{same}, {alone}, repeat {repeat}")
        del x
    extra = []
    for dtype, tol in ((bf16, serving), (torch.float16, serving),
                       (torch.float32, (F32_ATOL, F32_RTOL))):
        for name, k, n in _ROW_EXTRA:
            for layout, bias in (("kn", True), ("kn", False),
                                 ("head", False), ("head", True)):
                w, _ = _row_operands(torch, gen, "lm_head" if layout ==
                                     "head" else name, k, n, dtype)
                b = torch.randn((n,), generator=gen, device=dev).to(
                    dtype) if bias else None
                x = torch.randn((520, k), generator=gen, device=dev).to(dtype)
                err, n_bad, same, alone, repeat = _row_invariance(
                    torch, rl, x, w, b, _ROW_EXTRA_COUNTS, _ROW_EXTRA_ALONE,
                    tol)
                ok = not n_bad and all(same) and all(alone) and repeat
                extra.append(dict(product=name, k=k, n=n, layout=layout,
                                  bias=bias, dtype=str(dtype).split(".")[-1],
                                  **plan_of(w),
                                  max_abs_err=err, ok=ok))
                if not ok:
                    fail(f"row_gemm {name} {layout} bias={bias} {dtype}: "
                         f"{n_bad} beyond {tol}, counts {same}, alone "
                         f"{alone}, repeat {repeat}")
    # a row view at a 2-byte offset: copied, then the layer's one route
    flat = torch.randn((9 * 768 + 1,), generator=gen, device=dev).to(bf16)
    view = flat[1:].view(9, 768)
    w, b = _row_operands(torch, gen, "qkv", 768, 2304, bf16)
    y = rl.row_linear(view, w, b)
    unaligned_equal = bool(torch.equal(y, rl.row_linear(view.clone(), w, b)))
    err, n_bad = _err(y, rl.row_linear_plain(view, w, b))
    say("kernel_check", kernel="row_gemm", cases=extra,
        counts=list(_ROW_EXTRA_COUNTS), alone=list(_ROW_EXTRA_ALONE),
        unaligned_view_offset_bytes=view.data_ptr() % 16,
        unaligned_view_equal_aligned=unaligned_equal,
        unaligned_view_max_abs_err=err)
    if n_bad or not unaligned_equal:
        fail(f"row_gemm on an unaligned view: {n_bad} beyond the rule, "
             f"equal to the aligned copy {unaligned_equal}")
    timings = {}
    for m in (8, 512):
        for name, k, n in _ROW_SHAPES:
            wb = k * n * 2
            sets = []
            for _ in range(max(2, -(-(64 << 20) // wb))):
                w, b = _row_operands(torch, gen, name, k, n, bf16)
                sets.append((torch.randn((m, k), generator=gen,
                                         device=dev).to(bf16), w, b))
            ms = timer.ms(rl.row_linear, sets)
            host_us = _host_us(torch, rl.row_linear, sets) if m == 8 \
                else None
            lib_host_us = _host_us(torch, lambda x, w, b: (
                torch.matmul(x, w) if b is None
                else TF.linear(x, w.t(), b)), sets) if m == 8 else None
            plain_ms = timer.ms(rl.row_linear_plain, sets, n=10)
            if name == "lm_head":
                lib_ms = timer.ms(lambda x, w, b: torch.matmul(x, w), sets)
            else:
                lib_ms = timer.ms(lambda x, w, b: TF.linear(x, w.t(), b),
                                  sets)
            n_bytes = 2 * (m * k + k * n + m * n + (0 if name == "lm_head"
                                                    else n))
            bms, by = bound_ms(n_bytes, 2 * m * n * k)
            timings[(m, name)] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=lib_ms, bound_ms=bms,
                                      bound_by=by, host_us=host_us,
                                      library_host_us=lib_host_us)
            say("kernel_time", kernel="row_gemm", product=name, m=m, k=k,
                n=n, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, **plan_of(w),
                host_us_per_call=host_us, library_host_us_per_call=lib_host_us)
            del sets

    def step(m, key):
        t = timings
        return 12 * sum(t[(m, nm)][key] for nm, _, _ in _ROW_SHAPES[:4]) \
            + t[(m, "lm_head")][key]
    row = dict(
        name="row_gemm", route="cuda",
        source="paddle_tpu_torch/csrc/row_gemm.cu",
        replaces="none: XLA's GEMM in paddle_tpu/nn/functional/common.py:12"
                 " (row-invariant products, ROADMAP C12)",
        shape="one decode step's 49 products at M 8: 12 x (768x2304, "
              "768x768, 768x3072, 3072x768) + head 768x50257, bf16",
        max_abs_err=worst, ms=step(8, "ms"), plain_ms=step(8, "plain_ms"),
        bound_ms=step(8, "bound_ms"), bound_by="bytes",
        library_ms=step(8, "library_ms"),
        prefill_m512=dict(ms=step(512, "ms"),
                          plain_ms=step(512, "plain_ms"),
                          library_ms=step(512, "library_ms"),
                          bound_ms=step(512, "bound_ms")),
        host_us_per_call=[f(t["host_us"] for (m, _), t in timings.items()
                            if m == 8) for f in (min, max)],
        library_host_us_per_call=[
            f(t["library_host_us"] for (m, _), t in timings.items()
              if m == 8) for f in (min, max)],
        by_product={f"{name}_m{m}": v for (m, name), v in timings.items()})
    say("kernel_time", kernel="row_gemm", kernel_ms=row["ms"],
        plain_ms=row["plain_ms"], library_ms=row["library_ms"],
        bound_ms=row["bound_ms"], bound_by="bytes", shape=row["shape"],
        prefill_m512=row["prefill_m512"],
        host_us_per_call=row["host_us_per_call"],
        library_host_us_per_call=row["library_host_us_per_call"])
    return {"row_gemm": row}


def phase_head_dims(torch):
    """Head dims the kernels are not built for (80, as a 2560-wide model
    over 32 heads has) take the JAX package's XLA routes on the card, as
    in the reference: ``F.scaled_dot_product_attention`` through
    ``sdpa_xla`` (with its autograd backward) and a
    decode and a chunk window of ``cached_attention`` through
    ``decode_xla``, each against the same call on the CPU, with no kernel
    launch and no plain-version call."""
    from paddle_tpu_torch.generation.attention import cached_attention
    from paddle_tpu_torch.generation.kv_cache import KVCache
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional.attention import sdpa_xla
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, s, h, d = 2, 200, 16, 80
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               for _ in range(3))
    fa.reset_counts()
    sdpa_xla.calls = 0
    errs = {}
    qg = q.clone().requires_grad_()
    out = F.scaled_dot_product_attention(qg, k, v, is_causal=True)
    out.square().sum().backward()
    qc = q.cpu().requires_grad_()
    ref = F.scaled_dot_product_attention(qc, k.cpu(), v.cpu(),
                                         is_causal=True)
    ref.square().sum().backward()
    errs["sdpa"] = float((out.detach().cpu() - ref.detach()).abs().max())
    errs["sdpa_dq"] = float((qg.grad.cpu() - qc.grad).abs().max())
    for window in (4, 128):
        outs = []
        for device in (dev, torch.device("cpu")):
            cache = KVCache.create(1, b, 640, h, d, device=device)
            cache.k[0, :, :400] = k.repeat(1, 2, 1, 1).to(device)
            cache.v[0, :, :400] = v.repeat(1, 2, 1, 1).to(device)
            cache.kv_len.fill_(300)
            outs.append(cached_attention(
                q[:, :window].to(device), k[:, :window].to(device),
                v[:, :window].to(device), cache, 0, decode=True,
                causal=True)[0])
        errs[f"decode_window_{window}"] = float(
            (outs[0].cpu() - outs[1]).abs().max())
    torch.cuda.synchronize()
    launches = (fa.flash_attention.launches + fa.flash_attention_bwd.launches
                + fa.flash_attention_decode.launches
                + fa.flash_attention_chunk.launches)
    plain = (fa.flash_attention_plain.calls
             + fa.flash_attention_bwd_plain.calls
             + fa.flash_attention_decode_plain.calls
             + fa.flash_attention_chunk_plain.calls)
    say("head_dims", head_dim=d, max_abs_err_vs_cpu=errs,
        tol="1e-3 absolute (fp32 sums in another order)",
        sdpa_xla_calls=sdpa_xla.calls,
        decode_xla_calls=fa.decode_xla.calls, kernel_launches=launches,
        plain_calls=plain)
    if launches or plain or sdpa_xla.calls != 2 or fa.decode_xla.calls != 4:
        fail(f"head_dim {d} reached a kernel or a plain version "
             f"({launches} launches, {plain} plain calls)")
    if not all(e <= 1e-3 for e in errs.values()):
        fail(f"head_dim {d} on the card differs from the CPU: {errs}")


def phase_model(torch):
    """gpt2-small in bf16: a bucket-512 prefill of two ragged prompts
    plus 8 teacher-forced decode steps, through the kernels (rows 1 and
    5, row_gemm 49 times a forward) and through the plain versions,
    logits compared."""
    import paddle_tpu_torch.generation.attention as cached_mod
    import paddle_tpu_torch.nn.functional.attention as sdpa_mod
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import row_linear
    from paddle_tpu_torch.models.gpt import gpt
    dev = torch.device("cuda", 0)
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(SEED)
    ids = torch.as_tensor(rng.randint(0, vocab, (2, 512)), device=dev)
    plen = torch.tensor([512, 300], device=dev)
    steps = torch.as_tensor(rng.randint(0, vocab, (8, 2)), device=dev)

    def run():
        with torch.no_grad():
            logits, cache = model(ids, use_cache=True, prompt_len=plen,
                                  cache_max_len=640)
            out = [logits.float()]
            for tok in steps:
                logits, cache = model(tok[:, None], cache=cache)
                out.append(logits.float())
        return torch.cat(out, dim=1)

    _reset_counts(fa)
    kern = run()
    launched = (fa.flash_attention.launches,
                fa.flash_attention_decode.launches,
                row_linear.row_linear.launches)
    with mock.patch.object(sdpa_mod, "flash_attention",
                           fa.flash_attention_plain), \
            mock.patch.object(cached_mod, "flash_attention_decode",
                              fa.flash_attention_decode_plain), \
            mock.patch.object(row_linear, "row_linear",
                              row_linear.row_linear_plain):
        plain = run()
    torch.cuda.synchronize()
    if kern.shape != (2, 9, vocab) or not torch.isfinite(kern).all():
        fail(f"model logits: shape {tuple(kern.shape)} or non-finite")
    diff = float((kern - plain).abs().max())
    say("model", config="gpt2-small", dtype="bfloat16",
        params=model.num_params(), prefill=[2, 512], prompt_len=[512, 300],
        decode_steps=8, kernel_launches=list(launched),
        max_abs_logit_diff=diff, tol=LOGIT_TOL,
        logit_spread=float(kern.std()))
    if launched != (12, 12 * 8, ROW_GEMM_PER_FORWARD * 9):
        fail(f"model kernel launches {launched}, expected (12, 96, 441)")
    if diff > LOGIT_TOL:
        fail(f"kernel and plain logits differ by {diff} > {LOGIT_TOL}")
    return model


def _serve_prompts(model):
    """16 prompts with lengths drawn from 16..500 (seed 1)."""
    rng = np.random.RandomState(SEED + 1)
    vocab = model.cfg.vocab_size
    return [rng.randint(0, vocab, n) for n in rng.randint(16, 501, 16)]


def _shared_prompts(model):
    """8 prompts that share a 256-token prefix (two full 128-token
    pages), total lengths 300-500 (seed 4)."""
    rng = np.random.RandomState(SEED + 4)
    vocab = model.cfg.vocab_size
    prefix = rng.randint(0, vocab, 256)
    return [np.r_[prefix, rng.randint(0, vocab, n - 256)]
            for n in rng.randint(300, 501, 8)]


def _spec_config():
    from paddle_tpu_torch.generation import SpeculativeConfig
    return SpeculativeConfig(mode="ngram", k=SPEC_K, ngram=SPEC_NGRAM)


def _serve_config(model, speculative=None, precision="bfloat16",
                  **serving):
    from paddle_tpu_torch.inference import Config
    return (Config().from_layer(model).enable_use_gpu(precision)
            .enable_generation(max_new_tokens=64, prefill_buckets=(128, 512),
                               max_batch=8, speculative=speculative)
            .enable_serving(max_queue=64, poll_every=4, **serving))


#: row_gemm launches of one cached gpt2-small forward: 12 layers x 4
#: Linears, and the tied LM head
ROW_GEMM_PER_FORWARD = 49


def _reset_counts(fa):
    """Zero the flash kernels' and row_linear's counters."""
    from paddle_tpu_torch.kernels import row_linear
    fa.reset_counts()
    row_linear.reset_counts()


def _counts(fa):
    """Launches by kernel (wide and int8 modes apart, row_gemm beside
    the attention kernels) and the plain versions' calls, since the last
    ``_reset_counts``."""
    from paddle_tpu_torch.kernels import row_linear
    decode_shaped = {"flash_decode": fa.flash_attention_decode,
                     "flash_decode_paged": fa.flash_attention_decode_paged,
                     "flash_chunk": fa.flash_attention_chunk}
    launches = {"flash_fwd": fa.flash_attention.launches}
    for name, fn in decode_shaped.items():
        launches[name] = fn.launches
    for name, fn in decode_shaped.items():
        launches[name + "_int8"] = fn.launches_int8
    launches["row_gemm"] = row_linear.row_linear.launches
    plain = fa.flash_attention_plain.calls + row_linear.row_linear_plain.calls
    for fn in (fa.flash_attention_decode_plain,
               fa.flash_attention_decode_paged_plain,
               fa.flash_attention_chunk_plain):
        plain += fn.calls + fn.calls_int8
    return launches, plain


def _row_gate(what, launches, per_forward=ROW_GEMM_PER_FORWARD):
    """Every cached gpt2-small forward launches 12 attention kernels (one
    a layer: prefill, chunk, decode step or verify window) and
    ``per_forward`` row_gemm products: fail unless the counts agree.
    Returns the forwards counted."""
    attn = sum(n for k, n in launches.items() if k != "row_gemm")
    forwards = attn // 12
    if attn % 12 or launches.get("row_gemm") != per_forward * forwards:
        fail(f"{what}: {launches.get('row_gemm')} row_gemm launches for "
             f"{attn} attention launches ({per_forward} a forward "
             f"expected)")
    return forwards


def _serve(torch, engine, work):
    """Serve every (prompt, params) list in ``work`` through ``engine``
    with the launch counters zeroed first; returns (handles, wall
    seconds, launches, plain calls)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    torch.cuda.synchronize()
    _reset_counts(fa)
    t0 = time.perf_counter()
    handles = []
    for items in work:
        handles += engine.serve_forever(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (handles, wall) + _counts(fa)


def _check_served(engine, handles, wall, launches, plain_calls, ran, what,
                  **fields):
    """Print the phase line (throughput, latencies, launches, plain calls,
    int8 clips, cache MB) and fail unless every request completed with
    its 64 tokens, exactly the kernels in ``ran`` decoded (flash_fwd may
    run beside them), every cached forward launched row_gemm 49 times
    (``_row_gate``), no plain version ran and no int8 value
    saturated."""
    from paddle_tpu_torch.serving import RequestStatus
    done = [h for h in handles if h.status is RequestStatus.COMPLETED
            and h.tokens is not None and h.tokens.size == 64]
    clips = getattr(engine._cache, "clips", None)
    clips = None if clips is None else int(clips)
    say(what, requests=len(handles), completed=len(done),
        kv_cache_dtype=engine.cache_dtype, wall_s=wall,
        tokens_per_s=len(done) * 64 / wall,
        p50_ttft_ms=float(np.median([h.ttft for h in handles])) * 1e3,
        p50_per_token_ms=float(np.median([h.per_token_latency
                                          for h in handles])) * 1e3,
        decode_steps=engine.stats["decode_steps"], launches=launches,
        plain_calls=plain_calls, clips=clips, cache_mb=_cache_mb(engine),
        stats=engine.stats, **fields)
    if len(done) != len(handles):
        fail(f"{what}: {len(handles) - len(done)} of {len(handles)} "
             "requests did not complete with their full budget")
    bad = [k for k, n in launches.items()
           if (k in ran and n == 0) or (k not in ran and n and k not in (
               "flash_fwd", "row_gemm"))]
    if bad or launches["flash_fwd"] == 0:
        fail(f"{what} launches {launches}")
    _row_gate(what, launches)
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times on the {what} path")
    if clips:
        fail(f"{what}: {clips} int8 values saturated (absmax scales never "
             "do)")


def _cache_mb(engine):
    """The engine cache's bytes in MB (host arithmetic over its shapes):
    the values, the int8 scales, and the values at the model's width."""
    c = engine._cache
    width = next(engine.network.parameters()).element_size()
    mb = dict(values=2 * c.k.numel() * c.k.element_size() / 1e6,
              wide_values=2 * c.k.numel() * width / 1e6)
    if getattr(c, "k_scale", None) is not None:
        mb["scales"] = 2 * c.k_scale.numel() * c.k_scale.element_size() / 1e6
    return mb


def phase_serve(torch, model, prompts, decode_ms, kv_cache_dtype=None):
    """The 16 requests through ServingEngine on its dense cache (full
    width, or int8): every request completes with its budget, its first
    token equals a batch-1 prefill of the same bucket-padded prompt, the
    first 8 streams equal sequential batch-1 ``generate`` bit for bit,
    12 decode launches a step in the cache's mode and no other
    decode-shaped kernel, no plain version; then a decode-step
    profile."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.generation.api import GenerationConfig
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    sfx = "" if kv_cache_dtype is None else "_" + kv_cache_dtype
    engine = ServingEngine(_serve_config(model,
                                         kv_cache_dtype=kv_cache_dtype))
    handles, wall, launches, plain_calls = _serve(
        torch, engine, [[(p, RequestParams(max_new_tokens=64))
                         for p in prompts]])
    steps = engine.stats["decode_steps"]
    # the first token of every request must equal a batch-1 greedy
    # prefill of the same bucket-padded prompt, and a whole stream that
    # of a batch-1 generate (same shapes, same kernels: bitwise)
    first, sequential = 0, []
    for i, (p, h) in enumerate(zip(prompts, handles)):
        bucket = next(bk for bk in engine.buckets if bk >= p.size)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :p.size] = p
        tok, _, _ = engine._session.prefill(
            torch.as_tensor(ids, device=engine.device),
            torch.tensor([p.size], device=engine.device),
            GenerationConfig(), engine.max_len)
        first += int(tok.item() != int(h.tokens[0]))
        if i < 8:
            ref = generate(model, ids, 64, prompt_len=[p.size],
                           cache_max_len=engine.max_len,
                           kv_cache_dtype=kv_cache_dtype).cpu().numpy()[0]
            if not np.array_equal(ref, h.tokens):
                sequential.append(dict(request=i, first_differing_token=int(
                    np.argmax(ref != h.tokens))))
    decode = "flash_decode" + sfx
    _check_served(engine, handles, wall, launches, plain_calls, (decode,),
                  "serve" + sfx, prompt_lens=[int(p.size) for p in prompts],
                  decode_launches_per_step=launches[decode] / max(steps, 1),
                  first_token_mismatches=first,
                  streams_differing_from_sequential_generate=sequential)
    if launches[decode] != 12 * steps or \
            launches["flash_fwd"] != 12 * engine.stats["prefills"]:
        fail(f"serve{sfx}: launches {launches} for {steps} decode steps")
    if first:
        fail(f"{first} first tokens differ from batch-1 prefill")
    if sequential:
        fail(f"streams differ from sequential generate: {sequential}")
    _decode_step_profile(torch, engine, prompts[8:], decode_ms,
                         "dense" + sfx)
    return launches, handles


def _decode_step_profile(torch, engine, prompts, attention_ms, cache):
    """Where a decode step's time goes, all 8 slots live: the wall time
    of a step (the host issues 500-1000 launches, so the spin-kernel
    timer does not apply) against the device time its kernels take,
    ``row_gemm``'s part of it, and the tokens a slot emits a step over
    the timed steps (1 without speculation, up to k + 1 with it)."""
    from paddle_tpu_torch.serving import RequestParams
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        engine.submit(p, RequestParams(max_new_tokens=64))
    engine.step()                           # admits all 8
    n = 8
    live = sum(s is not None for s in engine._slots)
    torch.cuda.synchronize()
    emitted = int(engine._steps.sum())
    t0 = time.perf_counter()
    for _ in range(n):
        engine._dispatch_decode()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    emitted = int(engine._steps.sum()) - emitted
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine._dispatch_decode()
        torch.cuda.synchronize()
    # device-side events (kernels, copies) carry no host time
    dev = [e for e in prof.key_averages()
           if e.device_time_total > 0 and e.cpu_time_total == 0]
    busy_ms = sum(e.device_time_total for e in dev) / (1e3 * n)
    row_ms = sum(e.device_time_total for e in dev
                 if "row_gemm" in e.key) / (1e3 * n)
    top = sorted(dev, key=lambda e: -e.device_time_total)[:8]
    say("decode_step", cache=cache, live_slots=live,
        tokens_per_slot_step=emitted / (n * live), wall_ms=wall_ms,
        device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        row_gemm_ms=row_ms, row_gemm_share_of_busy=row_ms / busy_ms,
        launches_per_step=sum(e.count for e in dev) / n,
        attention_kernel_ms=engine.network.cfg.num_layers * attention_ms,
        top_kernels=[dict(name=e.key[:48], ms_per_step=e.device_time_total
                          / (1e3 * n), calls_per_step=e.count / n)
                     for e in top])
    while engine.busy:
        engine.step()


def phase_serve_paged(torch, model, prompts, dense_handles, paged_ms,
                      kv_cache_dtype=None):
    """The engine on a paged cache (page 128, default pool; full width or
    int8): the 16 prompts of the dense serve run, then 8 requests that
    share a 256-token prefix (two full pages) with total lengths 300-500,
    all in bucket 512. Every token stream equals the dense engine's of
    the same cache dtype; prefix pages are shared; pages are conserved,
    none in use after the drain; every decode step runs 12 paged decode
    launches in the cache's mode and nothing else decode-shaped."""
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    sfx = "" if kv_cache_dtype is None else "_" + kv_cache_dtype
    engine = ServingEngine(_serve_config(model, paged=True, kv_page_size=128,
                                         kv_cache_dtype=kv_cache_dtype))
    shared = _shared_prompts(model)
    params = RequestParams(max_new_tokens=64)
    handles, wall, launches, plain_calls = _serve(
        torch, engine, [[(p, params) for p in prompts],
                        [(p, params) for p in shared]])
    steps, prefills = engine.stats["decode_steps"], engine.stats["prefills"]
    dense = ServingEngine(_serve_config(model, kv_cache_dtype=kv_cache_dtype))
    reference = list(dense_handles) + dense.serve_forever(
        (p, params) for p in shared)
    mismatch = sum(not np.array_equal(h.tokens, r.tokens)
                   for h, r in zip(handles, reference))
    engine._alloc.assert_conserved()
    stats = dict(engine._alloc.stats)
    paged = "flash_decode_paged" + sfx
    _check_served(engine, handles, wall, launches, plain_calls, (paged,),
                  "serve" + sfx + "_paged", page_size=engine.page_size,
                  pool_pages=engine._alloc.n_pages,
                  shared_prefix_lens=[int(p.size) for p in shared],
                  paged_launches_per_step=launches[paged] / max(steps, 1),
                  token_streams_differing_from_dense=mismatch,
                  allocator=stats,
                  pages_in_use_after_drain=engine._alloc.used_pages())
    if mismatch:
        fail(f"{mismatch} paged token streams differ from the dense engine")
    if stats["prefix_hits"] < 1 or engine._alloc.used_pages():
        fail(f"paged allocator {stats}, {engine._alloc.used_pages()} pages "
             "in use after the drain")
    if launches[paged] != 12 * steps or launches["flash_fwd"] != 12 * prefills:
        fail(f"paged serve launches {launches} for {steps} decode steps and "
             f"{prefills} prefills")
    _decode_step_profile(torch, engine, prompts[8:], paged_ms, "paged" + sfx)
    engine._alloc.assert_conserved()
    return launches, handles


def phase_serve_chunked(torch, model, prompts, kv_cache_dtype=None):
    """The paged engine with prefill_chunk_tokens=128 on the 16 prompts
    (full width or int8): all complete; prompts of 128 tokens or less
    prefill inline through flash_fwd, longer ones chunk by chunk through
    the chunk kernel in the cache's mode (12 launches a chunk, the final
    chunk included); no plain version; pages conserved. Then, for 4
    prompts longer than 128, the logits at the last prompt position of a
    chunked prefill against those of the inline bucket prefill."""
    from paddle_tpu_torch.generation.kv_cache import KVCache
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    sfx = "" if kv_cache_dtype is None else "_" + kv_cache_dtype
    C = 128
    engine = ServingEngine(_serve_config(model, paged=True, kv_page_size=128,
                                         prefill_chunk_tokens=C,
                                         kv_cache_dtype=kv_cache_dtype))
    params = RequestParams(max_new_tokens=64)
    handles, wall, launches, plain_calls = _serve(
        torch, engine, [[(p, params) for p in prompts]])
    chunks = engine.stats["prefill_chunks"]
    n_short = sum(int(p.size <= C) for p in prompts)
    expect_chunks = sum(-(-int(p.size) // C) for p in prompts if p.size > C)
    engine._alloc.assert_conserved()

    # chunked against inline prefill, at the model, for 4 long prompts
    dev = engine.device
    diffs = []
    with torch.no_grad():
        for p in [p for p in prompts if p.size > C][:4]:
            n = -(-int(p.size) // C)
            ids = np.zeros((1, 512), np.int64)
            ids[0, :p.size] = p
            ids_t = torch.as_tensor(ids, device=dev)
            plen = torch.tensor([p.size], device=dev)
            inline, _ = model(ids_t, use_cache=True, prompt_len=plen,
                              cache_max_len=engine.max_len,
                              cache_dtype=kv_cache_dtype)
            mc = model.cfg
            cache = KVCache.create(mc.num_layers, 1, engine.max_len,
                                   mc.num_heads,
                                   mc.hidden_size // mc.num_heads,
                                   dtype=inline.dtype, device=dev,
                                   cache_dtype=kv_cache_dtype)
            for k in range(n):
                kw = dict(prompt_len=plen) if k == n - 1 else {}
                chunked, cache = model(ids_t[:, k * C:(k + 1) * C],
                                       cache=cache, **kw)
            diffs.append(float((chunked.float() - inline.float())
                               .abs().max()))
    chunk = "flash_chunk" + sfx
    _check_served(engine, handles, wall, launches, plain_calls,
                  (chunk, "flash_decode_paged" + sfx),
                  "serve" + sfx + "_chunked",
                  chunk_tokens=C, inline_prompts=n_short,
                  prefill_chunks=chunks, expected_chunks=expect_chunks,
                  pages_in_use_after_drain=engine._alloc.used_pages(),
                  chunked_vs_inline_max_logit_diff=diffs, tol=LOGIT_TOL)
    if chunks != expect_chunks or launches[chunk] != 12 * chunks:
        fail(f"chunked serve: {chunks} chunks (expected {expect_chunks}), "
             f"{chunk} launches {launches[chunk]}")
    if launches["flash_fwd"] != 12 * n_short:
        fail(f"chunked serve launches {launches} with {n_short} inline "
             "prompts")
    if engine._alloc.used_pages():
        fail("chunked serve left pages in use after the drain")
    if len(diffs) != 4 or max(diffs) > LOGIT_TOL:
        fail(f"chunked and inline prefill logits differ by {diffs}")
    return launches, handles


def _near_ties(torch, model, prompts, got, ref, max_len, kv_cache_dtype):
    """Each speculative stream of ``got`` that differs from its
    non-speculative stream in ``ref``: the first differing position j and
    the sequential model's logits there, teacher-forced (a batch-1 bucket
    prefill of the prompt, then one decode step a token of ``ref[:j]``,
    on the same cache dtype): the gap between the logits of the two
    tokens chosen, and its top-1/top-2 gap. Every gate that calls it is
    bitwise: with the cached forward's products on row_gemm, a row's
    bits depend neither on the batch nor on the verify window
    (``experiments/serve_batch_invariance.py --spec``: window rows equal
    Sq = 1 rows in the decode kernel too), so a parting stream is a
    fault, and this says where it parted and by how much."""
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for i, (p, a, b) in enumerate(zip(prompts, got, ref)):
            a, b = np.asarray(a), np.asarray(b)
            if np.array_equal(a, b):
                continue
            n = min(a.size, b.size)
            diff = np.nonzero(a[:n] != b[:n])[0]
            j = int(diff[0]) if diff.size else n
            if j == n:                    # one stream stops early
                out.append(dict(request=i, position=j, gap=float("inf")))
                continue
            ids = np.zeros((1, 128 if p.size <= 128 else 512), np.int64)
            ids[0, :p.size] = p
            logits, cache = model(torch.as_tensor(ids, device=dev),
                                  use_cache=True,
                                  prompt_len=torch.tensor([p.size],
                                                          device=dev),
                                  cache_max_len=max_len,
                                  cache_dtype=kv_cache_dtype)
            for t in b[:j]:
                logits, cache = model(torch.tensor([[int(t)]], device=dev),
                                      cache=cache)
            lg = logits[0, -1].float()
            top = lg.topk(2).values
            out.append(dict(request=i, position=j, sequential=int(b[j]),
                            speculative=int(a[j]),
                            gap=abs(float(lg[int(b[j])] - lg[int(a[j])])),
                            top1_top2_gap=float(top[0] - top[1])))
    return out


def _spec_fields(engine, handles):
    """The speculative engine's counters: verify windows, proposals to
    live slots, acceptances, and the tokens a slot emits a window."""
    st = engine.stats
    prop, acc = st["spec_proposed"], st["spec_accepted"]
    decoded = sum(int(h.tokens.size) - 1 for h in handles)
    return dict(verify_windows=st["decode_steps"], spec_proposed=prop,
                spec_accepted=acc, acceptance_rate=acc / max(prop, 1),
                tokens_per_window=decoded / max(prop / SPEC_K, 1),
                tokens_per_dispatch=decoded / max(st["decode_steps"], 1))


def _gate_spec(what, engine, ties):
    """Acceptances, and every stream equal to its non-speculative one
    (``ties`` lists, with its logit gap, each that parts)."""
    if engine.stats["spec_accepted"] <= 0:
        fail(f"{what}: no draft token was accepted "
             f"({engine.stats['spec_proposed']} proposed)")
    if ties:
        fail(f"{what}: streams part from the non-speculative ones: {ties}")


def _batch1_spec_generate(model, prompts, engine, spec, kv_cache_dtype):
    """Each prompt alone through ``generate(speculative=spec)`` at the
    engine's bucket and cache length: the batch-1 streams."""
    from paddle_tpu_torch.generation import generate
    out = []
    for p in prompts:
        bucket = next(bk for bk in engine.buckets if bk >= p.size)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :p.size] = p
        out.append(generate(model, ids, 64, prompt_len=[p.size],
                            cache_max_len=engine.max_len,
                            kv_cache_dtype=kv_cache_dtype,
                            speculative=spec).cpu().numpy()[0])
    return out


def phase_serve_spec(torch, model, prompts, seq_handles, window_ms,
                     kv_cache_dtype=None):
    """The 16 requests through the speculative dense engine (ngram, k 4;
    full width or int8): every request completes with its budget, 12
    decode launches a verify window in the cache's mode and no other
    decode-shaped kernel, 12 forward launches a prefill, row_gemm 49 a
    forward, no plain version, acceptances; each of the first 8 streams
    equals batch-1 ``generate(speculative=...)`` bit for bit (40 rows in
    the engine's window against 5 in batch-1's: row_gemm gives a row the
    same bits at either count, ROADMAP C12); each stream equals the
    non-speculative serve's bit for bit (a window row gets a one-row
    step's bits); then the speculative decode-step profile."""
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    sfx = "" if kv_cache_dtype is None else "_" + kv_cache_dtype
    what = "serve_spec" + sfx
    spec = _spec_config()
    engine = ServingEngine(_serve_config(model, speculative=spec,
                                         kv_cache_dtype=kv_cache_dtype))
    handles, wall, launches, plain_calls = _serve(
        torch, engine, [[(p, RequestParams(max_new_tokens=64))
                         for p in prompts]])
    steps = engine.stats["decode_steps"]
    batch1 = _batch1_spec_generate(model, prompts[:8], engine, spec,
                                   kv_cache_dtype)
    batch1_ties = _near_ties(torch, model, prompts[:8],
                             [h.tokens for h in handles[:8]], batch1,
                             engine.max_len, kv_cache_dtype)
    ties = _near_ties(torch, model, prompts, [h.tokens for h in handles],
                      [h.tokens for h in seq_handles], engine.max_len,
                      kv_cache_dtype)
    decode = "flash_decode" + sfx
    _check_served(engine, handles, wall, launches, plain_calls, (decode,),
                  what, prompt_lens=[int(p.size) for p in prompts],
                  decode_launches_per_window=launches[decode] / max(steps, 1),
                  streams_differing_from_batch1_spec_generate=len(
                      batch1_ties), batch1_near_ties=batch1_ties,
                  streams_differing_from_serve=len(ties), near_ties=ties,
                  **_spec_fields(engine, handles))
    if launches[decode] != 12 * steps or \
            launches["flash_fwd"] != 12 * engine.stats["prefills"]:
        fail(f"{what}: launches {launches} for {steps} verify windows")
    if batch1_ties:
        fail(f"{what}: streams differ from batch-1 speculative generate: "
             f"{batch1_ties}")
    _gate_spec(what, engine, ties)
    _decode_step_profile(torch, engine, prompts[8:], window_ms,
                         "dense_spec" + sfx)
    return launches, handles


def phase_serve_spec_paged(torch, model, prompts, spec_handles,
                           paged_handles):
    """The speculative engine on a paged cache (page 128, default pool):
    the 16 prompts, then the 8 shared-prefix ones. Every stream equals
    the speculative dense engine's bit for bit; prefix pages are shared
    and conserved, none in use after the drain; 12 paged decode launches
    a window; each of the first 8 streams equals batch-1 speculative
    ``generate`` (dense) bit for bit; each stream equals
    ``serve_paged``'s bit for bit."""
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    spec = _spec_config()
    engine = ServingEngine(_serve_config(model, speculative=spec, paged=True,
                                         kv_page_size=128))
    shared = _shared_prompts(model)
    params = RequestParams(max_new_tokens=64)
    handles, wall, launches, plain_calls = _serve(
        torch, engine, [[(p, params) for p in prompts],
                        [(p, params) for p in shared]])
    steps, prefills = engine.stats["decode_steps"], engine.stats["prefills"]
    dense = ServingEngine(_serve_config(model, speculative=spec))
    reference = list(spec_handles) + dense.serve_forever(
        (p, params) for p in shared)
    mismatch = sum(not np.array_equal(h.tokens, r.tokens)
                   for h, r in zip(handles, reference))
    engine._alloc.assert_conserved()
    stats = dict(engine._alloc.stats)
    batch1 = _batch1_spec_generate(model, prompts[:8], engine, spec, None)
    batch1_ties = _near_ties(torch, model, prompts[:8],
                             [h.tokens for h in handles[:8]], batch1,
                             engine.max_len, None)
    ties = _near_ties(torch, model, list(prompts) + shared,
                      [h.tokens for h in handles],
                      [h.tokens for h in paged_handles], engine.max_len, None)
    _check_served(engine, handles, wall, launches, plain_calls,
                  ("flash_decode_paged",), "serve_spec_paged",
                  streams_differing_from_batch1_spec_generate=len(
                      batch1_ties), batch1_near_ties=batch1_ties,
                  page_size=engine.page_size,
                  pool_pages=engine._alloc.n_pages,
                  paged_launches_per_window=launches["flash_decode_paged"]
                  / max(steps, 1),
                  token_streams_differing_from_dense_spec=mismatch,
                  allocator=stats,
                  pages_in_use_after_drain=engine._alloc.used_pages(),
                  streams_differing_from_serve_paged=len(ties),
                  near_ties=ties, **_spec_fields(engine, handles))
    if mismatch:
        fail(f"{mismatch} speculative paged streams differ from the "
             "speculative dense engine")
    if stats["prefix_hits"] < 1 or engine._alloc.used_pages():
        fail(f"speculative paged allocator {stats}, "
             f"{engine._alloc.used_pages()} pages in use after the drain")
    if launches["flash_decode_paged"] != 12 * steps or \
            launches["flash_fwd"] != 12 * prefills:
        fail(f"serve_spec_paged launches {launches} for {steps} windows and "
             f"{prefills} prefills")
    if batch1_ties:
        fail(f"serve_spec_paged: streams differ from batch-1 speculative "
             f"generate: {batch1_ties}")
    _gate_spec("serve_spec_paged", engine, ties)
    return launches


def phase_serve_spec_chunked(torch, model, prompts, chunked_handles):
    """The speculative paged engine with prefill_chunk_tokens=128 on the
    16 prompts: all complete; inline prefills through flash_fwd, chunks
    through the chunk kernel (12 launches a chunk), verify windows
    through the paged decode kernel (12 a window); no plain version;
    pages conserved; each of the first 8 streams equals, bit for bit,
    the same prompt served alone by a one-slot engine of the same
    configuration (the batch-1 stream: ``generate`` has no chunked
    prefill, and a chunked prefill rounds other than a bucket one); each
    stream equals ``serve_chunked``'s bit for bit."""
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    C = 128

    def chunked_engine(max_batch):
        cfg = _serve_config(model, speculative=_spec_config(), paged=True,
                            kv_page_size=128, prefill_chunk_tokens=C)
        return ServingEngine(cfg.enable_generation(
            max_new_tokens=64, prefill_buckets=(128, 512),
            max_batch=max_batch, speculative=_spec_config()))
    engine = chunked_engine(8)
    params = RequestParams(max_new_tokens=64)
    handles, wall, launches, plain_calls = _serve(
        torch, engine, [[(p, params) for p in prompts]])
    alone = chunked_engine(1)
    batch1 = [alone.serve_forever([(p, params)])[0].tokens
              for p in prompts[:8]]
    batch1_ties = _near_ties(torch, model, prompts[:8],
                             [h.tokens for h in handles[:8]], batch1,
                             engine.max_len, None)
    steps, chunks = engine.stats["decode_steps"], \
        engine.stats["prefill_chunks"]
    n_short = sum(int(p.size <= C) for p in prompts)
    expect_chunks = sum(-(-int(p.size) // C) for p in prompts if p.size > C)
    engine._alloc.assert_conserved()
    ties = _near_ties(torch, model, prompts, [h.tokens for h in handles],
                      [h.tokens for h in chunked_handles], engine.max_len,
                      None)
    _check_served(engine, handles, wall, launches, plain_calls,
                  ("flash_chunk", "flash_decode_paged"),
                  "serve_spec_chunked", chunk_tokens=C,
                  inline_prompts=n_short, prefill_chunks=chunks,
                  expected_chunks=expect_chunks,
                  pages_in_use_after_drain=engine._alloc.used_pages(),
                  streams_differing_from_batch1_spec=len(batch1_ties),
                  batch1_near_ties=batch1_ties,
                  streams_differing_from_serve_chunked=len(ties),
                  near_ties=ties, **_spec_fields(engine, handles))
    if chunks != expect_chunks or launches["flash_chunk"] != 12 * chunks or \
            launches["flash_decode_paged"] != 12 * steps or \
            launches["flash_fwd"] != 12 * n_short:
        fail(f"serve_spec_chunked: {chunks} chunks (expected "
             f"{expect_chunks}), launches {launches} for {steps} windows")
    if engine._alloc.used_pages():
        fail("serve_spec_chunked left pages in use after the drain")
    if batch1_ties:
        fail(f"serve_spec_chunked: streams differ from the one-slot "
             f"engine's: {batch1_ties}")
    _gate_spec("serve_spec_chunked", engine, ties)
    return launches


def phase_generate_spec(torch, model, prompts):
    """``generate(speculative=...)`` at batch 2 on two prompts, ngram and
    draft mode with the target's own weights as ``draft_model``: exact
    launch counts (12 a verify window in the decode kernel, and in draft
    mode 12 a draft step too; 12 a prefill, the draft model's prefill
    included), no plain version; ngram accepts, self-drafting accepts at
    least 0.9 of its proposals (a draft cache out of line with the
    target's drops that towards 0); streams equal sequential
    ``generate``'s bit for bit."""
    from paddle_tpu_torch.generation import (GenerationSession,
                                             SpeculativeConfig, generate)
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = next(model.parameters()).device
    two = prompts[:2]
    ids = np.zeros((2, 512), np.int64)
    for i, p in enumerate(two):
        ids[i, :p.size] = p
    plen = [int(p.size) for p in two]
    kw = dict(prompt_len=plen, cache_max_len=640)
    seq = generate(model, ids, 64, **kw).cpu().numpy()
    total = {}
    for mode in ("ngram", "draft"):
        spec = SpeculativeConfig(mode=mode, k=SPEC_K, ngram=SPEC_NGRAM)
        draft = model if mode == "draft" else None
        sess = GenerationSession(model)
        torch.cuda.synchronize()
        _reset_counts(fa)
        t0 = time.perf_counter()
        out = generate(model, ids, 64, speculative=spec, draft_model=draft,
                       session=sess, **kw).cpu().numpy()
        wall = time.perf_counter() - t0
        launches, plain_calls = _counts(fa)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        st = sess.speculative(spec, draft).stats
        windows = st["windows"]
        rate = st["accepted"] / max(st["proposed"], 1)
        ties = _near_ties(torch, model, two, out, seq, 640, None)
        draft_steps = (SPEC_K + 1) * windows if draft is not None else 0
        prefills = 2 if draft is not None else 1
        say("generate_spec", mode=mode, k=SPEC_K, batch=2, prompt_lens=plen,
            new_tokens=64, wall_s=wall, tokens_per_s=2 * 64 / wall,
            verify_windows=windows, draft_steps=draft_steps,
            spec_proposed=st["proposed"], spec_accepted=st["accepted"],
            acceptance_rate=rate, launches=launches,
            plain_calls=plain_calls,
            streams_differing_from_sequential=len(ties), near_ties=ties)
        if plain_calls:
            fail(f"generate_spec {mode}: plain versions ran {plain_calls} "
                 "times")
        if launches["flash_decode"] != 12 * (windows + draft_steps) or \
                launches["flash_fwd"] != 12 * prefills or \
                any(n for k, n in launches.items()
                    if k not in ("flash_decode", "flash_fwd", "row_gemm")):
            fail(f"generate_spec {mode}: launches {launches} for {windows} "
                 f"windows")
        _row_gate(f"generate_spec {mode}", launches)
        if st["accepted"] <= 0 or (draft is not None and rate < 0.9):
            fail(f"generate_spec {mode}: acceptance {st}")
        if ties:
            fail(f"generate_spec {mode}: streams part from sequential "
                 f"generate: {ties}")
    return total


#: the serve_telemetry phase's engines: (name, enable_serving options,
#: speculative, extra traffic of shared-prefix prompts)
TELEMETRY_ENGINES = (
    ("dense", {}, False, False),
    ("paged", dict(paged=True, kv_page_size=128), False, True),
    ("chunked", dict(paged=True, kv_page_size=128,
                     prefill_chunk_tokens=128), False, False),
    ("int8", dict(kv_cache_dtype="int8"), False, False),
    ("spec", {}, True, False),
)


def _telemetry_reset():
    """A clean registry, time-series ring, SLO watchtower and flight
    recorder, with the monitor off."""
    from paddle_tpu_torch.core import (flight_recorder, metrics, monitor,
                                       slo, timeseries)
    monitor.disable()
    metrics._reset_for_tests()
    timeseries._reset_for_tests()
    slo._reset_for_tests()
    flight_recorder.configure(capacity=flight_recorder.DEFAULT_CAPACITY,
                              on=True)


def _telemetry_serve(torch, model, prompts, shared, opts, spec, on):
    """One engine built and served with the registry and the recorder on
    or off; returns (engine, handles, wall, launches, plain calls)."""
    from paddle_tpu_torch.core import flight_recorder, monitor
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    _telemetry_reset()
    if on:
        monitor.enable()           # before the build: kv_dtype is set there
    else:
        flight_recorder.disable()
    engine = ServingEngine(_serve_config(
        model, speculative=_spec_config() if spec else None,
        trace_sample=1, **opts))
    params = RequestParams(max_new_tokens=64)
    work = [[(p, params) for p in prompts]]
    if shared:
        work.append([(p, params) for p in _shared_prompts(model)])
    return (engine,) + _serve(torch, engine, work)


def _telemetry_profile(torch, engine, prompts):
    """Profiler(targets=[CPU, GPU]) over 8 dense decode steps with all 8
    slots live and every request traced: the exported chrome trace must
    hold the decode kernel's device events, the RecordEvent spans and
    the sampled requests' spans; summary_report prints."""
    from paddle_tpu_torch.profiler import (Profiler, ProfilerTarget,
                                           RecordEvent, statistic)
    from paddle_tpu_torch.serving import RequestParams
    for p in prompts:
        engine.submit(p, RequestParams(max_new_tokens=64))
    engine.step()                           # admits all 8
    trace_dir = os.path.join(HERE, "build", "profiler")
    prof = Profiler(targets=[ProfilerTarget.CPU, ProfilerTarget.GPU],
                    scheduler=(0, 8), trace_dir=trace_dir)
    prof.start()
    for _ in range(8):
        with RecordEvent("serve_telemetry.step"):
            engine.step()
        prof.step()
    prof.stop()
    res = prof.result
    path = res.export_chrome_tracing(os.path.join(trace_dir, "serve.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events if e.get("ph") == "X"]
    decode = [e for e in events if e.get("cat") == "kernel"
              and "paddle_flash::flash_decode" in e["name"]]
    steps = spans.count("serve_telemetry.step")
    requests = sorted({n.split(".", 1)[0] for n in spans
                       if n.startswith("req") and "." in n})
    summary = statistic.summary_report(res.events, res.metrics_snapshot)
    print(summary, flush=True)
    while engine.busy:
        engine.step()
    fields = dict(trace_events=len(events), decode_kernel_events=len(decode),
                  record_event_spans=steps, traced_requests=len(requests),
                  device_events=len(res.device_events),
                  torch_trace_dir=os.path.relpath(res.device_trace_dir,
                                                  HERE))
    if steps != 8 or len(decode) < 8 * 12 or not requests:
        fail(f"serve_telemetry profile: {fields}")
    return fields


def _telemetry_step_wall(torch, engine, prompts):
    """The dense step's wall with the registry off and on, in one call
    (off, on, on, off): 8 live slots, 16 scheduler steps (4 polls)
    timed per round. For information: no gate."""
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.serving import RequestParams
    walls = []
    for on in (False, True, True, False):
        (monitor.enable if on else monitor.disable)()
        for p in prompts:
            engine.submit(p, RequestParams(max_new_tokens=64))
        engine.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            engine.step()
        torch.cuda.synchronize()
        walls.append(dict(registry="on" if on else "off",
                          step_wall_ms=(time.perf_counter() - t0) * 1e3 / 16))
        while engine.busy:
            engine.step()
    monitor.enable()
    return walls


def _telemetry_fail_admission(torch, model, prompts):
    """fail_admission(n=2) on the card: two handles end cancelled with
    an admission error, the engine serves the rest, the swallows are
    counted, and flight_recorder.auto_dump writes a dump."""
    from paddle_tpu_torch.core import flight_recorder, metrics
    from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                          ServingEngine)
    from paddle_tpu_torch.utils.fault_injection import fail_admission
    dump_dir = os.path.join(HERE, "build", "flightrecorder")
    os.environ["PADDLE_FLIGHT_RECORDER_DIR"] = dump_dir
    engine = ServingEngine(_serve_config(model))
    with fail_admission(engine, n=2) as fa:
        handles = engine.serve_forever(
            (p, RequestParams(max_new_tokens=64)) for p in prompts)
    path = flight_recorder.auto_dump("serve_admission_error")
    snap = metrics.snapshot()
    cancelled = [h for h in handles if h.status is RequestStatus.CANCELLED]
    done = [h for h in handles if h.status is RequestStatus.COMPLETED]
    fields = dict(
        triggered=fa.triggered, cancelled=len(cancelled),
        completed=len(done),
        details=[h.detail[:60] for h in cancelled],
        swallowed=snap.get("errors.swallowed{where=serving.admit}",
                           {}).get("value"),
        dump=None if path is None else os.path.relpath(path, HERE),
        dumps=snap.get("flightrecorder.dumps{reason=serve_admission_error}",
                       {}).get("value"))
    if fa.triggered != 2 or len(cancelled) != 2 or \
            len(done) != len(handles) - 2 or fields["swallowed"] != 2 or \
            not all(h.detail.startswith("admission error")
                    for h in cancelled) or \
            path is None or not os.path.exists(path) or fields["dumps"] != 1:
        fail(f"serve_telemetry fail_admission: {fields}")
    return fields


def phase_serve_telemetry(torch, model, prompts):
    """The serving traffic (gpt2-small bf16, max_batch 8, the 16 prompts,
    64 new tokens; the paged engine also the 8 shared-prefix ones) on
    the dense, paged, chunked, int8 and ngram-speculative dense engines,
    each served with the registry and the flight recorder off, then on.
    Per engine: the streams equal bitwise between the two runs
    (recording changes nothing computed), serve.requests{completed} and
    serve.ttft's count equal the requests, gen.tokens the tokens the
    handles hold, gen.decode_steps and gen.spec.* the engine's stats,
    pages allocated equal pages freed once the drained prefix registry
    is dropped, and the int8 engine carries serve.cache.kv_dtype{int8}.
    Then a CPU+GPU profile of 8 dense decode steps, the dense step's
    wall with the registry off and on, and fail_admission on the card.
    Latency, goodput and wall figures print for information."""
    from paddle_tpu_torch.core import metrics, monitor
    from paddle_tpu_torch.serving import RequestStatus
    total = {}
    for name, opts, spec, shared in TELEMETRY_ENGINES:
        _, off, *_ = _telemetry_serve(torch, model, prompts, shared, opts,
                                      spec, on=False)
        if metrics.snapshot():
            fail(f"serve_telemetry {name}: the registry recorded while off")
        engine, handles, wall, launches, plain = _telemetry_serve(
            torch, model, prompts, shared, opts, spec, on=True)
        if engine._alloc is not None:
            engine._alloc.drop_registry()
            engine._drain_page_stats()
        snap = metrics.snapshot()
        value = lambda key: snap.get(key, {}).get("value")
        st = engine.stats
        n_tokens = sum(int(h.tokens.size) for h in handles
                       if h.tokens is not None)
        differ = sum(not np.array_equal(a.tokens, b.tokens)
                     for a, b in zip(off, handles))
        ttft = metrics.histogram("serve.ttft")
        tok = metrics.histogram("serve.token_latency")
        gp = engine.goodput()
        fields = dict(
            engine=name, requests=len(handles),
            completed=value("serve.requests{status=completed}"),
            gen_tokens=value("gen.tokens"), handle_tokens=n_tokens,
            gen_decode_steps=value("gen.decode_steps"),
            spec_proposed=value("gen.spec.proposed"),
            spec_accepted=value("gen.spec.accepted"),
            ttft_count=snap.get("serve.ttft", {}).get("count"),
            pages_allocated=value("gen.cache.pages_allocated"),
            pages_freed=value("gen.cache.pages_freed"),
            prefix_hits=value("serve.cache.prefix_hits"),
            prefill_chunks=value("serve.prefill.chunks"),
            kv_dtype=sorted(k for k in snap
                            if k.startswith("serve.cache.kv_dtype")),
            streams_differing_with_telemetry_off=differ,
            p50_ttft_ms=ttft.percentile(50) * 1e3,
            p95_ttft_ms=ttft.percentile(95) * 1e3,
            p50_per_token_ms=tok.percentile(50) * 1e3,
            goodput_fraction=gp["goodput_fraction"],
            goodput_buckets_s=gp["buckets"], wall_s=wall,
            tokens_per_s=n_tokens / wall, launches=launches,
            plain_calls=plain, stats=st, metrics=len(snap))
        say("serve_telemetry", **fields)
        done = [h for h in handles if h.status is RequestStatus.COMPLETED]
        bad = []
        if differ or len(done) != len(handles):
            bad.append("streams")
        if fields["completed"] != len(handles) or \
                fields["ttft_count"] != len(handles):
            bad.append("requests")
        if fields["gen_tokens"] != n_tokens or \
                fields["gen_decode_steps"] != st["decode_steps"]:
            bad.append("gen")
        if spec and (fields["spec_proposed"] != st["spec_proposed"]
                     or fields["spec_accepted"] != st["spec_accepted"]
                     or not st["spec_accepted"]):
            bad.append("spec")
        if engine._alloc is not None and (
                not fields["pages_allocated"]
                or fields["pages_allocated"] != fields["pages_freed"]):
            bad.append("pages")
        if (name == "int8") != (fields["kv_dtype"] ==
                                ["serve.cache.kv_dtype{dtype=int8}"]):
            bad.append("kv_dtype")
        if plain:
            bad.append("plain")
        if bad:
            fail(f"serve_telemetry {name}: {bad}: {fields}")
        _row_gate(f"serve_telemetry {name}", launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        if name == "dense":
            profile = _telemetry_profile(torch, engine, prompts[8:])
            walls = _telemetry_step_wall(torch, engine, prompts[8:])
            say("serve_telemetry_profile", **profile, step_wall=walls)
    say("serve_telemetry_fail_admission",
        **_telemetry_fail_admission(torch, model, prompts[:8]))
    _telemetry_reset()
    monitor.disable()
    return total


def _http(url):
    """(status, JSON or text body) of one GET, an HTTP error's too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body


def _latency_fields(prefix, handles, submitted):
    """Tokens/s over the first submit to the last finish, TTFT from each
    request's own submit (a re-homed one's too) and per-token latency,
    from the handles' host clocks."""
    first = [h.inner.first_token_at if hasattr(h, "inner")
             else h.first_token_at for h in handles]
    inner = [h.inner if hasattr(h, "inner") else h for h in handles]
    ttft = [f - s for f, s in zip(first, submitted)]
    per_token = [r.per_token_latency for r in inner]
    wall = max(r.finished_at for r in inner) - min(submitted)
    return {prefix + "tokens_per_s": sum(int(r.tokens.size)
                                         for r in inner) / wall,
            prefix + "wall_s": wall,
            prefix + "p50_ttft_ms": float(np.percentile(ttft, 50)) * 1e3,
            prefix + "p95_ttft_ms": float(np.percentile(ttft, 95)) * 1e3,
            prefix + "p50_per_token_ms":
                float(np.percentile(per_token, 50)) * 1e3}


def _fleet_preemption(torch, model, prompts):
    """One chunked paged engine (page 128, chunk 128) serving the 16
    prompts through serve_forever(work, shutdown=gs, on_step=...), the
    GracefulShutdown triggered after 8 loop iterations: every handle
    terminal, the queued ones REJECTED("shutdown"), the in-flight ones
    COMPLETED or CANCELLED("shutdown"), goodput's preemption_recovery
    bucket charged, and the flight recorder dumped under
    build/flightrecorder/."""
    from paddle_tpu_torch.distributed.resilience import GracefulShutdown
    from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                          ServingEngine)
    dump_dir = os.path.join(HERE, "build", "flightrecorder")
    os.environ["PADDLE_FLIGHT_RECORDER_DIR"] = dump_dir
    before = set(os.listdir(dump_dir)) if os.path.isdir(dump_dir) else set()
    engine = ServingEngine(_serve_config(model, paged=True, kv_page_size=128,
                                         prefill_chunk_tokens=128))
    gs = GracefulShutdown(exit_on_save=False)
    steps = [0]

    def on_step(e):
        steps[0] += 1
        if steps[0] == 8:
            gs.trigger()

    t0 = time.perf_counter()
    handles = engine.serve_forever(
        [(p, RequestParams(max_new_tokens=64)) for p in prompts],
        shutdown=gs, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dumps = sorted(f for f in set(os.listdir(dump_dir)) - before
                   if f.startswith("flightrecorder_preemption")
                   and f.endswith(".json"))
    by = {}
    for h in handles:
        by.setdefault(f"{h.status.value}:{h.detail}", 0)
        by[f"{h.status.value}:{h.detail}"] += 1
    gp = engine.goodput()["buckets"]
    fields = dict(requests=len(handles), by_status=by, loop_steps=steps[0],
                  wall_s=wall, preemption_recovery_s=gp[
                      "preemption_recovery"], goodput_buckets_s=gp,
                  dumps=[os.path.join("build", "flightrecorder", f)
                         for f in dumps], stats=engine.stats)
    say("serve_fleet_preemption", **fields)
    ok = {"completed:", "rejected:shutdown", "cancelled:shutdown"}
    if not all(h.status.terminal for h in handles) or set(by) - ok or \
            not by.get("rejected:shutdown") or \
            gp["preemption_recovery"] <= 0.0 or not dumps:
        fail(f"serve_fleet preemption: {fields}")
    engine._alloc.assert_conserved()
    engine.shutdown()


def phase_serve_fleet(torch, model, prompts, serve_handles, card):
    """Two replicas of the serve configuration (gpt2-small bf16,
    max_batch 8, buckets 128/512, 64 new tokens, cache 640) behind a
    FleetRouter in one process, each on its own pump thread: r0 on the
    dense cache, r1 on the paged one (page 128), each with its telemetry
    server, and a fleet TelemetryServer with the router attached. The 16
    serve prompts go through the router; after the first 4, r0's
    scheduler is held (its pump lock taken), so the next 4 leave work in
    its queue; then rolling_deploy("r0") drains it (in-flight requests
    decode to their end, queued ones re-home onto r1) and relaunches it,
    and the last 8 and 4 more follow. Gates: every handle COMPLETED, none
    rejected, at least one re-homed; every stream equal bit for bit to
    that prompt's stream in the dense serve run; r1's pages allocated
    equal its pages freed; the relaunched r0 warm, with no kernel built
    by its warmup; r0's /readyz 200 before the deploy and 503
    "draining" once its drain began; the fleet /metrics carries
    serve_router_admissions and /router lists both replicas; each
    replica's warmup peaked below its live cache's bytes. Then the
    preemption sub-phase. Warmup, deploy and drain walls, and the
    fleet's tokens/s, TTFT and per-token latency beside the dense serve
    run's, print for information."""
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.core.telemetry_server import TelemetryServer
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import (InProcessFleet, RequestParams,
                                          RequestStatus, ServingEngine)
    _telemetry_reset()
    warm = []

    def factory(name):
        opts = dict(paged=True, kv_page_size=128) if name == "r1" else {}
        engine = ServingEngine(_serve_config(model, telemetry_port=0,
                                             **opts), warmup=False)
        b0 = _build.build_count()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        c = engine._cache
        # the peak is the card's: at the deploy it includes the other
        # replica's traffic, so only the first two (built before any
        # traffic) are gated
        warm.append(dict(replica=name,
                         warmup_s=time.perf_counter() - t0,
                         kernel_builds=_build.build_count() - b0,
                         warmup_peak_mb=(torch.cuda.max_memory_allocated()
                                         - base) / 1e6,
                         cache_mb=2 * c.k.numel() * c.k.element_size()
                         / 1e6))
        return engine.start()

    torch.cuda.synchronize()
    _reset_counts(fa)
    fleet = InProcessFleet(factory, names=["r0", "r1"],
                           router_kw=dict(seed=SEED))
    server = TelemetryServer(port=0).start().attach_router(fleet.router)
    fleet_url = f"http://127.0.0.1:{server.port}"
    hold = []          # r0 while this script holds its pump lock
    try:
        r0 = fleet["r0"]
        r0_url = f"http://127.0.0.1:{r0.telemetry.port}"
        ready_before = _http(r0_url + "/readyz")[0]
        params = RequestParams(max_new_tokens=64)
        work = list(prompts) + list(prompts[:4])
        handles, submitted = [], []

        def submit(p):
            submitted.append(time.monotonic())
            handles.append(fleet.router.submit(p, params))

        for p in work[:4]:
            submit(p)
        deadline = time.monotonic() + 60
        while r0.health()["queue_depth"] and time.monotonic() < deadline:
            time.sleep(0.001)
        # hold r0's scheduler: what the router places there now waits
        r0._pump_lock.acquire()
        hold.append(r0)
        for p in work[4:8]:
            submit(p)
        queued = r0.health()["queue_depth"]
        walls, probe = {}, {}
        drain, shutdown = r0.drain, r0.shutdown

        def timed_drain():
            t = time.perf_counter()
            drain()
            walls.setdefault("drain_s", time.perf_counter() - t)

        def probed_shutdown():
            # after the drain began, before the port is released
            probe["readyz"] = _http(r0_url + "/readyz")
            hold.pop()._pump_lock.release()
            shutdown()

        r0.drain, r0.shutdown = timed_drain, probed_shutdown
        builds = _build.build_count()
        t0 = time.perf_counter()
        fresh = fleet.rolling_deploy("r0")
        walls["rolling_deploy_s"] = time.perf_counter() - t0
        rejoin_builds = _build.build_count() - builds
        for p in work[8:]:
            submit(p)
        for h in handles:
            h.result(timeout=600)
        torch.cuda.synchronize()
        metrics_text = _http(fleet_url + "/metrics")[1]
        router_doc = _http(fleet_url + "/router")[1]
        stats = fleet.router.stats
        placed = {}
        for h in handles:
            placed[h.replica] = placed.get(h.replica, 0) + 1
    finally:
        if hold:
            hold.pop()._pump_lock.release()
        server.stop()
        fleet.shutdown()
    launches_fleet, plain_fleet = _counts(fa)
    r1 = fleet["r1"]
    r1._alloc.drop_registry()
    r1._alloc.assert_conserved()
    pages = dict(r1._alloc.stats)
    done = [h for h in handles if h.status is RequestStatus.COMPLETED]
    ref = {id(p): h.tokens for p, h in zip(prompts, serve_handles)}
    mismatch = [i for i, (p, h) in enumerate(zip(work, handles))
                if not np.array_equal(h.tokens, ref[id(p)])]
    serve_sub = [h.submitted_at for h in serve_handles]
    fields = dict(
        card=card, replicas={"r0": "dense", "r1": "paged page 128"},
        requests=len(handles), completed=len(done), placed=placed,
        router=stats, queued_on_r0_at_deploy=queued,
        warmup=warm, rejoin_kernel_builds=rejoin_builds,
        fresh_r0_warm=fresh._warm, **walls,
        readyz_r0_before=ready_before,
        readyz_r0_in_drain=[probe["readyz"][0],
                            probe["readyz"][1].get("reason")],
        router_replicas=[r["name"] for r in router_doc["replicas"]],
        metrics_has_router_admissions="serve_router_admissions"
        in metrics_text,
        streams_differing_from_serve=mismatch,
        r1_pages=dict(allocated=pages["pages_allocated"],
                      freed=pages["pages_freed"]),
        **_latency_fields("fleet_", handles, submitted),
        **_latency_fields("serve_", serve_handles, serve_sub),
        launches=launches_fleet, plain_calls=plain_fleet)
    say("serve_fleet", **fields)
    bad = []
    if len(done) != len(handles) or stats["rejected"] or \
            stats["rehomed"] < 1:
        bad.append("handles")
    if mismatch:
        bad.append("streams")
    if pages["pages_allocated"] == 0 or \
            pages["pages_allocated"] != pages["pages_freed"]:
        bad.append("pages")
    if not fresh._warm or rejoin_builds or warm[-1]["kernel_builds"]:
        bad.append("rejoin")
    if any(w["warmup_peak_mb"] >= w["cache_mb"] for w in warm[:2]):
        bad.append("warmup_memory")
    if ready_before != 200 or fields["readyz_r0_in_drain"] != \
            [503, "draining"]:
        bad.append("readyz")
    if not fields["metrics_has_router_admissions"] or \
            sorted(fields["router_replicas"]) != ["r0", "r1"]:
        bad.append("telemetry")
    if bad:
        fail(f"serve_fleet: {bad}: {fields}")
    _fleet_preemption(torch, model, prompts)
    launches, plain = _counts(fa)
    want = ("flash_fwd", "flash_decode", "flash_decode_paged",
            "flash_chunk", "row_gemm")
    if plain or any(launches[k] == 0 for k in want) or \
            any(n for k, n in launches.items() if k not in want):
        fail(f"serve_fleet launches {launches}, plain calls {plain}")
    _telemetry_reset()
    monitor.disable()
    return launches


def _busy_ms(torch, fn, n):
    """Device busy ms per call of ``fn`` over ``n`` calls, from the
    profiler's device-side events (kernels and copies, no host time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_time_total > 0 and e.cpu_time_total == 0]
    return sum(e.device_time_total for e in dev) / (1e3 * n), \
        sum(e.count for e in dev) / n


def phase_predictor(torch, model, prompts, serve_handles, card):
    """``create_predictor`` in generation mode on the serve configuration
    (gpt2-small bf16, max_batch 8, buckets 128/512, 64 new tokens), then
    ``generate()`` over the 16 serve prompts (two chunks of 8, each
    right-padded to its bucket). Gates: no kernel built after
    ``create_predictor``; every stream equal to the dense serve run's
    bit for bit (a bucket-padded batch-8 prefill against the engine's
    batch-1 one: row_gemm gives a row the same bits at any row count,
    ROADMAP C12); rows 1 and 5 launched, row_gemm 49 times a forward, no
    plain version; ``run()`` on a [8, 128] id batch equal bit for bit to
    the served module's own logits. Printed: ``device_time_per_run`` of
    that ``run()`` beside the profiler's busy time and the wall per run
    (eager launches come from the host: the slope is the larger of the
    host's and the card's time per run)."""
    from paddle_tpu_torch.inference import (create_predictor,
                                            device_time_per_run)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    cfg = (_serve_config(model).enable_generation(
        max_new_tokens=64, prefill_buckets=(128, 512), max_batch=8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = create_predictor(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    builds = _build.build_count()
    _reset_counts(fa)
    t0 = time.perf_counter()
    outs = pred.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = _counts(fa)
    new_builds = _build.build_count() - builds
    ref = [h.tokens for h in serve_handles]
    differ = [i for i, (o, r) in enumerate(zip(outs, ref))
              if not np.array_equal(o, r)]
    ties = _near_ties(torch, model, prompts, outs, ref, 640, None)
    # run(): the served module's own logits, bit for bit
    dev = torch.device("cuda", 0)
    ids = np.random.RandomState(SEED + 9).randint(
        0, model.cfg.vocab_size, (8, 128))
    got = pred.run([ids])[0]
    with torch.no_grad():
        direct = pred._serving_params.layer(torch.as_tensor(ids, device=dev))
    run_bitwise = bool(np.array_equal(got, direct.float().cpu().numpy()))
    slope_ms = device_time_per_run(pred, [ids], iters=(4, 12),
                                   repeats=2) * 1e3
    feeds = [torch.as_tensor(ids, device=dev)]
    run_wall_ms = span_ms(torch, lambda: pred._run_fn(feeds), n=5)[1]
    busy_ms, run_launches = _busy_ms(torch, lambda: pred._run_fn(feeds), 4)
    fields = dict(
        card=card, requests=len(prompts), buckets=pred._gen_buckets,
        cache_lens=pred._gen_cache_lens, create_predictor_s=build_s,
        kernel_builds_after_create=new_builds, wall_s=wall,
        tokens_per_s=sum(int(o.size) for o in outs) / wall,
        launches=launches, plain_calls=plain,
        streams_differing_from_serve=len(differ), near_ties=ties,
        run_shape=list(got.shape), run_dtype=str(got.dtype),
        run_bitwise_to_served_module=run_bitwise,
        run_slope_ms=slope_ms, run_wall_ms=run_wall_ms,
        run_device_busy_ms=busy_ms, run_launches=run_launches,
        run_idle_share=max(0.0, 1.0 - busy_ms / run_wall_ms))
    say("predictor", **fields)
    bad = []
    if new_builds:
        bad.append("builds")
    if any(o.size != 64 for o in outs) or len(outs) != len(prompts):
        bad.append("budgets")
    if differ:
        bad.append("streams")
    if plain or not launches["flash_fwd"] or not launches["flash_decode"] \
            or any(n for k, n in launches.items()
                   if k not in ("flash_fwd", "flash_decode", "row_gemm")):
        bad.append("launches")
    _row_gate("predictor", launches)
    if not run_bitwise or got.dtype != np.float32:
        bad.append("run")
    if not (slope_ms >= 0 and math.isfinite(slope_ms)):
        bad.append("slope")
    if bad:
        fail(f"predictor: {bad}: {fields}")
    return launches


def _weight_bound_check(engine, model):
    """Each quantized weight of the engine's served module against the
    bf16 model's: the layer's bf16 weight equal bit for bit to
    ``materialize`` of its stored tensor; int4 within 0.75 of its
    per-channel step (absmax / 7; the JAX package's bound), int8's
    quantization (q * absmax / 127 in fp32) within half a step + 1e-6.
    Returns (worst error over step, Linear weight bytes stored)."""
    from paddle_tpu_torch.core.tensor import plain
    sp = engine._sp
    orig = {k: plain(v) for k, v in model.state_dict().items()}
    mat = dict(zip(sp.names, sp.materialize(sp.vals)))
    worst, stored, bad = 0.0, 0, []
    for n, step in sp.scales.items():
        mod = sp.layer.get_submodule(n[:-len(".weight")])
        w = orig[n].float()
        if not bool((mod.weight == mat[n]).all()):
            bad.append(n)
        if n in sp.int4:
            err = (mod.weight.float() - w).abs() / step
            lim = 0.75
        else:
            err = ((mod.weight_q.float() * step - w).abs() - 1e-6) / step
            lim = 0.5
        e = float(err.max())
        worst = max(worst, e)
        if e > lim:
            bad.append(n)
        stored += mod.weight_q.numel() + step.numel() * 4
    return worst, stored, bad


def _logit_agreement(torch, model, served, ids):
    """Top-1 agreement and the largest logit gap of ``served`` against
    the bf16 model on one id batch."""
    with torch.no_grad():
        a = model(ids).float()
        b = served(ids).float()
    return float((a.argmax(-1) == b.argmax(-1)).float().mean()), \
        float((a - b).abs().max())


def phase_serve_weights(torch, model, prompts, card, attention_ms):
    """Weight-only int8 and int4 serving of the serve configuration
    (precision Int8, ``weight_bits`` 8 and 4 on the dense engine; 4 on a
    paged engine, page 128, with the int8 KV cache, as the JAX package's
    ``test_int4_weight_serving`` configures it). Gates: every request
    completes with its 64 tokens through rows 1 and 5 (7 in its int8
    mode on the paged engine), no plain version; the first 8 streams
    equal batch-1 ``generate`` on the same quantized served module bit
    for bit (dequantization is per element, and every product of the
    cached forward runs row_gemm, 49 a forward); every dequantized
    weight within its step
    (``_weight_bound_check``); ``Int8ComputeLinear``'s int32
    accumulators at gpt2-small's fc1 shape equal the CPU's on the same
    int8 operands. Printed: Linear weight bytes at bf16, int8 and int4,
    top-1 agreement and the largest logit gap against bf16, and the
    decode step's wall, busy time and idle share for bf16, w8 and w4 in
    this call."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.quantization import Int8ComputeLinear
    from paddle_tpu_torch.quantization.int8_compute import int8_matmul
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    dev = torch.device("cuda", 0)
    lin_bytes = sum(torch.numel(m.weight) * 2 for m in model.modules()
                    if type(m).__name__ == "Linear")
    ids = torch.as_tensor(np.random.RandomState(SEED + 11).randint(
        0, model.cfg.vocab_size, (4, 128)), device=dev)
    launches_all = {}
    results = {}
    for name, opts in (("w8", dict(weight_bits=8)),
                       ("w4", dict(weight_bits=4)),
                       ("w4_paged_int8kv", dict(weight_bits=4, paged=True,
                                                kv_page_size=128,
                                                kv_cache_dtype="int8"))):
        kv = opts.get("kv_cache_dtype")
        engine = ServingEngine(_serve_config(model, precision="int8",
                                             **opts))
        handles, wall, launches, plain_calls = _serve(
            torch, engine, [[(p, RequestParams(max_new_tokens=64))
                             for p in prompts]])
        for k, n in launches.items():
            launches_all[k] = launches_all.get(k, 0) + n
        sequential = []
        for i, (p, h) in enumerate(zip(prompts[:8], handles)):
            bucket = next(bk for bk in engine.buckets if bk >= p.size)
            row = np.zeros((1, bucket), np.int64)
            row[0, :p.size] = p
            ref = generate(engine.network, row, 64, prompt_len=[p.size],
                           cache_max_len=engine.max_len,
                           kv_cache_dtype=kv).cpu().numpy()[0]
            if not np.array_equal(ref, h.tokens):
                sequential.append(dict(request=i, first_differing_token=int(
                    np.argmax(ref != h.tokens))))
        worst, stored, bad_w = _weight_bound_check(engine, model)
        top1, gap = _logit_agreement(torch, model, engine.network, ids)
        decode = ("flash_decode_paged" if opts.get("paged")
                  else "flash_decode") + ("_int8" if kv else "")
        _check_served(engine, handles, wall, launches, plain_calls,
                      (decode,), "serve_" + name, card=card,
                      linear_weight_bytes=dict(bf16=lin_bytes,
                                               stored=stored),
                      worst_error_over_step=worst,
                      top1_agreement_vs_bf16=top1,
                      max_logit_gap_vs_bf16=gap,
                      streams_differing_from_sequential_generate=sequential)
        if sequential:
            fail(f"serve_{name}: streams differ from batch-1 generate on "
                 f"the served module: {sequential}")
        if bad_w:
            fail(f"serve_{name}: weights off their step or materialize: "
                 f"{bad_w[:4]}")
        results[name] = engine
    # the decode step, all 8 slots live, bf16 beside w8 and w4
    for name in ("bf16", "w8", "w4"):
        engine = ServingEngine(_serve_config(model)) if name == "bf16" \
            else results[name]
        _decode_step_profile(torch, engine, prompts[8:], attention_ms,
                             "dense_" + name)
    del results
    # Int8ComputeLinear at gpt2-small's fc1 ([rows, 768] x [768, 3072]):
    # the card's int32 accumulators against the CPU's on the same operands
    fc1 = Int8ComputeLinear.from_linear(model.gpt.blocks[0].mlp.fc1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    checks = []
    for rows in (5, 8, 1024):
        x = torch.randn((rows, 768), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        qx, _, acc = fc1.accumulate(x)
        want = int8_matmul(qx.cpu(), fc1.weight_int8.cpu())
        checks.append(dict(rows=rows, equal=bool(torch.equal(acc.cpu(),
                                                              want))))
    say("int8_compute_accumulators", card=card, shape=[768, 3072],
        checks=checks)
    if not all(c["equal"] for c in checks):
        fail(f"int8 compute accumulators differ from the CPU's: {checks}")
    return launches_all


def phase_int8_logits(torch, model):
    """At one 500-token prompt (bucket 512, cache 640): the decode logits
    over the int8 cache against those over the wide cache, and the
    chunked-int8 last-position logits against inline-int8's. Each is
    gated at the JAX package's rule 0.01 * max(1, max|wide|); the wide
    path's own kernel-against-plain noise at the same point is measured
    and, where it is of the rule's size (over a tenth of it), added to
    the gate. Both numbers are printed."""
    import paddle_tpu_torch.generation.attention as cached_mod
    import paddle_tpu_torch.nn.functional.attention as sdpa_mod
    from paddle_tpu_torch.generation.kv_cache import KVCache
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    cfg = model.cfg
    rng = np.random.RandomState(SEED + 6)
    ids = np.zeros((1, 512), np.int64)
    ids[0, :500] = rng.randint(0, cfg.vocab_size, 500)
    ids = torch.as_tensor(ids, device=dev)
    plen = torch.tensor([500], device=dev)
    tok = torch.as_tensor([[rng.randint(cfg.vocab_size)]], device=dev)

    @torch.no_grad()
    def inline(cache_dtype, decode):
        logits, cache = model(ids, use_cache=True, prompt_len=plen,
                              cache_max_len=640, cache_dtype=cache_dtype)
        if decode:
            logits, _ = model(tok, cache=cache)
        return logits.float()

    @torch.no_grad()
    def chunked(cache_dtype):
        cache = KVCache.create(cfg.num_layers, 1, 640, cfg.num_heads,
                               cfg.hidden_size // cfg.num_heads,
                               dtype=torch.bfloat16, device=dev,
                               cache_dtype=cache_dtype)
        for k in range(4):
            kw = dict(prompt_len=plen) if k == 3 else {}
            logits, cache = model(ids[:, k * 128:(k + 1) * 128], cache=cache,
                                  **kw)
        return logits.float()

    def plain(fn, *args):
        with mock.patch.object(sdpa_mod, "flash_attention",
                               fa.flash_attention_plain), \
                mock.patch.object(cached_mod, "flash_attention_decode",
                                  fa.flash_attention_decode_plain):
            return fn(*args)

    def gate(name, out, ref, wide, noise):
        diff = float((out - ref).abs().max())
        rule = 0.01 * max(1.0, float(wide.abs().max()))
        limit = rule + noise if noise > 0.1 * rule else rule
        say("int8_logits", check=name, max_abs_diff=diff, jax_rule=rule,
            wide_kernel_vs_plain_noise=noise, gate=limit)
        if not diff <= limit:
            fail(f"{name}: logits differ by {diff} > {limit}")

    wide = inline(None, True)
    gate("decode_int8_vs_wide", inline("int8", True), wide, wide,
         float((wide - plain(inline, None, True)).abs().max()))
    wide_last = inline(None, False)
    inline_int8 = inline("int8", False)
    gate("chunked_int8_vs_inline_int8", chunked("int8"), inline_int8,
         inline_int8, float((wide_last - plain(inline, None, False))
                            .abs().max()))


def _train_check(torch, phase, model, x, y, dtype, context=None,
                 loss_scale=1.0, config="gpt2-small", layers=12, **fields):
    """One forward and backward of ``model`` on (x, y) through the flash
    kernels and through their plain versions, under ``context`` (a
    function giving a context manager, e.g. an AMP state), the backward
    from the loss times ``loss_scale`` and the gradients divided by it
    again (as ``GradScaler`` runs an fp16 step): the loss within
    TRAIN_LOSS_TOL and every gradient within GRAD_NORM_TOL of its norm
    and GRAD_MAX_TOL of its largest magnitude (the training rule).
    Prints the ``phase`` line; returns the dtypes the forward kernel
    received (the backward kernel takes the tensors it saved). Each of
    the model's ``layers`` launches rows 1 and 4 once."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    context = context or contextlib.nullcontext
    seen = set()
    fwd = fa._forward

    def fwd_spy(q, *a):
        seen.add(str(q.dtype).split(".")[-1])
        return fwd(q, *a)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        with context():
            loss = model.loss(model(x), y)
        (loss * loss_scale).backward()
        grads = {n: p.grad.float() / loss_scale
                 for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    fa.reset_counts()
    with mock.patch.object(fa, "_forward", fwd_spy):
        k_loss, k_grads = loss_and_grads()
    k_counts = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    fa.reset_counts()
    with mock.patch.object(fa, "_forward", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_attention_bwd",
                              fa.flash_attention_bwd_plain):
        p_loss, p_grads = loss_and_grads()
    p_counts = (fa.flash_attention_plain.calls,
                fa.flash_attention_bwd_plain.calls,
                fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    nonfinite = [n for n in k_grads if not (torch.isfinite(k_grads[n]).all()
                                            and torch.isfinite(p_grads[n])
                                            .all())]
    if nonfinite:
        fail(f"{phase}: non-finite gradients {nonfinite[:5]}")
    norm_err, max_err = {}, {}
    for n, g in k_grads.items():
        ref = p_grads[n]
        norm_err[n] = float((g - ref).norm() / ref.norm().clamp_min(1e-30))
        max_err[n] = float((g - ref).abs().max()
                           / ref.abs().max().clamp_min(1e-30))
    worst_norm = max(norm_err, key=norm_err.get)
    worst_max = max(max_err, key=max_err.get)
    say(phase, config=config, dtype=dtype, batch=x.shape[0],
        seq=x.shape[1], **fields, kernel_loss=k_loss, plain_loss=p_loss,
        loss_diff=abs(k_loss - p_loss), loss_tol=TRAIN_LOSS_TOL,
        kernel_launches=list(k_counts), plain_run_counts=list(p_counts),
        worst_grad_norm_err=[worst_norm, norm_err[worst_norm]],
        worst_grad_max_err=[worst_max, max_err[worst_max]],
        grad_tols=[GRAD_NORM_TOL, GRAD_MAX_TOL], params=len(k_grads),
        kernel_input_dtypes=sorted(seen), loss_scale=loss_scale)
    del k_grads, p_grads
    if k_counts != (layers, layers) or p_counts != (layers, layers, 0, 0):
        fail(f"{phase} counts: kernel path {k_counts}, plain path "
             f"{p_counts}")
    if not (math.isfinite(k_loss) and abs(k_loss - p_loss) <= TRAIN_LOSS_TOL):
        fail(f"{phase}: kernel and plain losses {k_loss} / {p_loss}")
    if norm_err[worst_norm] > GRAD_NORM_TOL or \
            max_err[worst_max] > GRAD_MAX_TOL:
        fail(f"{phase}: kernel and plain gradients differ: {worst_norm} "
             f"{norm_err[worst_norm]}, {worst_max} {max_err[worst_max]}")
    return seen


def phase_train(torch):
    """gpt2-small with bench.py's recipe: bf16 params, AdamW(1e-4,
    multi_precision=True), the fused LM-head loss with one saved-logits
    chunk, TrainStep. First one forward and backward at b4 s1024 through
    the kernels and through the plain versions, loss and every gradient
    compared; then 10 TrainSteps at b16 s1024 on one fixed batch."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import gpt
    dev = torch.device("cuda", 0)
    batch, seq = 16, 1024
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(SEED),
                max_position_embeddings=seq, fused_lm_loss=True,
                lm_loss_chunk=seq)
    model.train()
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, model.cfg.vocab_size, (batch, seq)).astype(np.int32)
    x = torch.as_tensor(ids, device=dev)
    y = torch.as_tensor(ids.astype(np.int64), device=dev)

    # -- kernel path against plain path at b4
    _train_check(torch, "train_check", model, x[:4], y[:4], "bfloat16")

    # -- 10 TrainSteps at the flagship shape
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          multi_precision=True)
    step = jit.TrainStep(model, opt, lambda out, lbl: model.loss(out, lbl))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    losses, walls = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd": fa.flash_attention_bwd.launches}
    plain_calls = (fa.flash_attention_plain.calls
                   + fa.flash_attention_bwd_plain.calls)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    wall_ms = float(np.median(walls[1:]))
    tokens_per_s = batch * seq / (wall_ms / 1e3)
    mfu = tokens_per_s * model.flops_per_token(seq) / PEAK_FLOPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    devev = [e for e in prof.key_averages()
             if e.device_time_total > 0 and e.cpu_time_total == 0]
    busy_ms = sum(e.device_time_total for e in devev) / 1e3
    top = sorted(devev, key=lambda e: -e.device_time_total)[:10]
    groups = {"attention (paddle_flash)": 0.0, "GEMM (cuBLAS)": 0.0,
              "other": 0.0}
    for e in devev:
        name = e.key.lower()
        group = ("attention (paddle_flash)" if "paddle_flash" in name else
                 "GEMM (cuBLAS)" if any(t in name for t in (
                     "gemm", "nvjet", "cutlass", "sm90_xmma")) else "other")
        groups[group] += e.device_time_total / 1e3
    say("train", config="gpt2-small", dtype="bfloat16", batch=batch,
        seq=seq, optimizer="AdamW(1e-4, multi_precision=True)",
        losses=losses, step_wall_ms=walls, median_step_ms=wall_ms,
        tokens_per_s=tokens_per_s, mfu=mfu,
        flops_per_token=model.flops_per_token(seq),
        peak_memory_gib=peak / 2 ** 30, launches=launches,
        launches_per_step={k: v / 10 for k, v in launches.items()},
        plain_calls=plain_calls, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        device_launches_per_step=sum(e.count for e in devev),
        device_ms_by_group=groups,
        top_kernels=[dict(name=e.key[:60], ms=e.device_time_total / 1e3,
                          calls=e.count) for e in top])
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"train losses not finite or not falling: {losses}")
    if launches != {"flash_fwd": 120, "flash_bwd": 120}:
        fail(f"train launches {launches}, expected 12 + 12 per step")
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times on the train path")
    return launches, (model, opt, x, y), losses


def phase_train_fused_ops(torch, model, opt, x, y):
    """The path of rows 8-10, on phase_train's gpt2-small after its 10
    TrainSteps, through the public kernel API (the JAX package wires
    these kernels into no layer or optimizer, so neither does the
    port). One b16 s1024 forward and backward captures each of the 25
    LayerNorms' input and output gradient and every parameter's bf16
    gradient. Then, with the counts set to 0: ``fused_layer_norm``
    forward and backward on each captured pair with that LayerNorm's
    weight and bias, and ``fused_adamw_update`` on copies of every fp32
    master and moment of the optimizer at its lr, betas, eps, weight
    decay and next step. Each is gated against its plain version (the
    norms by the training rule, AdamW bit for bit); the gaps to the
    model's own ``F.layer_norm`` and to the port's ``AdamW`` step from
    the same copies are printed, not gated (both round or decay
    otherwise). Last, the AdamW sweep's device span against the port's
    own AdamW step on the same tensors and the bytes bound."""
    from paddle_tpu_torch.core.tensor import plain, plain_grad
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.kernels import fused_adamw as fad
    from paddle_tpu_torch.kernels import fused_norm as fn
    from paddle_tpu_torch.nn.layers_common import LayerNorm
    lns = [(n, m) for n, m in model.named_modules()
           if isinstance(m, LayerNorm)]
    captured = {}

    def hook(name):
        def capture(mod, inputs, out):
            rec = captured[name] = {"x": inputs[0].detach(),
                                    "out": out.detach()}
            out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        return capture

    hooks = [m.register_forward_hook(hook(n)) for n, m in lns]
    model.zero_grad(set_to_none=True)
    model.loss(model(x), y).backward()
    for h in hooks:
        h.remove()
    params = list(opt._parameter_list)
    grads = [plain_grad(p) for p in params]
    model.zero_grad(set_to_none=True)
    states = [opt.state_for(p) for p in params]
    if len(lns) != 25 or any("dy" not in captured[n] for n, _ in lns) or \
            any("master" not in s for s in states):
        fail(f"capture: {len(lns)} LayerNorms, "
             f"{sum('dy' in c for c in captured.values())} gradients")
    captured_bytes = sum(c[k].numel() * c[k].element_size()
                         for c in captured.values() for k in ("x", "dy"))
    hyper = dict(lr=opt.get_lr(), beta1=opt._beta1, beta2=opt._beta2,
                 epsilon=opt._epsilon, weight_decay=opt._weight_decay,
                 step=opt._step_count + 1)

    def copies():
        return [(s["master"].clone(), s["moment1"].clone(),
                 s["moment2"].clone()) for s in states]

    kernel_side = copies()
    torch.cuda.synchronize()
    # -- the path: every count 0 before it, read right after it
    fn.reset_counts()
    fad.reset_counts()
    outs = []
    for name, m in lns:
        c = captured[name]
        xs = c["x"].detach().requires_grad_()
        ws = plain(m.weight).detach().requires_grad_()
        bs = plain(m.bias).detach().requires_grad_()
        yk = fn.fused_layer_norm(xs, ws, bs, m.epsilon)
        outs.append((yk.detach(), *torch.autograd.grad(yk, (xs, ws, bs),
                                                       c["dy"])))
    for (pm, mm, vm), g in zip(kernel_side, grads):
        fad.fused_adamw_update(pm, g, mm, vm, **hyper)
    torch.cuda.synchronize()
    launches = {"norm_fwd": fn.norm_fwd.launches,
                "norm_dx": fn.norm_dx.launches,
                "fused_adamw": fad.fused_adamw_update.launches}
    plain_calls = sum(f.calls for f in fn.PLAIN_VERSIONS) + \
        fad.fused_adamw_update_plain.calls
    if launches != {"norm_fwd": 25, "norm_dx": 25,
                    "fused_adamw": len(params)} or plain_calls:
        fail(f"train_fused_ops launches {launches}, plain calls "
             f"{plain_calls}")

    # -- each LayerNorm against the plain versions
    worst, n_bad, model_gap = {}, 0, 0.0
    for (name, m), (yk, dxk, dwk, dbk) in zip(lns, outs):
        c = captured[name]
        d = c["x"].shape[-1]
        x2, dy2 = c["x"].reshape(-1, d), c["dy"].reshape(-1, d)
        w, b = plain(m.weight).detach(), plain(m.bias).detach()
        refs = (fn.norm_fwd_plain(x2, w, b, m.epsilon, False),
                fn.norm_dx_plain(x2, w, dy2, m.epsilon, False),
                *fn.param_grads(x2, dy2, m.epsilon, False, w.dtype))
        for label, a, r in zip(("y", "dx", "dw", "db"),
                               (yk.reshape(-1, d), dxk.reshape(-1, d), dwk,
                                dbk), refs):
            a, r = a.float(), r.float()
            diff = (a - r).abs()
            lim = ULP_BF16 * r.abs() + SCALED_FRAC * r.abs().max() \
                if label in ("y", "dx") else SUM_FRAC * r.abs().max()
            n_bad += int((~(diff <= lim)).sum())
            worst[label] = max(worst.get(label, 0.0), float(diff.max()))
        model_gap = max(model_gap, float(
            (yk.float() - c["out"].float()).abs().max()))
    del outs, captured

    # -- AdamW: kernel against plain bit for bit, and against AdamW's step
    plain_side = copies()
    for (pm, mm, vm), g in zip(plain_side, grads):
        fad.fused_adamw_update_plain(pm, g, mm, vm, **hyper)
    unequal = [i for i, (a, b) in enumerate(zip(kernel_side, plain_side))
               if not all(torch.equal(u, v) for u, v in zip(a, b))]
    del plain_side
    ref_params = [p.detach().clone() for p in params]
    ref_opt = optimizer.AdamW(hyper["lr"], beta1=hyper["beta1"],
                              beta2=hyper["beta2"],
                              epsilon=hyper["epsilon"],
                              parameters=ref_params,
                              weight_decay=hyper["weight_decay"],
                              multi_precision=True)
    for p, (pm, mm, vm) in zip(ref_params, copies()):
        ref_opt._state[p] = {"moment1": mm, "moment2": vm, "master": pm}
    ref_opt.apply_gradients(ref_params, grads, lr=hyper["lr"],
                            step=hyper["step"])
    adamw_gap = max(float((k[0] - ref_opt._state[p]["master"]).abs().max())
                    for k, p in zip(kernel_side, ref_params))

    # -- the sweep's device span against AdamW's step on the same tensors
    def sweep():
        for (pm, mm, vm), g in zip(kernel_side, grads):
            fad.fused_adamw_update(pm, g, mm, vm, **hyper)

    sweep_ms, sweep_wall = span_ms(torch, sweep)
    step_ms, step_wall = span_ms(torch, lambda: ref_opt.apply_gradients(
        ref_params, grads, lr=hyper["lr"], step=hyper["step"]))
    values = sum(torch.numel(p) for p in params)
    n_bytes = values * 26   # p, m, v r+w; bf16 g
    bms, by = _adamw_bound(values, 4, 2)
    say("train_fused_ops", config="gpt2-small", dtype="bfloat16",
        batch=x.shape[0], seq=x.shape[1], layer_norms=len(lns),
        captured_gib=captured_bytes / 2 ** 30,
        launches=launches, plain_calls=plain_calls,
        norm_max_abs_err=worst, norm_out_of_tol=n_bad,
        norm_tol=f"y/dx {ULP_BF16}*|plain|+{SCALED_FRAC}*max|plain|; "
                 f"dw/db {SUM_FRAC}*max|plain|",
        max_gap_to_model_layer_norm=model_gap,
        adamw_tensors=len(params), adamw_values=values,
        adamw_unequal_to_plain=unequal, hyperparameters=hyper,
        max_master_gap_to_port_adamw=adamw_gap,
        adamw_sweep_ms=sweep_ms, adamw_sweep_host_ms=sweep_wall,
        port_adamw_step_ms=step_ms, port_adamw_step_host_ms=step_wall,
        adamw_bound_ms=bms, adamw_bound_by=by, adamw_bytes=n_bytes)
    if n_bad:
        fail(f"fused_layer_norm disagrees with its plain version on "
             f"{n_bad} elements of the captured LayerNorms")
    if unequal:
        fail(f"fused_adamw_update differs from its plain version on "
             f"parameters {unequal}")
    return launches


# the probe's shapes (experiments/fused_ce_probe.py): (tag, batch, seq)
_PROBE_SHAPES = (("b16-s1024", 16, 1024), ("b32-s1024", 32, 1024),
                 ("b16-s2048", 16, 2048))


def phase_train_fused_ce(torch, model, opt, x, y):
    """The path of rows 11-12, the loss-head probe's
    (``experiments/fused_ce_probe.py``), on phase_train's gpt2-small after
    its 10 TrainSteps: one b16 s1024 forward gives the pair (final hidden
    states, tied wte) that the fused LM loss takes; with the counts set to
    0, ``fused_linear_ce`` on hidden[:, :-1] and the labels [:, 1:] gives
    the mean loss over valid labels and, by autograd, d hidden and d wte.
    Gated against the model's own ``_fused_loss`` on the same pair (its
    saved-logits branch, as the recipe runs it) by the GPT rule. Then the
    probe's table: value and both gradients in ms for the saved-logits
    branch (where b*s*V*4 <= 4 GiB), the chunked branch at lm_loss_chunk
    = max(8192 // b, 128), and the kernel, at b16-s1024 (the trained
    hidden states), b32-s1024 and b16-s2048 (seeded random ones, as the
    probe uses)."""
    from paddle_tpu_torch.core.tensor import plain
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.kernels import fused_linear_ce
    dev = torch.device("cuda", 0)
    cfg = model.cfg
    model.eval()
    with torch.no_grad():
        hidden, wte = model(x)
    model.train()
    hidden, wte = hidden.detach(), plain(wte).detach()
    vocab, hd = wte.shape

    def kernel_loss(hs, ys, w):
        b, s1, _ = hs.shape
        ce = fused_linear_ce(hs.reshape(b * s1, hd), w, ys.reshape(-1))
        valid = (ys >= 0).float()
        return ce.sum() / valid.sum().clamp_min(1.0)

    def value_and_grads(loss_fn, hs, ys, w):
        hg, wg = hs.detach().requires_grad_(), w.detach().requires_grad_()
        loss = loss_fn(hg, ys, wg)
        return (loss.detach(),) + torch.autograd.grad(loss, (hg, wg))

    def branch(chunk, budget):
        def loss_fn(hs, ys, w):
            old = (cfg.lm_loss_chunk, cfg.lm_loss_save_logits_budget)
            cfg.lm_loss_chunk, cfg.lm_loss_save_logits_budget = chunk, budget
            try:       # _fused_loss shifts; pad hs and ys back by one
                return model._fused_loss(
                    torch.nn.functional.pad(hs, (0, 0, 0, 1)),
                    torch.nn.functional.pad(ys, (1, 0), value=-1), w)
            finally:
                cfg.lm_loss_chunk, cfg.lm_loss_save_logits_budget = old
        return loss_fn

    hs, ys = hidden[:, :-1], y[:, 1:]
    torch.cuda.synchronize()
    # -- the path: every count 0 before it, read right after it
    fc.reset_counts()
    k_loss, k_dh, k_dw = value_and_grads(kernel_loss, hs, ys, wte)
    torch.cuda.synchronize()
    launches = {"fused_ce_fwd": fc.ce_fwd.launches,
                "fused_ce_bwd": fc.ce_bwd.launches}
    plain_calls = fc.ce_fwd_plain.calls + fc.ce_bwd_plain.calls
    # the backward launches twice a vocabulary chunk
    chunks = fc.ce_bwd_plan(hs.shape[0] * hs.shape[1], vocab, hd,
                            hidden.element_size())[1]
    if launches != {"fused_ce_fwd": 1, "fused_ce_bwd": 2 * chunks} or \
            plain_calls:
        fail(f"train_fused_ce launches {launches}, plain calls "
             f"{plain_calls}")
    # -- against the model's own loss on the same pair (saved logits)
    r_loss, r_dh, r_dw = value_and_grads(
        lambda h_, y_, w_: model._fused_loss(h_, y_, w_), hidden, y, wte)
    r_dh = r_dh[:, :-1]
    loss_diff = abs(float(k_loss) - float(r_loss))
    errs = {n_: float((a.float() - b.float()).norm()
                      / b.float().norm().clamp_min(1e-30))
            for n_, a, b in (("d_hidden", k_dh, r_dh), ("d_wte", k_dw, r_dw))}
    del r_dh, r_dw, k_dh, k_dw

    # -- the probe's table
    def probe_ms(fn):
        return span_ms(torch, fn, n=3)[0]

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    table = []
    for tag, b, s in _PROBE_SHAPES:
        if (b, s) == tuple(x.shape):
            hb, yb = hs, ys
        else:
            hb = torch.randn(b, s - 1, hd, generator=gen,
                             device=dev).to(hidden.dtype)
            yb = torch.randint(0, vocab, (b, s - 1), generator=gen,
                               device=dev)
        row = dict(shape=tag)
        if b * (s - 1) * vocab * 4 <= 4 << 30:
            row["saved_logits_ms"] = probe_ms(lambda: value_and_grads(
                branch(1 << 30, 4 << 30), hb, yb, wte))
        chunk = max(8192 // b, 128)
        row["chunked_ms"] = probe_ms(lambda: value_and_grads(
            branch(chunk, 0), hb, yb, wte))
        row["chunk"] = chunk
        row["kernel_ms"] = probe_ms(lambda: value_and_grads(
            kernel_loss, hb, yb, wte))
        row["kernel_bound_ms"] = 8 * hb.shape[0] * hb.shape[1] * vocab * hd \
            / PEAK_FLOPS * 1e3
        table.append(row)
        del hb, yb
        torch.cuda.empty_cache()
    say("train_fused_ce", config="gpt2-small", dtype="bfloat16",
        batch=x.shape[0], seq=x.shape[1], kernel_loss=float(k_loss),
        model_loss=float(r_loss), loss_diff=loss_diff,
        loss_tol=TRAIN_LOSS_TOL, grad_norm_err=errs,
        grad_tol=GRAD_NORM_TOL, launches=launches, plain_calls=plain_calls,
        probe=table)
    if not math.isfinite(float(k_loss)) or loss_diff > TRAIN_LOSS_TOL:
        fail(f"fused_linear_ce loss {float(k_loss)} against the model's "
             f"{float(r_loss)}")
    if max(errs.values()) > GRAD_NORM_TOL:
        fail(f"fused_linear_ce gradients against the model's: {errs}")
    return launches


# ResNet-50's stride-1 3x3 convolutions, (H, W, C, O) at 224x224, and
# how many a step runs (the first block of layer2-4 has stride 2)
_RESNET50_STRIDE1_3X3 = (((56, 56, 64, 64), 3), ((28, 28, 128, 128), 3),
                         ((14, 14, 256, 256), 5), ((7, 7, 512, 512), 2))


def phase_train_resnet50(torch):
    """ResNet-50 with bench.py's recipe (bench_resnet50 with
    BENCH_FUSED_BN=1): NHWC, space-to-depth stem, the fused conv+BN
    path, bf16, Momentum(0.1, 0.9, multi_precision=True), cross entropy
    on fp32 logits, TrainStep, batch 128 at 224x224 from seed 0. First
    one forward and backward through the kernels and through the plain
    versions from the same weights, in fp32 and then in bf16 (these
    eager forwards move BN's running statistics); then a warm-up step,
    10 counted TrainSteps (running statistics frozen, as under the JAX
    TrainStep) and one profiled, on the reference's default route (the
    3x3 of the 13 stride-1 blocks through the fused 3x3 kernels), and
    the same once more with the port's ``_PALLAS3X3`` set to False for
    this run (those 3x3s on cuDNN), as the route's yardstick."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.kernels import fused_resnet as fr
    from paddle_tpu_torch.models import resnet as resnet_mod
    dev = torch.device("cuda", 0)
    batch, hw = 128, 224
    model = resnet_mod.resnet50(
        num_classes=1000, data_format="NHWC", stem_space_to_depth=True,
        fused_bn=True, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    model.train()
    rng = np.random.RandomState(SEED)
    img = torch.as_tensor(rng.randn(batch, 3, hw, hw).astype(np.float32),
                          device=dev)
    y = torch.as_tensor(rng.randint(0, 1000, (batch,)).astype(np.int64),
                        device=dev)
    sign = torch.as_tensor(np.sign(rng.randn(batch, 3, hw, hw)),
                           dtype=torch.float32, device=dev)
    ce = nn.CrossEntropyLoss()

    def loss_fn(logits, labels):
        return ce(logits.float(), labels)

    def running():
        return {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith(("._mean", "._variance"))}

    def loss_and_grads(x, plain=False):
        patch = {f.__name__: p for f, p in zip(fr.KERNEL_WRAPPERS,
                                                fr.PLAIN_VERSIONS)}
        with (mock.patch.multiple(fr, **patch) if plain
              else contextlib.nullcontext()):
            model.zero_grad(set_to_none=True)
            loss = loss_fn(model(x), y)
            loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    def gaps(a, b):
        return {n: float((g - b[n]).norm() / b[n].norm().clamp_min(1e-30))
                for n, g in a.items()}

    names = [r[0] for r in _FUSED_ROWS + _CONV3_ROWS]
    # 16 blocks: conv1 + 4 downsamples, conv3; the 3x3 of the 13 stride-1
    # blocks (the first block of layer2-4 has stride 2: cuDNN)
    per_step = [20, 16, 20, 16, 13, 13]
    before = running()
    for dtype, ulp in ((torch.float32, 2.0 ** -23), (torch.bfloat16,
                                                     2.0 ** -8)):
        model.to(dtype)
        x = img.to(dtype)
        fr.reset_counts()
        k_loss, k_grads = loss_and_grads(x)
        k_counts = [f.launches for f in fr.KERNEL_WRAPPERS]
        if dtype is torch.float32:
            after = running()
        fr.reset_counts()
        p_loss, p_grads = loss_and_grads(x, plain=True)
        p_counts = [f.calls for f in fr.PLAIN_VERSIONS] + \
            [f.launches for f in fr.KERNEL_WRAPPERS]
        # the plain path against itself under +-1-ulp input noise: the
        # gradients' own conditioning floor (as tests/test_fused_resnet.py
        # measures it for the JAX package)
        _, n_grads = loss_and_grads((img * (1 + ulp * sign)).to(dtype),
                                    plain=True)
        gap, chaos = gaps(k_grads, p_grads), gaps(n_grads, p_grads)
        over = {n: gap[n] / max(RESNET_GRAD_TOL, 4 * chaos[n]) for n in gap}
        worst = max(over, key=over.get)
        strict = dtype is torch.float32
        say("resnet50_train_check", config="resnet50 NHWC s2d fused_bn",
            dtype=str(dtype).split(".")[-1], batch=batch, image=hw,
            kernel_loss=k_loss, plain_loss=p_loss,
            loss_diff=abs(k_loss - p_loss), loss_tol=RESNET_LOSS_TOL,
            kernel_launches=dict(zip(names, k_counts)),
            plain_run_counts=p_counts,
            grad_gap_median=float(np.median(list(gap.values()))),
            grad_gap_max=max(gap.values()),
            grad_chaos_median=float(np.median(list(chaos.values()))),
            grad_chaos_max=max(chaos.values()),
            worst=[worst, gap[worst], chaos[worst]],
            grad_tol=(f"{RESNET_GRAD_TOL}" if strict else
                      f"max({RESNET_GRAD_TOL}, 4*chaos)"),
            params=len(k_grads))
        del k_grads, p_grads, n_grads
        if k_counts != per_step or p_counts != per_step + [0] * 6:
            fail(f"resnet50 check counts: kernel path {k_counts}, plain "
                 f"path {p_counts}")
        if not (math.isfinite(k_loss)
                and abs(k_loss - p_loss) <= RESNET_LOSS_TOL):
            fail(f"resnet50 kernel and plain losses {k_loss} / {p_loss}")
        if (max(gap.values()) > RESNET_GRAD_TOL) if strict else \
                over[worst] > 1.0:
            fail(f"resnet50 kernel and plain gradients differ in {dtype}: "
                 f"{worst} {gap[worst]} (chaos {chaos[worst]})")
    means_moved = sum(not torch.equal(before[k], after[k].to(before[k]))
                      for k in before if k.endswith("_mean"))
    say("resnet50_running_stats", bn_layers=len(before) // 2,
        means_moved_by_eager_forward=means_moved)
    if means_moved != len(before) // 2:
        fail(f"an eager training forward moved {means_moved} of "
             f"{len(before) // 2} BN running means")
    x = img.to(torch.bfloat16)
    del img, sign
    torch.cuda.empty_cache()

    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters(),
                             multi_precision=True)
    step = jit.TrainStep(model, opt, loss_fn)

    def timed_steps(route):
        """A warm-up step, 10 counted TrainSteps and one profiled."""
        step(x, y)
        torch.cuda.synchronize()
        before = running()
        torch.cuda.reset_peak_memory_stats()
        fr.reset_counts()
        losses, walls = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            losses.append(step(x, y))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = {n: f.launches for n, f in zip(names, fr.KERNEL_WRAPPERS)}
        plain_calls = sum(f.calls for f in fr.PLAIN_VERSIONS)
        peak = torch.cuda.max_memory_allocated()
        frozen = all(torch.equal(before[k], v) for k, v in running().items())
        losses = [float(v) for v in losses]
        wall_ms = float(np.median(walls))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(x, y)
            torch.cuda.synchronize()
        devev = [e for e in prof.key_averages()
                 if e.device_time_total > 0 and e.cpu_time_total == 0]
        busy_ms = sum(e.device_time_total for e in devev) / 1e3
        groups = dict.fromkeys((
            "fused 1x1 (csrc/fused_resnet.cu)",
            "fused 3x3 (csrc/fused_conv3x3.cu)",
            "fixed-order column totals (both)", "conv (cuDNN)",
            "GEMM (cuBLAS)", "other"), 0.0)
        for e in devev:
            key = e.key.lower()
            tap = (_gemm_args(e.key) or [])[3:] == ["true"]
            group = ("fused 3x3 (csrc/fused_conv3x3.cu)" if tap or any(
                        t in key for t in ("conv3x3", "tilecounts",
                                           "rowtilepixels")) else
                     "fused 1x1 (csrc/fused_resnet.cu)" if any(
                        t in key for t in ("mm_stats", "rowtiles")) else
                     "fixed-order column totals (both)"
                     if "column_total" in key or "chunk_total" in key else
                     "conv (cuDNN)" if any(t in key for t in (
                         "conv", "cudnn", "implicit", "wgrad", "dgrad")) else
                     "GEMM (cuBLAS)" if any(t in key for t in (
                         "gemm", "nvjet", "cutlass", "sm90_xmma")) else
                     "other")
            groups[group] += e.device_time_total / 1e3
        # the profiled step's fused 3x3 forwards by route: the GEMM
        # route's tile body (Kind 0, tap) or the window kernel
        fwd3 = {"gemm": 0, "window": 0}
        for e in devev:
            args = _gemm_args(e.key) or []
            if args[1:2] == ["0"] and args[3:] == ["true"]:
                fwd3["gemm"] += e.count
            elif "conv3x3_kernel<" in e.key and _template_args(
                    e.key, "conv3x3_kernel<")[1] == "false":
                fwd3["window"] += e.count
        top = sorted(devev, key=lambda e: -e.device_time_total)[:12]
        say("train_resnet50", config="resnet50 NHWC s2d fused_bn",
            route=route, dtype="bfloat16", batch=batch, image=hw,
            optimizer="Momentum(0.1, 0.9, multi_precision=True)",
            losses=losses, step_wall_ms=walls, median_step_ms=wall_ms,
            images_per_s=batch / (wall_ms / 1e3),
            peak_memory_gib=peak / 2 ** 30, launches=launches,
            launches_per_step={k: v / 10 for k, v in launches.items()},
            plain_calls=plain_calls, running_stats_frozen=frozen,
            device_busy_ms=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            device_launches_per_step=sum(e.count for e in devev),
            device_ms_by_group=groups,
            fused_3x3_forwards_by_route=fwd3,
            top_kernels=[dict(name=e.key[:60], ms=e.device_time_total / 1e3,
                              calls=e.count) for e in top])
        if not all(math.isfinite(v) for v in losses):
            fail(f"resnet50 train losses not finite ({route}): {losses}")
        if plain_calls:
            fail(f"plain versions ran {plain_calls} times on the resnet50 "
                 f"path ({route})")
        if not frozen:
            fail(f"TrainStep moved BN running statistics ({route})")
        return launches, wall_ms, fwd3, dict(losses=losses, wall_ms=wall_ms,
                                             peak_gib=peak / 2 ** 30)

    # the 13 stride-1 3x3s of a step, by the route their forward takes
    want3 = {"gemm": 0, "window": 0}
    for (h3, w3, c3, o3), k in _RESNET50_STRIDE1_3X3:
        want3[fr._conv3x3_route(h3, w3, c3, o3)] += k
    # the main path: the reference's default route, the fused 3x3 kernels
    launches, on_ms, fwd3, fused_run = timed_steps("fused 3x3 kernels")
    if list(launches.values()) != [10 * c for c in per_step]:
        fail(f"resnet50 train launches {launches}, expected {per_step} "
             "per step")
    if fwd3 != want3:
        fail(f"resnet50 3x3 forwards by route {fwd3}, expected {want3}")
    # the yardstick: the same recipe with the 3x3s on cuDNN, the port's
    # own switch set for this run only
    with mock.patch.object(resnet_mod, "_PALLAS3X3", False):
        off, off_ms, off3, _ = timed_steps("cuDNN 3x3 (_PALLAS3X3 False)")
    if list(off.values()) != [10 * c for c in per_step[:4]] + [0, 0] or \
            any(off3.values()):
        fail(f"resnet50 cuDNN-route launches {off}, {off3}")
    say("resnet50_3x3_route", fused_step_ms=on_ms,
        fused_images_per_s=batch / (on_ms / 1e3), cudnn_step_ms=off_ms,
        cudnn_images_per_s=batch / (off_ms / 1e3))
    return launches, fused_run


# ------------------------------------------------------------- training, A4

def _gpt_steps(torch, label, steps=10, batch=16, dtype=None, model_kw=None,
               step_kw=None, opt_kw=None, context=None, prepare=None,
               between=None):
    """``steps`` TrainSteps of gpt2-small from SEED on one fixed batch
    (``phase_train``'s recipe unless overridden), each timed to its
    synchronize, then one profiled step. ``prepare(model)`` runs before
    the optimizer is built, ``between(opt)`` after each timed step.
    Returns the run's numbers, the model and the optimizer."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.nn.functional import attention as att
    dev = torch.device("cuda", 0)
    seq = 1024
    dtype = torch.bfloat16 if dtype is None else dtype
    model = gpt("gpt2-small", device=dev, dtype=dtype,
                generator=torch.Generator(device=dev).manual_seed(SEED),
                max_position_embeddings=seq, fused_lm_loss=True,
                lm_loss_chunk=seq, **(model_kw or {}))
    model.train()
    if prepare is not None:
        prepare(model)
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, model.cfg.vocab_size, (16, seq)).astype(np.int32)
    x = torch.as_tensor(ids[:batch], device=dev)
    y = torch.as_tensor(ids[:batch].astype(np.int64), device=dev)
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          **(dict(multi_precision=True) if opt_kw is None
                             else opt_kw))
    step = jit.TrainStep(model, opt, lambda out, lbl: model.loss(out, lbl),
                         **(step_kw or {}))
    context = context or contextlib.nullcontext
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    xla0 = att.sdpa_xla.calls
    losses, walls, checks = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with context():
            losses.append(step(x, y))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if between is not None:
            checks.append(between(opt))
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd": fa.flash_attention_bwd.launches}
    plain_calls = (fa.flash_attention_plain.calls
                   + fa.flash_attention_bwd_plain.calls)
    xla_calls = att.sdpa_xla.calls - xla0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    wall_ms = float(np.median(walls[1:]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with context():
            step(x, y)
        torch.cuda.synchronize()
    busy_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_time_total > 0 and e.cpu_time_total == 0) / 1e3
    run = dict(run=label, batch=batch, seq=seq,
               dtype=str(dtype).split(".")[-1], losses=losses,
               step_wall_ms=walls, median_step_ms=wall_ms,
               tokens_per_s=batch * seq / (wall_ms / 1e3),
               peak_memory_gib=peak / 2 ** 30, launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               plain_calls=plain_calls, sdpa_xla_calls=xla_calls,
               device_busy_ms=busy_ms,
               device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms))
    return run, model, opt, checks


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_train_recompute(torch, train_losses):
    """Recompute on ``phase_train``'s recipe (gpt2-small bf16, AdamW with
    fp32 masters, the saved-logits fused loss, b16 s1024, 10 TrainSteps
    from SEED): ``use_recompute`` with the "selective" and the "full"
    granularity, and ``TrainStep(recompute="full")``. Each step's loss is
    held to ``phase_train``'s within TRAIN_LOSS_TOL (and printed as
    bitwise equal or not); the flash forward launches twice a block (24
    a step), the backward once (12). Then, at b4 with dropout 0.1, one
    eager forward and backward with "full" recompute and one without,
    from the same generator state: every gradient bitwise equal (the
    recompute puts the port's generators back), attention on sdpa_xla
    and no flash launch, as the reference routes dropout."""
    from paddle_tpu_torch import seed as port_seed
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.nn.functional import attention as att
    total = {}
    for label, model_kw, step_kw in (
            ("selective", dict(use_recompute=True,
                               recompute_granularity="selective"), None),
            ("full", dict(use_recompute=True,
                          recompute_granularity="full"), None),
            ("trainstep_full", None, dict(recompute="full"))):
        run, model, opt, _ = _gpt_steps(torch, label, model_kw=model_kw,
                                        step_kw=step_kw)
        gaps = [abs(a - b) for a, b in zip(run["losses"], train_losses)]
        say("train_recompute", config="gpt2-small", **run,
            max_loss_gap_to_train=max(gaps), loss_tol=TRAIN_LOSS_TOL,
            bitwise_equal_to_train=run["losses"] == train_losses)
        _add(total, run["launches"])
        del model, opt
        torch.cuda.empty_cache()
        if max(gaps) > TRAIN_LOSS_TOL:
            fail(f"train_recompute {label}: losses {run['losses']} against "
                 f"train {train_losses}")
        if run["launches"] != {"flash_fwd": 240, "flash_bwd": 120}:
            fail(f"train_recompute {label}: launches {run['launches']}, "
                 "expected 24 + 12 a step")
        if run["plain_calls"] or run["sdpa_xla_calls"]:
            fail(f"train_recompute {label}: plain {run['plain_calls']}, "
                 f"sdpa_xla {run['sdpa_xla_calls']}")

    # -- dropout 0.1 at b4: recompute against none from one generator state
    dev = torch.device("cuda", 0)
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(SEED),
                fused_lm_loss=True, lm_loss_chunk=1024, dropout=0.1)
    model.train()
    ids = np.random.RandomState(SEED).randint(0, model.cfg.vocab_size,
                                              (4, 1024))
    x = torch.as_tensor(ids, device=dev)

    def grads(recompute):
        model.cfg.use_recompute = recompute
        model.cfg.recompute_granularity = "full"
        model.zero_grad(set_to_none=True)
        port_seed(SEED)
        loss = model.loss(model(x), x)
        loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}

    fa.reset_counts()
    xla0 = att.sdpa_xla.calls
    ref_loss, ref = grads(False)
    got_loss, got = grads(True)
    torch.cuda.synchronize()
    xla_calls = att.sdpa_xla.calls - xla0
    flash = fa.flash_attention.launches + fa.flash_attention_bwd.launches
    unequal = [n for n in ref if not torch.equal(ref[n], got[n])]
    say("train_recompute_dropout", config="gpt2-small dropout 0.1",
        batch=4, seq=1024, loss=ref_loss, recompute_loss=got_loss,
        grads_bitwise_equal=not unequal, unequal=unequal[:5],
        params=len(ref), sdpa_xla_calls=xla_calls, flash_launches=flash)
    del model, ref, got
    torch.cuda.empty_cache()
    if unequal or got_loss != ref_loss:
        fail(f"recompute with dropout changed {len(unequal)} gradients "
             f"(loss {got_loss} vs {ref_loss})")
    # 12 blocks without recompute, 12 + 12 recomputed with it
    if xla_calls != 36 or flash:
        fail(f"dropout routing: sdpa_xla {xla_calls} (expected 36), "
             f"flash launches {flash}")
    return total


def phase_train_offload(torch):
    """``phase_train``'s recipe with ``offload_opt_state=True`` against
    the same run with the state resident, 10 steps each (and a profiled
    one): losses and final parameters bitwise equal, and between steps
    every state tensor (moments, fp32 masters) on the host and pinned.
    Prints each run's peak device memory and step wall."""
    def parked(opt):
        return all(t.device.type == "cpu" and t.is_pinned()
                   for st in opt._state.values() for t in st.values())

    total, runs = {}, {}
    for label, kw in (("resident", None),
                      ("offload", dict(offload_opt_state=True))):
        run, model, opt, checks = _gpt_steps(torch, label, step_kw=kw,
                                             between=parked)
        state = sum(t.numel() * t.element_size()
                    for st in opt._state.values() for t in st.values())
        runs[label] = (run, [p.detach().clone() for p in model.parameters()])
        say("train_offload", config="gpt2-small", **run,
            state_pinned_between_steps=checks,
            optimizer_state_gib=state / 2 ** 30)
        _add(total, run["launches"])
        if kw and not all(checks):
            fail(f"offloaded optimizer state not pinned on the host: "
                 f"{checks}")
        del model, opt
        torch.cuda.empty_cache()
    (r0, p0), (r1, p1) = runs["resident"], runs["offload"]
    same_params = all(torch.equal(a, b) for a, b in zip(p0, p1))
    say("train_offload_compare", losses_bitwise=r1["losses"] == r0["losses"],
        params_bitwise=same_params,
        peak_memory_saved_gib=r0["peak_memory_gib"] - r1["peak_memory_gib"],
        step_ms_added=r1["median_step_ms"] - r0["median_step_ms"])
    if r1["losses"] != r0["losses"] or not same_params:
        fail("offloaded state gave other losses or parameters than "
             "resident state")
    if r1["launches"] != {"flash_fwd": 120, "flash_bwd": 120} or \
            r1["plain_calls"]:
        fail(f"train_offload launches {r1['launches']}, plain "
             f"{r1['plain_calls']}")
    return total


def phase_train_amp(torch):
    """AMP through rows 1-4. (a) O1: gpt2-small with fp32 weights under
    ``auto_cast()`` (bf16), fp32 AdamW, first the kernel path against
    the plain path at b4 (the training rule), then 10 TrainSteps at b16
    s1024: the flash kernels receive bf16, launch 12 + 12 a step, no
    sdpa_xla call, losses finite and falling. (b) O2:
    ``decorate(level="O2", dtype="float16")``, AdamW with fp32 masters
    and ``GradScaler()`` (2^15), the fp16 kernels against their plain
    versions at b4, then 20 eager steps at b4 s1024 (``scale(loss)
    .backward()``, ``step``): losses finite and falling over the applied
    steps, at least one applied."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.profiler import metrics
    total = {}

    def o1():
        return amp.auto_cast()

    holder = {}

    def check_o1(model):
        rng = np.random.RandomState(SEED)
        ids = torch.as_tensor(rng.randint(0, model.cfg.vocab_size,
                                          (4, 1024)), device="cuda")
        holder["seen"] = _train_check(torch, "train_amp_check", model, ids,
                                      ids, "float32 weights, O1 bfloat16",
                                      context=o1, level="O1")

    run, model, opt, _ = _gpt_steps(torch, "O1 bfloat16",
                                    dtype=torch.float32, opt_kw={},
                                    context=o1, prepare=check_o1)
    losses = run["losses"]
    say("train_amp", config="gpt2-small", level="O1",
        optimizer="AdamW(1e-4) fp32", **run,
        kernel_input_dtypes=sorted(holder["seen"]))
    _add(total, run["launches"])
    del model, opt
    torch.cuda.empty_cache()
    if holder["seen"] != {"bfloat16"}:
        fail(f"O1: the flash forward received {holder['seen']}")
    if run["launches"] != {"flash_fwd": 120, "flash_bwd": 120} or \
            run["plain_calls"] or run["sdpa_xla_calls"]:
        fail(f"O1 launches {run['launches']}, plain {run['plain_calls']}, "
             f"sdpa_xla {run['sdpa_xla_calls']}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"O1 losses not finite or not falling: {losses}")

    # -- (b) O2 in fp16 with the GradScaler, eager
    from paddle_tpu_torch.models.gpt import gpt
    dev = torch.device("cuda", 0)
    model = gpt("gpt2-small", device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED),
                fused_lm_loss=True, lm_loss_chunk=1024)
    amp.decorate(model, level="O2", dtype="float16")
    model.train()
    ids = np.random.RandomState(SEED).randint(0, model.cfg.vocab_size,
                                              (4, 1024))
    x = torch.as_tensor(ids, device=dev)

    def o2():
        return amp.auto_cast(level="O2", dtype="float16")

    # the backward from the loss scaled as the O2 steps scale it: without
    # it the last blocks' fp16 gradients fall below fp16's normal range
    # (6.1e-5), where the two versions' roundings differ by whole
    # subnormal steps (5.3e-2 of a norm unscaled, on an H100)
    scaler = amp.GradScaler()
    seen = _train_check(torch, "train_amp_check", model, x, x,
                        "float16 (O2)", context=o2,
                        loss_scale=scaler.get_loss_scaling(), level="O2")
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          multi_precision=True)
    metrics.enable()
    was = {k: v["value"] for k, v in metrics.snapshot().items()
           if k.startswith("amp.")}
    fa.reset_counts()
    losses, scales, skipped, walls = [], [], [], []
    try:
        for i in range(20):
            t0 = time.perf_counter()
            with o2():
                loss = model.loss(model(x), x)
            scaler.scale(loss).backward()
            scales.append(scaler.get_loss_scaling())
            scaler.step(opt)
            opt.clear_grad()
            losses.append(loss.item())
            walls.append((time.perf_counter() - t0) * 1e3)
            if scaler._found_inf:
                skipped.append(i)
        snap = {k: v["value"] for k, v in metrics.snapshot().items()
                if k.startswith("amp.")}
    finally:
        metrics.disable()
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd": fa.flash_attention_bwd.launches}
    plain = fa.flash_attention_plain.calls + \
        fa.flash_attention_bwd_plain.calls
    applied = [v for i, v in enumerate(losses) if i not in skipped]
    say("train_amp", config="gpt2-small", level="O2", dtype="float16",
        optimizer="AdamW(1e-4, multi_precision=True) + GradScaler()",
        batch=4, seq=1024, losses=losses, scale_before_step=scales,
        final_scale=scaler.get_loss_scaling(), skipped_steps=skipped,
        amp_metrics=snap, amp_metrics_before=was, launches=launches,
        plain_calls=plain, median_step_ms=float(np.median(walls[1:])),
        kernel_input_dtypes=sorted(seen), scaler_state=scaler.state_dict())
    _add(total, launches)
    del model, opt
    torch.cuda.empty_cache()
    if seen != {"float16"}:
        fail(f"O2: the flash forward received {seen}")
    if not applied or not all(math.isfinite(v) for v in losses) or \
            applied[-1] >= applied[0]:
        fail(f"O2 losses not finite or not falling over the applied "
             f"steps: {losses}, skipped {skipped}")
    if launches != {"flash_fwd": 240, "flash_bwd": 240} or plain:
        fail(f"O2 launches {launches}, plain {plain}")
    if snap.get("amp.scaler.steps", 0) - was.get("amp.scaler.steps", 0) \
            != 20 or snap.get("amp.scaler.skipped", 0) \
            - was.get("amp.scaler.skipped", 0) != len(skipped):
        fail(f"amp.scaler metrics {snap} (before {was}), skipped {skipped}")
    return total


def phase_train_qat(torch):
    """``QAT().quantize`` on ``phase_train``'s gpt2-small (bf16, AdamW
    with fp32 masters, fused loss), 5 TrainSteps at b4 s1024: 48
    ``QuantedLinear``s (the 12 blocks' qkv, out, fc1, fc2; the tied head
    is no Linear), the flash kernels 12 + 12 a step, losses finite; after
    ``QAT.convert`` the model's logits equal those of a plain model that
    carries the same trained weights."""
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.quantization import QAT, QuantedLinear
    holder = {}

    def quantize(model):
        QAT().quantize(model)
        holder["wrapped"] = sum(isinstance(m, QuantedLinear)
                                for m in model.modules())

    run, model, opt, _ = _gpt_steps(torch, "qat", steps=5, batch=4,
                                    prepare=quantize)
    dev = torch.device("cuda", 0)
    QAT.convert(model)
    plain = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                max_position_embeddings=1024, fused_lm_loss=True,
                lm_loss_chunk=1024)
    plain.load_state_dict(model.state_dict())
    x = torch.as_tensor(np.random.RandomState(SEED).randint(
        0, model.cfg.vocab_size, (2, 1024)), device=dev)
    model.eval()
    plain.eval()
    with torch.no_grad():
        got = model._logits(model.gpt(x))
        ref = plain._logits(plain.gpt(x))
    equal = torch.equal(got, ref)
    left = sum(isinstance(m, QuantedLinear) for m in model.modules())
    say("train_qat", config="gpt2-small", **run,
        quanted_linears=holder["wrapped"], left_after_convert=left,
        converted_logits_equal_plain=equal)
    del model, opt, plain
    torch.cuda.empty_cache()
    if holder["wrapped"] != 48 or left:
        fail(f"QAT wrapped {holder['wrapped']} Linears ({left} left after "
             "convert), expected 48")
    if run["launches"] != {"flash_fwd": 60, "flash_bwd": 60} or \
            run["plain_calls"]:
        fail(f"train_qat launches {run['launches']}, plain "
             f"{run['plain_calls']}")
    if not all(math.isfinite(v) for v in run["losses"]):
        fail(f"train_qat losses not finite: {run['losses']}")
    if not equal:
        fail("converted QAT model's logits differ from the plain model's")
    return dict(run["launches"])


def phase_train_resnet50_recompute(torch, ref):
    """``phase_train_resnet50``'s fused recipe (NHWC, space-to-depth
    stem, fused BN, bf16, Momentum with fp32 masters, b128 224x224 from
    SEED) with ``recompute_stages=(1, 2)``, the bandwidth-bound early
    stages: a warm-up step and 10 counted TrainSteps. The losses within
    RESNET_LOSS_TOL of the ``train_resnet50`` run's (and printed as
    bitwise equal or not), BN running statistics unchanged by the steps,
    each kernel's launches those of a step plus the forward kernels of
    the recomputed blocks, no plain version."""
    from paddle_tpu_torch import jit, nn, optimizer
    from paddle_tpu_torch.kernels import fused_resnet as fr
    from paddle_tpu_torch.models import resnet as resnet_mod
    dev = torch.device("cuda", 0)
    batch, hw, stages = 128, 224, (1, 2)
    model = resnet_mod.resnet50(
        num_classes=1000, data_format="NHWC", stem_space_to_depth=True,
        fused_bn=True, recompute_stages=stages, device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    model.to(torch.float32).to(torch.bfloat16)
    model.train()
    rng = np.random.RandomState(SEED)
    img = rng.randn(batch, 3, hw, hw).astype(np.float32)
    y = torch.as_tensor(rng.randint(0, 1000, (batch,)).astype(np.int64),
                        device=dev)
    x = torch.as_tensor(img, device=dev).to(torch.bfloat16)
    ce = nn.CrossEntropyLoss()
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters(),
                             multi_precision=True)
    step = jit.TrainStep(model, opt, lambda lg, lbl: ce(lg.float(), lbl))
    # a step's launches (phase_train_resnet50) plus each recomputed
    # block's forward kernels: conv1 (+ the downsample), conv3, and the
    # fused 3x3 of a stride-1 block
    want = [20, 16, 20, 16, 13, 13]
    for i in stages:
        for blk in getattr(model, f"layer{i}"):
            want[0] += 1 + (blk.downsample is not None)
            want[1] += 1
            want[4] += resnet_mod._stride0(blk.conv2) == 1
    names = [r[0] for r in _FUSED_ROWS + _CONV3_ROWS]

    def running():
        return {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith(("._mean", "._variance"))}

    step(x, y)
    torch.cuda.synchronize()
    before = running()
    torch.cuda.reset_peak_memory_stats()
    fr.reset_counts()
    losses, walls = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {n: f.launches for n, f in zip(names, fr.KERNEL_WRAPPERS)}
    plain_calls = sum(f.calls for f in fr.PLAIN_VERSIONS)
    peak = torch.cuda.max_memory_allocated()
    frozen = all(torch.equal(before[k], v) for k, v in running().items())
    losses = [float(v) for v in losses]
    wall_ms = float(np.median(walls))
    gaps = [abs(a - b) for a, b in zip(losses, ref["losses"])]
    say("train_resnet50_recompute", config="resnet50 NHWC s2d fused_bn",
        recompute_stages=list(stages), dtype="bfloat16", batch=batch,
        image=hw, losses=losses, step_wall_ms=walls, median_step_ms=wall_ms,
        images_per_s=batch / (wall_ms / 1e3), peak_memory_gib=peak / 2 ** 30,
        without_recompute=dict(median_step_ms=ref["wall_ms"],
                               images_per_s=batch / (ref["wall_ms"] / 1e3),
                               peak_memory_gib=ref["peak_gib"]),
        max_loss_gap=max(gaps), loss_tol=RESNET_LOSS_TOL,
        bitwise_equal_to_train_resnet50=losses == ref["losses"],
        launches=launches,
        launches_per_step={k: v / 10 for k, v in launches.items()},
        expected_per_step=want, plain_calls=plain_calls,
        running_stats_frozen=frozen)
    del model, opt, step, x
    torch.cuda.empty_cache()
    if max(gaps) > RESNET_LOSS_TOL or not all(map(math.isfinite, losses)):
        fail(f"resnet50 recompute losses {losses} against {ref['losses']}")
    if not frozen:
        fail("recomputed BN blocks moved the running statistics")
    if list(launches.values()) != [10 * c for c in want]:
        fail(f"resnet50 recompute launches {launches}, expected {want} "
             "per step")
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times on the resnet50 "
             "recompute path")
    return launches


# ------------------------------------------------------ ERNIE and BERT

#: bench.py's two MLM + SOP rows (``_mlm_bench``): phase, configuration,
#: batch; sequence 512, bf16, AdamW(1e-4, multi_precision=True), the
#: fused MLM loss over max(int(512 * 0.19), 8) = 97 gathered positions
ERNIE_SEQ = 512
ERNIE_RUNS = (("train_ernie_base", "ernie-3.0-base", 32),
              ("train_bert_large", "bert-large", 16))


def phase_ernie_kernels(torch, timer):
    """Rows 1-4 non-causal at ERNIE's and BERT's training shapes, q, k,
    v [32, 512, 12, 64] and [16, 512, 16, 64] bf16 (views of one fused
    qkv buffer, as the model gives them): the forward with its LSE and
    the backward against their plain versions by the training rule,
    then both timed beside SDPA's. Returns the timings by shape."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    bf16 = torch.bfloat16
    out_rows = {}
    for (_, name, b), h in zip(ERNIE_RUNS, (12, 16)):
        s, d = ERNIE_SEQ, 64

        def inputs():
            q, k, v = torch.randn((b, s, 3, h, d), generator=gen,
                                  device=dev).to(bf16).unbind(2)
            out, lse = fa.flash_attention(q, k, v, causal=False,
                                          return_lse=True)
            do = torch.randn((b, s, h, d), generator=gen,
                             device=dev).to(bf16)
            return q, k, v, out, lse, do
        q, k, v, out, lse, do = inputs()
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal=False,
                                                    return_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, False)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, False)
        torch.cuda.synchronize()
        errs = {"out": _err_scaled(out, ref_out),
                "lse": _err(lse, ref_lse, LSE_ATOL, LSE_RTOL)}
        errs.update({n: _err_scaled(a, r) for n, a, r in
                     zip(("dq", "dk", "dv"), grads, ref)})
        shape = [b, s, h, d]
        say("kernel_check", kernel="flash_fwd+flash_bwd", config=name,
            shape=shape, causal=False, dtype="bfloat16",
            route=fa.route(bf16, d),
            max_abs_err={n: e[0] for n, e in errs.items()},
            tol=f"{ULP_BF16}*|plain|+{SCALED_FRAC}*max|plain| per tensor; "
                f"lse {LSE_ATOL}+{LSE_RTOL}*|plain|",
            out_of_tol={n: e[1] for n, e in errs.items()})
        if any(e[1] for e in errs.values()):
            fail(f"non-causal flash kernels disagree with their plain "
                 f"versions at {shape}")
        del q, k, v, out, lse, do, grads, ref, ref_out, ref_lse
        sets = [inputs() for _ in range(3)]
        fwd_ms = timer.ms(lambda q, k, v: fa.flash_attention(
            q, k, v, causal=False), [st[:3] for st in sets])
        bwd_ms = timer.ms(lambda q, k, v, o, l, do: fa.flash_attention_bwd(
            q, k, v, o, l, do, False), sets)
        lib = []
        for q, k, v, _, _, do in sets:
            qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            lib.append((qh, kh, vh, do.transpose(1, 2).contiguous()))
        fwd_lib = timer.ms(lambda q, k, v, do: TF.scaled_dot_product_attention(
            q, k, v), lib)
        outs = [(TF.scaled_dot_product_attention(q, k, v), (q, k, v), do)
                for q, k, v, do in lib]
        bwd_lib = timer.ms(lambda o, ins, do: torch.autograd.grad(
            o, ins, do, retain_graph=True), outs)
        elems = b * s * h * d
        pairs = b * h * s * s
        fb = bound_ms(4 * elems * 2, 4 * pairs * d)
        bb = bound_ms(8 * elems * 2 + 2 * b * h * s * 4, 10 * pairs * d)
        out_rows[name] = dict(
            shape=f"q,k,v [{b},{s},{h},{d}] bf16 non-causal",
            fwd=dict(ms=fwd_ms, library_ms=fwd_lib, bound_ms=fb[0],
                     bound_by=fb[1]),
            bwd=dict(ms=bwd_ms, library_ms=bwd_lib, bound_ms=bb[0],
                     bound_by=bb[1]))
        say("kernel_time", kernel="flash_fwd+flash_bwd", config=name,
            **out_rows[name])
        del sets, lib, outs
        torch.cuda.empty_cache()
    return out_rows


def _ernie_batch(torch, model, batch, seq):
    """bench.py ``_mlm_bench``'s batch: ids from RandomState(0), MLM
    labels at 15% of positions (-100 elsewhere), SOP labels."""
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, model.cfg.vocab_size, (batch, seq)).astype(np.int32)
    mlm = ids.astype(np.int64)
    mlm[rng.rand(*mlm.shape) > 0.15] = -100
    sop = rng.randint(0, 2, (batch,)).astype(np.int64)
    return (torch.as_tensor(ids, device=dev),
            (torch.as_tensor(mlm, device=dev),
             torch.as_tensor(sop, device=dev)))


def _device_profile(torch, fn):
    """One call of ``fn`` under the profiler: device busy ms, launches,
    and the ten kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    devev = [e for e in prof.key_averages()
             if e.device_time_total > 0 and e.cpu_time_total == 0]
    top = sorted(devev, key=lambda e: -e.device_time_total)[:10]
    return (sum(e.device_time_total for e in devev) / 1e3,
            sum(e.count for e in devev),
            [dict(name=e.key[:60], ms=e.device_time_total / 1e3,
                  calls=e.count) for e in top])


def phase_train_ernie(torch, what, name, batch, card):
    """``bench.py``'s ``_mlm_bench`` on the card: ``ernie(name,
    fused_mlm_loss=True, max_predictions=97)``, ``.bfloat16()``,
    ``AdamW(1e-4, multi_precision=True)``, ``TrainStep`` on one batch
    of ``batch`` x 512. First one forward and backward at b4 through the
    kernels and through the plain versions (GPT's loss and gradient
    rule); then 10 steps: losses finite and falling, rows 1 and 4 once a
    layer a step (non-causal), no plain version. Printed: the step wall,
    tokens/s, MFU (``flops_per_token(512)`` against 989 TFLOP/s), peak
    memory, the device's idle share and its top kernels."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.ernie import ernie
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    model = ernie(name, device=dev, fused_mlm_loss=True,
                  max_predictions=max(int(ERNIE_SEQ * 0.19), 8),
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    model.bfloat16()
    model.train()
    layers = model.cfg.num_layers
    x, y = _ernie_batch(torch, model, batch, ERNIE_SEQ)
    _train_check(torch, what + "_check", model, x[:4],
                 tuple(t[:4] for t in y), "bfloat16", config=name,
                 layers=layers)
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          multi_precision=True)
    step = jit.TrainStep(model, opt, lambda out, lbl: model.loss(out, lbl))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    losses, walls = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_bwd": fa.flash_attention_bwd.launches}
    plain_calls = (fa.flash_attention_plain.calls
                   + fa.flash_attention_bwd_plain.calls)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    wall_ms = float(np.median(walls[1:]))
    tokens_per_s = batch * ERNIE_SEQ / (wall_ms / 1e3)
    fpt = model.flops_per_token(ERNIE_SEQ)
    busy_ms, n_launch, top = _device_profile(torch, lambda: step(x, y))
    say(what, card=card, config=name, dtype="bfloat16", batch=batch,
        seq=ERNIE_SEQ, params=model.num_params(),
        optimizer="AdamW(1e-4, multi_precision=True)",
        max_predictions=model.cfg.max_predictions, losses=losses,
        step_wall_ms=walls, median_step_ms=wall_ms,
        tokens_per_s=tokens_per_s, flops_per_token=fpt,
        mfu=tokens_per_s * fpt / PEAK_FLOPS, peak_memory_gib=peak / 2 ** 30,
        launches=launches, launches_per_step={k: v / 10 for k, v in
                                              launches.items()},
        plain_calls=plain_calls, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        device_launches_per_step=n_launch, top_kernels=top)
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"{what} losses not finite or not falling: {losses}")
    if launches != {"flash_fwd": 10 * layers, "flash_bwd": 10 * layers}:
        fail(f"{what} launches {launches}, expected {layers} + {layers} a "
             "step")
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times on {what}")
    del model, opt, step
    torch.cuda.empty_cache()
    return launches


def phase_ernie_encode(torch, card):
    """Incremental encoding with ernie-3.0-base in eval (fp32, as the
    reference's test runs): two 128-token prompts prefilled into a
    cache, then 4 tokens appended in one window, against the same
    prefill followed by four 1-token appends (the reference's
    ``test_ernie_incremental_encoding_consistency``: within 2e-4; the
    pooled output None on every append); the prefill through row 1
    (non-causal), the appends through row 5, row_gemm 49 times a prefill
    (with the pooler) and 48 an append, no plain version."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.ernie import ernie
    dev = torch.device("cuda", 0)
    model = ernie("ernie-3.0-base", device=dev,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    enc = model.ernie
    ids = torch.as_tensor(np.random.RandomState(SEED + 5).randint(
        0, model.cfg.vocab_size, (2, 132)), device=dev)
    _reset_counts(fa)
    with torch.no_grad():
        _, pooled, c1 = enc(ids[:, :128], use_cache=True, cache_max_len=256)
        block, none1, c1 = enc(ids[:, 128:132], cache=c1)
        _, _, c2 = enc(ids[:, :128], use_cache=True, cache_max_len=256)
        steps, nones = [], [none1]
        for t in range(128, 132):
            h, none, c2 = enc(ids[:, t:t + 1], cache=c2)
            steps.append(h[:, 0])
            nones.append(none)
        torch.cuda.synchronize()
    launches, plain = _counts(fa)
    singles = torch.stack(steps, dim=1)
    diff = float((block - singles).abs().max())
    ok = bool(torch.allclose(block, singles, rtol=2e-4, atol=2e-4))
    kv = (c1.kv_len.tolist(), c2.kv_len.tolist())
    layers = model.cfg.num_layers
    want_rows = 2 * (4 * layers + 1) + 5 * 4 * layers
    say("ernie_encode", card=card, config="ernie-3.0-base",
        dtype="float32", prefill=[2, 128], append_tokens=4,
        window_vs_single_max_abs_diff=diff, tol="2e-4+2e-4*|single|",
        pooled_shape=list(pooled.shape),
        pooled_none_on_append=all(n is None for n in nones),
        kv_len=kv, launches=launches, plain_calls=plain,
        row_gemm_expected=want_rows)
    if not ok or not torch.isfinite(block).all():
        fail(f"ernie_encode: append window parts from single appends by "
             f"{diff}")
    if any(n is not None for n in nones) or pooled is None:
        fail("ernie_encode: pooled output on an append, or none on prefill")
    if kv != ([132, 132], [132, 132]):
        fail(f"ernie_encode kv_len {kv}")
    if plain or launches["flash_fwd"] != 2 * layers or \
            launches["flash_decode"] != 5 * layers or \
            launches["row_gemm"] != want_rows or \
            any(n for k, n in launches.items()
                if k not in ("flash_fwd", "flash_decode", "row_gemm")):
        fail(f"ernie_encode launches {launches}, plain calls {plain}")
    del model
    return launches


def phase_ernie_classify(torch, card):
    """``ErnieForSequenceClassification`` on ernie-3.0-base (bf16, eval,
    3 classes) at b8 s128 with a padding mask on half the rows and
    without: the logits through the kernels (row 1 when unmasked;
    ``sdpa_xla`` with the mask, as in the reference) against the plain
    versions within 0.1, finite."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.ernie import (CONFIGS,
                                               ErnieForSequenceClassification)
    dev = torch.device("cuda", 0)
    model = ErnieForSequenceClassification(
        CONFIGS["ernie-3.0-base"], num_classes=3, device=dev,
        dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    rng = np.random.RandomState(SEED + 6)
    ids = torch.as_tensor(rng.randint(0, 40000, (8, 128)), device=dev)
    mask = torch.ones((8, 128), dtype=torch.int64, device=dev)
    mask[4:, 96:] = 0
    out = {}
    for label, m in (("unmasked", None), ("masked", mask)):
        _reset_counts(fa)
        with torch.no_grad():
            got = model(ids, None, m)
            launched = fa.flash_attention.launches
            with mock.patch.object(fa, "_forward", fa.flash_attention_plain):
                ref = model(ids, None, m)
        torch.cuda.synchronize()
        diff = float((got.float() - ref.float()).abs().max())
        out[label] = dict(max_abs_logit_diff=diff, flash_fwd=launched,
                          finite=bool(torch.isfinite(got).all()))
        if not out[label]["finite"] or diff > LOGIT_TOL:
            fail(f"ernie_classify {label}: logits differ by {diff}")
    say("ernie_classify", card=card, config="ernie-3.0-base", classes=3,
        batch=8, seq=128, tol=LOGIT_TOL, **out)
    if out["unmasked"]["flash_fwd"] != 12 or out["masked"]["flash_fwd"]:
        fail(f"ernie_classify launches {out}")
    del model
    return {"flash_fwd": 12}



# ------------------------------------------------- the eager op surface

#: card against the port's own CPU run, per element (fp32): the two run
#: other kernels (cuBLAS, cuSOLVER, CUDA transcendentals against MKL and
#: LAPACK), so each value and gradient within 1e-5 + 1e-5 * |cpu|
SURFACE_TOL = 1e-5
#: eager_dygraph's double grad and PyLayer gradient, card against CPU,
#: as max |diff| / max |cpu|: a chain of six fp32 products (K <= 32)
#: through tanh's first and second derivatives, summed in other orders,
#: where small values cancel. fp32 against float64 reads 4.2e-7 of the
#: largest value (1.6e-5 per element), operands rounded to TF32 3.3e-3
#: and a flipped sign of tanh'' 2.0
#: (``experiments/double_grad_tolerance.py``)
COMPOSITE_TOL = 1e-4
#: seconds ``import paddle_tpu_torch`` took in a fresh process on the
#: parent commit (de5d443), four runs in turns with this tree's
#: (``experiments/import_time_probe.py build/parent . --rounds=4`` on an
#: NVIDIA H100 80GB HBM3 machine, 700.00 W; this tree's were 6.05,
#: 6.64, 7.08 and 7.44 in the same call)
PARENT_IMPORT_S = [6.548, 6.476, 8.021, 7.574]
#: the eager_dygraph MLP at gpt2-small's width
DYGRAPH_SHAPE = (8, 128, 768)
DYGRAPH_HIDDEN = 3072
DYGRAPH_STEPS = 10
DISPATCH_CALLS = 1000


def _surface_cases():
    """The parity cases' table (numpy only, no JAX package code)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _port_op_cases
    return _port_op_cases


def _surface_run(P, H, name, device):
    """Op ``name`` of the port on ``device`` ('gpu', or 'cpu' for the
    reference side) from the parity cases' numpy inputs: (outputs,
    dtypes, gradient or None), every tensor checked to live there."""
    from paddle_tpu_torch.core import device as port_device
    port_device.set_device(device)
    reg = P.ops.OPS[name]
    args, kwargs = H.CASES[name][0], H.CASES[name][1]
    gi = H._grad_index(name, reg.differentiable)
    targs, target = [], None
    for i, a in enumerate(args):
        t = H._to(P, a, stop_gradient=(i != gi))
        if i == gi:
            target = t[0] if isinstance(t, list) else t
        targs.append(t)
    out = reg.public(*targs, **kwargs)
    leaves = [o for o in H._leaves(out)]
    want = {"gpu": "cuda", "cpu": "cpu"}[device]
    for o in leaves:
        if hasattr(o, "place") and o.place.type != want:
            fail(f"op_surface: {name}'s output lives on {o.place}, not "
                 f"{want}")
    grad = None
    if target is not None:
        loss = None
        w_rng = np.random.RandomState(len(name))
        for o in leaves:
            if H._dtype_name(o) not in ("float32", "float16"):
                continue
            w = np.asarray(w_rng.randn(*o.shape), np.float32)
            term = (o.astype("float32") * P.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        if loss is not None and not loss.stop_gradient:
            loss.backward()
        if target.grad is not None:
            if target.grad.place.type != want:
                fail(f"op_surface: {name}'s gradient lives on "
                     f"{target.grad.place}")
            grad = target.grad.numpy()
    return [H._np(o) for o in leaves], [H._dtype_name(o) for o in leaves], \
        grad


def _surface_err(name, a, b, sort=False):
    """max |card - cpu| / (1 + |cpu|), failing past SURFACE_TOL."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        fail(f"op_surface: {name} shape {a.shape} on the card, {b.shape} "
             f"on the CPU")
    if sort:
        a, b = np.sort_complex(a.ravel()), np.sort_complex(b.ravel())
    if a.dtype.kind in "biu":
        if not np.array_equal(a, b):
            fail(f"op_surface: {name}'s integer output differs")
        return 0.0
    if a.size == 0:
        return 0.0
    fin = np.isfinite(b)
    if not np.array_equal(np.isfinite(a), fin) or not np.array_equal(
            a[~fin], b[~fin]):
        fail(f"op_surface: {name}'s non-finite values differ")
    err = float(np.max(np.abs(a[fin] - b[fin]) / (1.0 + np.abs(b[fin])))
                ) if fin.any() else 0.0
    if not err <= SURFACE_TOL:
        fail(f"op_surface: {name} differs from the CPU by {err:.3g} "
             f"(limit {SURFACE_TOL})")
    return err


def phase_op_surface(torch, card):
    """Every registered op of the port on the card from the parity
    cases' inputs, held to the port's own CPU result (values,
    dtypes, gradients), every output on the card; then the functions
    whose output shape depends on the data."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as port_device
    H = _surface_cases()
    t0 = time.perf_counter()
    worst, compared, grads = {}, 0, 0
    try:
        for name in sorted(P.ops.OPS):
            if name in H.EXCEPTIONS:
                continue
            if name not in H.CASES:
                fail(f"op_surface: no case for registered op {name}")
            cv, cd, cg = _surface_run(P, H, name, "gpu")
            hv, hd, hg = _surface_run(P, H, name, "cpu")
            if cd != hd:
                fail(f"op_surface: {name} dtypes {cd} on the card, {hd} on "
                     f"the CPU")
            sort = H.options(name).get("sorted", False)
            err = max([_surface_err(name, a, b, sort)
                       for a, b in zip(cv, hv)] or [0.0])
            if (cg is None) != (hg is None):
                fail(f"op_surface: {name}'s gradient on one side only")
            if cg is not None:
                err = max(err, _surface_err(name + " gradient", cg, hg))
                grads += 1
            worst[name] = err
            compared += 1
        rng = np.random.RandomState(5)
        x = rng.randn(64, 33).astype(np.float32)
        ids = rng.randint(0, 7, 200)
        for what, fn in (
                ("unique", lambda: P.unique(P.to_tensor(ids),
                                            return_index=True,
                                            return_inverse=True,
                                            return_counts=True)),
                ("nonzero", lambda: P.nonzero(P.to_tensor(x > 0))),
                ("masked_select", lambda: P.masked_select(
                    P.to_tensor(x), P.to_tensor(x > 0.5))),
                ("getitem_bool", lambda: P.to_tensor(x)[P.to_tensor(
                    x < 0)]),
                ("unique_consecutive", lambda: P.ops.OPS[
                    "unique_consecutive"].public(P.to_tensor(np.sort(ids)),
                                                 return_counts=True))):
            port_device.set_device("gpu")
            card_out = fn()
            card_out = card_out if isinstance(card_out, tuple) \
                else (card_out,)
            if any(o.place.type != "cuda" for o in card_out):
                fail(f"op_surface: {what} left the card")
            port_device.set_device("cpu")
            cpu_out = fn()
            cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
            worst[what] = max(_surface_err(what, a.numpy(), b.numpy())
                              for a, b in zip(card_out, cpu_out))
    finally:
        port_device.set_device("gpu")
    for mod in ("jax", "paddle_tpu"):
        if mod in sys.modules:
            fail(f"op_surface: {mod} was imported")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
    say("op_surface", card=card, registered=len(P.ops.OPS),
        ops_run=len(P.ops.OPS) - len(H.EXCEPTIONS), compared=compared,
        gradients_compared=grads, data_dependent_compared=5,
        exceptions=H.EXCEPTIONS, tolerance=SURFACE_TOL,
        worst=dict(top), worst_by_op=worst,
        seconds=time.perf_counter() - t0)


def _dygraph_loss(ops, x, w1, b1, w2, b2):
    """The MLP block's loss: mean(square(tanh(x w1 + b1) w2 + b2))."""
    h = ops["tanh"](ops["add"](ops["matmul"](x, w1), b1))
    return ops["mean"](ops["square"](ops["add"](ops["matmul"](h, w2), b2)))


def _call_host_us(torch, fn, n):
    """Host µs a call over ``n`` calls of ``fn()``, the card drained
    before and after (each call enqueues less work than the host spends
    on it)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _import_seconds():
    out = subprocess.run(
        [sys.executable, "-c",
         "import time; t = time.perf_counter(); import paddle_tpu_torch; "
         "print(time.perf_counter() - t)"], cwd=HERE, capture_output=True,
        text=True, timeout=300)
    if out.returncode != 0:
        fail(f"import paddle_tpu_torch: {out.stderr.strip()[-400:]}")
    return float(out.stdout.strip().splitlines()[-1])


def phase_eager_dygraph(torch, card):
    """gpt2-small-wide MLP written with the top-level ops only, 10 eager
    AdamW steps on ``create_parameter`` weights, bitwise against the
    same loop in plain torch; a double grad and a PyLayer against the
    CPU; the dispatch's host cost a call against the torch call."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import device as port_device
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    port_device.set_device("gpu")
    P.seed(SEED)
    d, hdim = DYGRAPH_SHAPE[-1], DYGRAPH_HIDDEN
    w1 = P.create_parameter([d, hdim], "float32")
    b1 = P.create_parameter([hdim], "float32", is_bias=True)
    w2 = P.create_parameter([hdim, d], "float32")
    b2 = P.create_parameter([d], "float32", is_bias=True)
    x = P.randn(list(DYGRAPH_SHAPE))
    plain = [torch.nn.Parameter(p.detach().as_subclass(torch.Tensor)
                                .clone()) for p in (w1, b1, w2, b2)]
    xp = x.detach().as_subclass(torch.Tensor).clone()
    runs = {}
    for what, params, xin, ops in (
            ("surface", [w1, b1, w2, b2], x,
             dict(matmul=P.matmul, add=P.add, tanh=P.tanh,
                  square=P.square, mean=P.mean)),
            ("plain", plain, xp,
             dict(matmul=torch.matmul, add=torch.add, tanh=torch.tanh,
                  square=torch.square, mean=torch.mean))):
        opt = AdamW(learning_rate=1e-3, parameters=params)
        losses, step_ms = [], []
        for _ in range(DYGRAPH_STEPS):
            s0 = time.perf_counter()
            loss = _dygraph_loss(ops, xin, *params)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())       # waits for the step
            step_ms.append((time.perf_counter() - s0) * 1e3)
        # the first step of the first loop also starts cuBLAS: the median
        # of the others
        runs[what] = (losses, float(np.median(step_ms[1:])))
    sl, pl = runs["surface"][0], runs["plain"][0]
    if not all(np.isfinite(sl)) or not sl[-1] < sl[0]:
        fail(f"eager_dygraph: the loss did not fall: {sl}")
    if sl != pl:
        fail(f"eager_dygraph: losses differ from plain torch: {sl} / {pl}")
    if any(p.grad is not None for p in (w1, b1, w2, b2)):
        fail("eager_dygraph: clear_grad left a gradient")
    # a double grad and a PyLayer on the card against the CPU
    rng = np.random.RandomState(1)
    a = rng.randn(16, 32).astype(np.float32)
    m = rng.randn(32, 8).astype(np.float32)

    class Cube(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, t):
            ctx.save_for_backward(t)
            return t * t * t

        @staticmethod
        def backward(ctx, g):
            (t,) = ctx.saved_tensor
            return g * 3.0 * t * t

    checks = {}
    for dev in ("gpu", "cpu"):
        port_device.set_device(dev)
        xa = P.to_tensor(a, stop_gradient=False)
        out = P.tanh(P.matmul(xa, P.to_tensor(m))).sum()
        (gx,) = P.grad(out, [xa], create_graph=True)
        ((gx * gx).sum()).backward()
        c = P.to_tensor(a, stop_gradient=False)
        Cube.apply(c).sum().backward()
        checks[dev] = (gx.numpy(), xa.grad.numpy(), c.grad.numpy(),
                       gx.place.type)
    port_device.set_device("gpu")
    if checks["gpu"][3] != "cuda":
        fail("eager_dygraph: paddle.grad's result left the card")
    errs = {}
    for i, k in enumerate(("grad_create_graph", "double_grad",
                           "pylayer_grad")):
        a, b = checks["gpu"][i], checks["cpu"][i]
        errs[k] = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        if not errs[k] <= COMPOSITE_TOL:
            fail(f"eager_dygraph: {k} differs from the CPU by "
                 f"{errs[k]:.3g} of its largest value (limit "
                 f"{COMPOSITE_TOL})")
    # the registry's host cost a call against the torch call alone
    xs = P.randn([8, d])
    wm = P.randn([d, d])
    xs_t, wm_t = (t.detach().as_subclass(torch.Tensor) for t in (xs, wm))
    us = {}
    for rep in range(2):
        for key, fn in (("add_dispatch", lambda: P.add(xs, xs)),
                        ("add_torch", lambda: torch.add(xs_t, xs_t)),
                        ("matmul_dispatch", lambda: P.matmul(xs, wm)),
                        ("matmul_torch", lambda: torch.matmul(xs_t, wm_t))):
            us.setdefault(key, []).append(_call_host_us(torch, fn,
                                                        DISPATCH_CALLS))
    imp = [_import_seconds() for _ in range(3)]
    say("eager_dygraph", card=card, shape=list(DYGRAPH_SHAPE),
        hidden=hdim, steps=DYGRAPH_STEPS, losses=sl,
        losses_bitwise_plain_torch=True,
        median_step_ms=runs["surface"][1],
        plain_median_step_ms=runs["plain"][1],
        errors_against_cpu=errs, host_us_a_call=us,
        dispatch_overhead_us={
            op: min(us[op + "_dispatch"]) - min(us[op + "_torch"])
            for op in ("add", "matmul")},
        calls=DISPATCH_CALLS, import_s=imp,
        parent_import_s=PARENT_IMPORT_S,
        seconds=time.perf_counter() - t0)

# paddle_tpu_torch.nn.Transformer() at its defaults, the Transformer-base
# of Vaswani et al. (2017): d_model 512, 8 heads (head_dim 64), 6 + 6
# layers, feed-forward 2048, relu; built with dropout 0.0 so that every
# unmasked attention reaches rows 1-4 in training too
NN_T_BATCH, NN_T_SEQ, NN_T_DMODEL = 32, 512, 512
NN_T_LAYERS = 6
NN_T_CHECK_BATCH = 4
NN_T_STEPS = 10
NN_T_LR = 1e-3
#: a gradient may differ from the CPU's fp32 one by this many times what
#: bf16 on the CPU gives (see _nn_transformer_check)
NN_T_FLOOR = 3.0


def _nn_transformer_counts(fa, attn):
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd": fa.flash_attention_bwd.launches,
            "sdpa_xla": attn.sdpa_xla.calls,
            "plain": fa.flash_attention_plain.calls
            + fa.flash_attention_bwd_plain.calls}


def _nn_transformer_reset(fa, attn):
    fa.reset_counts()
    attn.sdpa_xla.calls = 0


def _nn_transformer_check(torch, model, src, tgt, mask, target):
    """The card model in bf16 against the same weights and inputs in
    fp32 on the CPU, at batch NN_T_CHECK_BATCH: the fp32 loss within
    TRAIN_LOSS_TOL and the whole gradient (every parameter's, as one
    vector) within GRAD_NORM_TOL of its norm (GPT's rule), each
    parameter's within max(GRAD_NORM_TOL, NN_T_FLOOR x its bf16 floor)
    of its norm. The
    bf16 floor is the same comparison made on the CPU, bf16 against
    fp32: at random initialization the cross-attentions' key and value
    gradients are small beside what bf16 rounding of the activations
    moves (0.37 of the norm on the CPU at this shape), as ResNet-50's
    bf16 gradients are held against a chaos floor. A key projection's
    bias, whose gradient is zero in exact arithmetic (the softmax
    cancels one constant a row), is held against its weight's gradient
    norm. Returns the line's fields."""
    import copy

    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn

    def loss_and_grads(m, s, t, mk, y):
        m.clear_gradients()
        loss = nn.MSELoss()(m(s, t, tgt_mask=mk).astype("float32"), y)
        loss.backward()
        grads = {n: p.grad.numpy().astype(np.float64)
                 for n, p in m.named_parameters()}
        m.clear_gradients()
        return float(loss.numpy()), grads

    b = NN_T_CHECK_BATCH
    card = [t[:b] for t in (src, tgt, target)]
    k_loss, k_grads = loss_and_grads(model, card[0], card[1], mask,
                                     card[2])
    cpu = nn.Transformer(dropout=0.0, device="cpu")
    cpu.set_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    cmask = nn.Transformer.generate_square_subsequent_mask(NN_T_SEQ,
                                                           device="cpu")
    runs = {}
    for dtype, m in (("float32", cpu),
                     ("bfloat16", copy.deepcopy(cpu).to(dtype="bfloat16"))):
        host = [P.to_tensor(t.numpy(), dtype=dtype, place="cpu")
                for t in card[:2]]
        runs[dtype] = loss_and_grads(
            m, host[0], host[1], cmask,
            P.to_tensor(card[2].numpy(), place="cpu"))
    p_loss, p_grads = runs["float32"]

    def scale(n):
        if n.endswith("k_proj.bias"):
            n = n[:-len("bias")] + "weight"
        return max(np.linalg.norm(p_grads[n]), 1e-30)

    def errs(grads):
        return {n: float(np.linalg.norm(g - p_grads[n]) / scale(n))
                for n, g in grads.items()}

    norm_err, floor = errs(k_grads), errs(runs["bfloat16"][1])
    limit = {n: max(GRAD_NORM_TOL, NN_T_FLOOR * floor[n]) for n in floor}
    over = {n: norm_err[n] / limit[n] for n in norm_err}
    worst = max(norm_err, key=norm_err.get)
    closest = max(over, key=over.get)
    flat = [np.concatenate([g[n].ravel() for n in sorted(g)])
            for g in (k_grads, p_grads)]
    whole = float(np.linalg.norm(flat[0] - flat[1])
                  / np.linalg.norm(flat[1]))
    if not (math.isfinite(k_loss) and abs(k_loss - p_loss) <= TRAIN_LOSS_TOL):
        fail(f"nn_transformer: card bf16 loss {k_loss} against CPU fp32 "
             f"{p_loss}")
    if not whole <= GRAD_NORM_TOL:
        fail(f"nn_transformer: the whole gradient differs from the CPU's "
             f"by {whole:.3g} of its norm")
    if over[closest] > 1.0:
        fail(f"nn_transformer: gradient {closest} differs from the CPU's "
             f"by {norm_err[closest]:.3g} of its norm (limit "
             f"{limit[closest]:.3g})")
    del cpu
    return dict(check_batch=b, card_loss=k_loss, cpu_fp32_loss=p_loss,
                cpu_bf16_loss=runs["bfloat16"][0],
                loss_diff=abs(k_loss - p_loss), loss_tol=TRAIN_LOSS_TOL,
                worst_grad_norm_err=[worst, norm_err[worst]],
                its_bf16_floor=floor[worst],
                closest_to_limit=[closest, norm_err[closest],
                                  limit[closest]],
                grads_over_grad_norm_tol=sum(
                    e > GRAD_NORM_TOL for e in norm_err.values()),
                whole_gradient_err=whole, grad_norm_tol=GRAD_NORM_TOL,
                floor_factor=NN_T_FLOOR, checked_grads=len(k_grads))


def phase_nn_transformer(torch, card):
    """``paddle_tpu_torch.nn.Transformer()`` at its defaults, dropout
    0.0, cast with ``Layer.to(dtype="bfloat16")``, on src and tgt [32,
    512, 512] bf16 from ``paddle_tpu_torch.randn`` (so the ``Tensor``
    boundary is on the path) with ``generate_square_subsequent_mask(512)``
    as ``tgt_mask``: one eval forward, the b4 check against the CPU,
    then 10 eager steps of ``nn.MSELoss`` of the output in fp32 (as
    GPT's loss takes fp32 logits) against a fixed fp32 target,
    ``loss.backward()``, ``AdamW(multi_precision=True).step()``,
    ``clear_grad()``. Each forward launches row 1 twelve times (6
    encoder self-attentions, 6 cross-attentions) and runs ``sdpa_xla``
    six times (the masked decoder self-attentions), each backward rows
    2-4 twelve times; no plain version runs. The loss falls; every
    output is a ``Tensor`` on the card. Printed: the median step ms, the
    device idle share, the peak memory."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.core import device as port_device
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn.functional import attention as attn
    t0 = time.perf_counter()
    port_device.set_device("gpu")
    P.seed(SEED)
    torch.cuda.empty_cache()
    model = nn.Transformer(dropout=0.0)
    model.to(dtype="bfloat16")
    shape = [NN_T_BATCH, NN_T_SEQ, NN_T_DMODEL]
    src = P.randn(shape, dtype="bfloat16")
    tgt = P.randn(shape, dtype="bfloat16")
    target = P.randn(shape)
    mask = nn.Transformer.generate_square_subsequent_mask(NN_T_SEQ)
    layers = 2 * NN_T_LAYERS           # unmasked attentions a forward
    # one eval forward
    model.eval()
    _nn_transformer_reset(fa, attn)
    with P.no_grad():
        out = model(src, tgt, tgt_mask=mask)
    torch.cuda.synchronize()
    eval_counts = _nn_transformer_counts(fa, attn)
    if not isinstance(out, P.Tensor) or out.place.type != "cuda" or \
            out.shape != shape or not bool(torch.isfinite(out).all()):
        fail(f"nn_transformer: eval output {type(out).__name__} "
             f"{out.shape} on {out.place}, or not finite")
    if eval_counts != {"flash_fwd": layers, "flash_bwd": 0,
                       "sdpa_xla": NN_T_LAYERS, "plain": 0}:
        fail(f"nn_transformer: eval forward counts {eval_counts}")
    # the same weights on the CPU in fp32, at batch 4
    model.train()
    check = _nn_transformer_check(torch, model, src, tgt, mask, target)
    # 10 eager steps
    opt = optimizer.AdamW(learning_rate=NN_T_LR,
                          parameters=model.parameters(),
                          multi_precision=True)
    loss_fn = nn.MSELoss()

    def step():
        loss = loss_fn(model(src, tgt, tgt_mask=mask).astype("float32"),
                       target)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _nn_transformer_reset(fa, attn)
    losses, walls, on_card = [], [], True
    for _ in range(NN_T_STEPS):
        s0 = time.perf_counter()
        loss = step()
        on_card &= isinstance(loss, P.Tensor) and loss.place.type == "cuda"
        losses.append(float(loss.numpy()))    # waits for the step
        walls.append((time.perf_counter() - s0) * 1e3)
    train_counts = _nn_transformer_counts(fa, attn)
    peak = torch.cuda.max_memory_allocated()
    wall_ms = float(np.median(walls[1:]))
    busy_ms, n_launch, top = _device_profile(torch, step)
    say("nn_transformer", card=card, config="Transformer() defaults",
        d_model=NN_T_DMODEL, nhead=8, layers=[NN_T_LAYERS, NN_T_LAYERS],
        dim_feedforward=2048, dropout=0.0, dtype="bfloat16",
        batch=NN_T_BATCH, seq=NN_T_SEQ, params=sum(
            torch.numel(p) for p in model.parameters()),
        optimizer=f"AdamW({NN_T_LR}, multi_precision=True)",
        eval_counts=eval_counts, train_counts=train_counts, losses=losses,
        step_wall_ms=walls, median_step_ms=wall_ms,
        peak_memory_gib=peak / 2 ** 30, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        device_launches_per_step=n_launch, top_kernels=top,
        seconds=time.perf_counter() - t0, **check)
    if not on_card:
        fail("nn_transformer: a loss left the card or is not a Tensor")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"nn_transformer: losses not finite or not falling: {losses}")
    want = {"flash_fwd": NN_T_STEPS * layers,
            "flash_bwd": NN_T_STEPS * layers,
            "sdpa_xla": NN_T_STEPS * NN_T_LAYERS, "plain": 0}
    if train_counts != want:
        fail(f"nn_transformer: training counts {train_counts}, expected "
             f"{want}")
    del model, opt, out
    torch.cuda.empty_cache()
    return {"flash_fwd": eval_counts["flash_fwd"]
            + train_counts["flash_fwd"],
            "flash_bwd": train_counts["flash_bwd"]}


def main():
    sys.path.insert(0, HERE)
    import torch
    card = phase_device(torch)
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"paddle_tpu_torch is not importable next to this script "
             f"({e}); run from the root of a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    timer = DeviceTimer(torch)
    rows, dsets = phase_kernels(torch, timer)
    rows.update(phase_paged_chunk_kernels(torch, timer, dsets,
                                          rows["flash_decode"]))
    del dsets
    rows.update(phase_int8_kernels(torch, timer))
    phase_verify_window_kernels(torch, timer, rows)
    rows["flash_bwd"], rows["flash_fwd"]["train_shape"] = \
        phase_train_kernels(torch, timer)
    rows.update(phase_fused_resnet_kernels(torch, timer))
    rows.update(phase_fused_conv3x3_kernels(torch, timer))
    rows.update(phase_norm_adamw_kernels(torch, timer))
    rows.update(phase_fused_ce_kernels(torch, timer))
    rows.update(phase_row_gemm_kernels(torch, timer))
    phase_head_dims(torch)
    model = phase_model(torch)
    prompts = _serve_prompts(model)
    paths = []
    served = {}
    # the three serving paths on the full-width cache, then on the int8
    for kv in (None, "int8"):
        sfx = "" if kv is None else "_" + kv
        launches, handles = phase_serve(
            torch, model, prompts, rows["flash_decode" + sfx]["ms"], kv)
        paths.append(("serve" + sfx, launches))
        served["serve" + sfx] = handles
        launches, served["serve" + sfx + "_paged"] = phase_serve_paged(
            torch, model, prompts, handles,
            rows["flash_decode_paged" + sfx]["ms"], kv)
        paths.append(("serve" + sfx + "_paged", launches))
        launches, served["serve" + sfx + "_chunked"] = phase_serve_chunked(
            torch, model, prompts, kv)
        paths.append(("serve" + sfx + "_chunked", launches))
    # the same traffic with speculative slots (ngram, k 4), and
    # generate(speculative=...) in both modes
    launches, spec_handles = phase_serve_spec(
        torch, model, prompts, served["serve"],
        rows["flash_decode"]["verify_window_k4"]["ms"])
    paths.append(("serve_spec", launches))
    paths.append(("serve_spec_paged", phase_serve_spec_paged(
        torch, model, prompts, spec_handles, served["serve_paged"])))
    launches, _ = phase_serve_spec(
        torch, model, prompts, served["serve_int8"],
        rows["flash_decode_int8"]["verify_window_k4"]["ms"], "int8")
    paths.append(("serve_spec_int8", launches))
    paths.append(("serve_spec_chunked", phase_serve_spec_chunked(
        torch, model, prompts, served["serve_chunked"])))
    paths.append(("generate_spec", phase_generate_spec(torch, model,
                                                       prompts)))
    # the observability core on the same traffic: registry and recorder
    # on against off, a CPU+GPU profile, fail_admission
    paths.append(("serve_telemetry", phase_serve_telemetry(torch, model,
                                                           prompts)))
    # the operations surface: two replicas behind the fleet router in
    # thread mode with a rolling deploy, then a preemption drain
    paths.append(("serve_fleet", phase_serve_fleet(
        torch, model, prompts, served["serve"], card)))
    # the Predictor in generation mode, then weight-only int8/int4 serving
    paths.append(("predictor", phase_predictor(torch, model, prompts,
                                               served["serve"], card)))
    paths.append(("serve_weights", phase_serve_weights(
        torch, model, prompts, card, rows["flash_decode"]["ms"])))
    del served, spec_handles
    phase_int8_logits(torch, model)
    del model
    torch.cuda.empty_cache()
    launches, trained, train_losses = phase_train(torch)
    paths.append(("train", launches))
    paths.append(("train_fused_ops", phase_train_fused_ops(torch, *trained)))
    paths.append(("train_fused_ce", phase_train_fused_ce(torch, *trained)))
    del trained
    torch.cuda.empty_cache()
    # the rest of training: recompute, optimizer-state offload, AMP, QAT
    paths.append(("train_recompute", phase_train_recompute(torch,
                                                           train_losses)))
    paths.append(("train_offload", phase_train_offload(torch)))
    paths.append(("train_amp", phase_train_amp(torch)))
    paths.append(("train_qat", phase_train_qat(torch)))
    launches, resnet_run = phase_train_resnet50(torch)
    paths.append(("train_resnet50", launches))
    paths.append(("train_resnet50_recompute",
                  phase_train_resnet50_recompute(torch, resnet_run)))
    del resnet_run
    torch.cuda.empty_cache()
    # ERNIE and BERT: rows 1-4 non-causal, bench.py's two MLM rows, the
    # cached encoding, the classifier
    noncausal = phase_ernie_kernels(torch, timer)
    rows["flash_fwd"]["noncausal_train_shapes"] = {
        k: dict(shape=v["shape"], **v["fwd"]) for k, v in noncausal.items()}
    rows["flash_bwd"]["noncausal_train_shapes"] = {
        k: dict(shape=v["shape"], **v["bwd"]) for k, v in noncausal.items()}
    for what, name, batch in ERNIE_RUNS:
        paths.append((what, phase_train_ernie(torch, what, name, batch,
                                              card)))
    paths.append(("ernie_encode", phase_ernie_encode(torch, card)))
    paths.append(("ernie_classify", phase_ernie_classify(torch, card)))
    # the eager Tensor and the op surface: no hand-written kernel runs
    # in them, so they add no launches to any row
    phase_op_surface(torch, card)
    phase_eager_dygraph(torch, card)
    # nn.Transformer at its defaults on the Layer surface: rows 1-4
    paths.append(("nn_transformer", phase_nn_transformer(torch, card)))
    for name, row in rows.items():
        by_path = {path: counts[name] for path, counts in paths
                   if name in counts}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["kernel_ms"] = row["ms"]
        row["card"] = card
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
