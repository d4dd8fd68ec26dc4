#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an sm_90 card (H100)
and the CUDA toolkit. It builds the hand-written kernels from
``paddle_tpu_torch/csrc``, holds each against its plain PyTorch version
at the shapes the serving and training paths give it, runs gpt2-small
(random weights from a seed, bf16) through the kernel path and the
plain path, serves 16 requests through ``ServingEngine``, then trains
gpt2-small with ``bench.py``'s recipe (AdamW with fp32 masters, the
fused LM-head loss, ``TrainStep``) at batch 16 x 1024 tokens, and checks
that each path went through its kernels and never through a plain
version. Phases print one line each; the line before the last is the
kernel table as JSON, and the last line is
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero with
no result line. Imports neither JAX nor the JAX package.
"""
import json
import math
import os
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


def bound_ms(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def phase_kernels(torch, timer):
    """Each kernel against its plain version at the serving path's
    shapes, in bf16, with times."""
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
            causal=True, max_abs_err=err, tol=f"{KERNEL_ATOL}+"
            f"{KERNEL_RTOL}*|plain|", out_of_tol=n_bad)
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
        bound_by=by, library_ms=lib_ms)

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
    ms = timer.ms(fa.flash_attention_decode, dsets)
    plain_ms = timer.ms(fa.flash_attention_decode_plain, dsets)
    cols = torch.arange(T, device=dev)
    mask = (cols[None, :] < kv[:, None].long())[:, None, None, :]
    lib_sets = [(st[0].transpose(1, 2), st[1].transpose(1, 2),
                 st[2].transpose(1, 2)) for st in dsets]
    lib_ms = timer.ms(lambda q, k, v: TF.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), lib_sets)
    n_kv = int(kv.sum())
    n_bytes = 2 * n_kv * h * d * 2 + 2 * B * h * d * 2 + B * 4
    bms, by = bound_ms(n_bytes, 4 * n_kv * h * d)
    rows["flash_decode"] = dict(
        name="flash_decode", route="cuda",
        source="paddle_tpu_torch/csrc/flash_decode.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:942",
        shape="q [8,1,12,64], cache [8,640,12,64] bf16, ragged kv_len",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    for r in rows.values():
        say("kernel_time", kernel=r["name"], kernel_ms=r["ms"],
            plain_ms=r["plain_ms"], library_ms=r["library_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"])
    return rows


def phase_train_kernels(torch, timer):
    """The training path's kernels against their plain versions: the
    forward with its LSE, as ``_FlashAttentionFn`` calls it, and
    flash_bwd on the forward's output and LSE, in bf16 at the flagship
    shape q, k, v [16, 1024, 12, 64] causal and three more, and in fp32
    at the flagship shape. Self-attention inputs are strided views of one
    fused qkv buffer, as the model gives them. Then flash_bwd and
    flash_fwd timed at the flagship shape."""
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
    sets = [inputs(b, s, s, h, h, d, True) for _ in range(3)]
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
        bound_by=by, library_ms=lib_ms)
    say("kernel_time", kernel="flash_bwd", kernel_ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=bms, bound_by=by, shape=row["shape"])
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
        shape=fwd_train["shape"])
    return row, fwd_train


def phase_model(torch):
    """gpt2-small in bf16: a bucket-512 prefill of two ragged prompts
    plus 8 teacher-forced decode steps, through the kernels and through
    the plain versions, logits compared."""
    import paddle_tpu_torch.generation.attention as cached_mod
    import paddle_tpu_torch.nn.functional.attention as sdpa_mod
    from paddle_tpu_torch.kernels import flash_attention as fa
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

    fa.reset_counts()
    kern = run()
    launched = (fa.flash_attention.launches,
                fa.flash_attention_decode.launches)
    with mock.patch.object(sdpa_mod, "flash_attention",
                           fa.flash_attention_plain), \
            mock.patch.object(cached_mod, "flash_attention_decode",
                              fa.flash_attention_decode_plain):
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
    if launched != (12, 12 * 8):
        fail(f"model kernel launches {launched}, expected (12, 96)")
    if diff > LOGIT_TOL:
        fail(f"kernel and plain logits differ by {diff} > {LOGIT_TOL}")
    return model


def phase_serve(torch, model, decode_ms):
    """16 requests through ServingEngine: every request completes with
    its budget, both kernels ran, no plain version ran."""
    from paddle_tpu_torch.generation.api import GenerationConfig
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import (RequestParams, RequestStatus,
                                          ServingEngine)
    cfg = (Config().from_layer(model).enable_use_gpu("bfloat16")
           .enable_generation(max_new_tokens=64, prefill_buckets=(128, 512),
                              max_batch=8)
           .enable_serving(max_queue=64, poll_every=4))
    engine = ServingEngine(cfg)
    rng = np.random.RandomState(SEED + 1)
    vocab = model.cfg.vocab_size
    lens = rng.randint(16, 501, 16)
    prompts = [rng.randint(0, vocab, n) for n in lens]
    torch.cuda.synchronize()
    fa.reset_counts()
    t0 = time.perf_counter()
    handles = engine.serve_forever(
        (p, RequestParams(max_new_tokens=64)) for p in prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_attention.launches,
                "flash_decode": fa.flash_attention_decode.launches}
    plain_calls = (fa.flash_attention_plain.calls
                   + fa.flash_attention_decode_plain.calls)
    done = [h for h in handles if h.status is RequestStatus.COMPLETED
            and h.tokens is not None and h.tokens.size == 64]
    ttft = [h.ttft for h in handles]
    tpot = [h.per_token_latency for h in handles]
    steps = engine.stats["decode_steps"]
    say("serve", requests=len(handles), completed=len(done),
        prompt_lens=lens.tolist(), new_tokens=64, wall_s=wall,
        tokens_per_s=len(done) * 64 / wall,
        p50_ttft_ms=float(np.median(ttft)) * 1e3,
        p50_per_token_ms=float(np.median(tpot)) * 1e3,
        decode_steps=steps, launches=launches,
        decode_launches_per_step=launches["flash_decode"] / max(steps, 1),
        prefill_launches_per_admission=launches["flash_fwd"]
        / max(engine.stats["prefills"], 1),
        plain_calls=plain_calls, stats=engine.stats)
    if len(done) != 16:
        fail(f"{16 - len(done)} of 16 requests did not complete with "
             "their full budget")
    if min(launches.values()) == 0:
        fail(f"a kernel never launched on the serving path: {launches}")
    if plain_calls:
        fail(f"plain versions ran {plain_calls} times on the serving path")
    # the first token of every request must equal a batch-1 greedy
    # prefill of the same bucket-padded prompt (same shapes, same
    # kernels: bitwise)
    sess = engine._session
    mismatch = 0
    for p, h in zip(prompts, handles):
        bucket = next(bk for bk in engine.buckets if bk >= p.size)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :p.size] = p
        tok, _, _ = sess.prefill(
            torch.as_tensor(ids, device=engine.device),
            torch.tensor([p.size], device=engine.device),
            GenerationConfig(), engine.max_len)
        mismatch += int(tok.item() != int(h.tokens[0]))
    say("serve_check", first_token_mismatches=mismatch)
    if mismatch:
        fail(f"{mismatch} first tokens differ from batch-1 prefill")

    # where a decode step's time goes, all 8 slots live: the wall time
    # of a step (the host issues ~500 launches, so the spin-kernel timer
    # does not apply) against the device time its kernels take
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[8:]:
        engine.submit(p, RequestParams(max_new_tokens=64))
    engine.step()                           # admits all 8
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        engine._dispatch_decode()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine._dispatch_decode()
        torch.cuda.synchronize()
    # device-side events (kernels, copies) carry no host time
    dev = [e for e in prof.key_averages()
           if e.device_time_total > 0 and e.cpu_time_total == 0]
    busy_ms = sum(e.device_time_total for e in dev) / (1e3 * n)
    top = sorted(dev, key=lambda e: -e.device_time_total)[:8]
    say("decode_step", live_slots=sum(s is not None for s in engine._slots),
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
        launches_per_step=sum(e.count for e in dev) / n,
        attention_kernel_ms=engine.network.cfg.num_layers * decode_ms,
        top_kernels=[dict(name=e.key[:48], ms_per_step=e.device_time_total
                          / (1e3 * n), calls_per_step=e.count / n)
                     for e in top])
    while engine.busy:
        engine.step()
    return launches


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
    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model.loss(model(x[:4]), y[:4])
        loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    fa.reset_counts()
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
    norm_err, max_err = {}, {}
    for n, g in k_grads.items():
        ref = p_grads[n]
        norm_err[n] = float((g - ref).norm() / ref.norm().clamp_min(1e-30))
        max_err[n] = float((g - ref).abs().max()
                           / ref.abs().max().clamp_min(1e-30))
    worst_norm = max(norm_err, key=norm_err.get)
    worst_max = max(max_err, key=max_err.get)
    say("train_check", config="gpt2-small", dtype="bfloat16", batch=4,
        seq=seq, kernel_loss=k_loss, plain_loss=p_loss,
        loss_diff=abs(k_loss - p_loss), loss_tol=TRAIN_LOSS_TOL,
        kernel_launches=list(k_counts), plain_run_counts=list(p_counts),
        worst_grad_norm_err=[worst_norm, norm_err[worst_norm]],
        worst_grad_max_err=[worst_max, max_err[worst_max]],
        grad_tols=[GRAD_NORM_TOL, GRAD_MAX_TOL], params=len(k_grads))
    del k_grads, p_grads
    if k_counts != (12, 12) or p_counts != (12, 12, 0, 0):
        fail(f"train check counts: kernel path {k_counts}, plain path "
             f"{p_counts}")
    if not (math.isfinite(k_loss) and abs(k_loss - p_loss) <= TRAIN_LOSS_TOL):
        fail(f"kernel and plain losses {k_loss} / {p_loss}")
    if norm_err[worst_norm] > GRAD_NORM_TOL or \
            max_err[worst_max] > GRAD_MAX_TOL:
        fail(f"kernel and plain gradients differ: {worst_norm} "
             f"{norm_err[worst_norm]}, {worst_max} {max_err[worst_max]}")

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
    return launches


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
    rows = phase_kernels(torch, timer)
    rows["flash_bwd"], rows["flash_fwd"]["train_shape"] = \
        phase_train_kernels(torch, timer)
    model = phase_model(torch)
    serve = phase_serve(torch, model, rows["flash_decode"]["ms"])
    del model
    torch.cuda.empty_cache()
    train = phase_train(torch)
    for name, row in rows.items():
        by_path = {path: counts[name] for path, counts in
                   (("serve", serve), ("train", train)) if name in counts}
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
