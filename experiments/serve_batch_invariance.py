#!/usr/bin/env python3
"""Check, inside a real serving run, that every row of the engine's
batch gets the bits a batch of one would give it:

    python3 experiments/serve_batch_invariance.py [--kv=int8|wide] [--two-pass-layer-norm] [--spec]

Builds ``chip_smoke.py``'s gpt2-small (bf16, random weights from its
seed) and serves its 16 prompts through ``ServingEngine`` on the card
(8 slots, cache 640, 64 new tokens). While the engine runs, every call
of the port's ``layer_norm``, ``torch.nn.functional.gelu``,
``row_linear`` (every product of the cached forward, the LM head's
included) and the decode kernel whose input is a decode step's batch
([8, 1, ...]) is repeated for each row alone, and the row's bits
compared. Then the first 8 requests run
through batch-1 ``generate``, and each decode call's query and output
bits are matched against the engine's for the same row. With
``--two-pass-layer-norm`` the port's ``layer_norm`` is replaced by the
two-``mean`` form it had on the card before (ROADMAP C10). With
``--spec`` the engine and ``generate`` decode speculatively
(``chip_smoke.py``'s ngram k = 4): the checked calls are the verify
windows' ([8, 5, ...] against each [1, 5, ...] row), and each query
row i of a window is also held against a one-row (Sq = 1) call of the
decode kernel over the same keys (``kv_len - 4 + i``), the call a
non-speculative step makes for that position
(``window_row_vs_sq1``). Prints one JSON line of counts per check.
"""
import collections
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as TF

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import paddle_tpu_torch.generation.attention as cached_mod  # noqa: E402
import paddle_tpu_torch.nn.functional as PF  # noqa: E402
from paddle_tpu_torch.generation import generate  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import row_linear as rl  # noqa: E402
from paddle_tpu_torch.models.gpt import gpt  # noqa: E402
from paddle_tpu_torch.serving import RequestParams, ServingEngine  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

KV = next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--kv=")),
          "int8")
KV_DTYPE = None if KV == "wide" else KV
SPEC = chip_smoke._spec_config() if "--spec" in sys.argv else None
#: the query rows of one decode call: a step, or a verify window
WINDOW = 1 if SPEC is None else SPEC.k + 1


def two_pass_layer_norm(x, normalized_shape=None, weight=None, bias=None,
                        epsilon=1e-5):
    """The port's ``layer_norm`` as it was on the card before C10's
    repair: two ``mean`` reductions over the last dim."""
    xf = x.float() if x.dtype == torch.bfloat16 else x
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def row_checked(fn, name, counts, batch_args=False):
    """``fn`` that also recomputes each row of a decode step's batch
    alone and counts rows whose bits differ. With ``batch_args`` every
    tensor argument with the batch's leading size is sliced too (the
    decode kernel's caches, kv_len and scales)."""
    def call(x, *args, **kw):
        out = fn(x, *args, **kw)
        if x.dim() >= 3 and x.shape[0] > 1 and x.shape[1] == WINDOW:
            n = x.shape[0]

            def row(t, r):
                if batch_args and torch.is_tensor(t) and t.dim() and \
                        t.shape[0] == n:
                    return t[r:r + 1]
                return t
            for r in range(n):
                one = fn(x[r:r + 1], *(row(a, r) for a in args),
                         **{k: row(v, r) for k, v in kw.items()})
                counts[name + "_rows"] += 1
                counts[name + "_differ"] += int(not torch.equal(one[0],
                                                                out[r]))
        return out
    return call


def sq1_checked(fn, counts):
    """The decode kernel, also holding each query row i of a verify
    window against a one-row call over the same keys: the row of a
    non-speculative step at that position."""
    def call(q, k, v, kv_len, scale=None, **scales):
        out = fn(q, k, v, kv_len, scale, **scales)
        sq = q.shape[1]
        if sq > 1:
            for i in range(sq):
                lens = kv_len - (sq - 1 - i)
                one = fn(q[:, i:i + 1], k, v, lens, scale, **scales)
                live = lens > 0
                counts["window_row_vs_sq1_rows"] += int(live.sum())
                counts["window_row_vs_sq1_differ"] += int(
                    (live & ~(one[:, 0] == out[:, i]).flatten(1).all(1))
                    .sum())
        return out
    return call


def digest(t):
    return hashlib.md5(t.contiguous().view(torch.uint8).cpu().numpy()
                       .tobytes()).hexdigest()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(
                    chip_smoke.SEED))
    model.eval()
    prompts = chip_smoke._serve_prompts(model)
    work = [(p, RequestParams(max_new_tokens=64)) for p in prompts]
    if "--two-pass-layer-norm" in sys.argv:
        PF.layer_norm = two_pass_layer_norm
    layer_norm = PF.layer_norm
    saved = (TF.gelu, rl.row_linear, cached_mod.flash_attention_decode)

    counts = collections.Counter()
    PF.layer_norm = row_checked(layer_norm, "layer_norm", counts)
    TF.gelu = row_checked(saved[0], "gelu", counts)
    rl.row_linear = row_checked(saved[1], "linear", counts)
    rl.row_linear.launches = 0   # the kernel's wrapper counts on its name
    cached_mod.flash_attention_decode = sq1_checked(row_checked(
        saved[2], "decode_kernel", counts, batch_args=True), counts)
    try:
        ServingEngine(chip_smoke._serve_config(
            model, speculative=SPEC,
            kv_cache_dtype=KV_DTYPE)).serve_forever(work)
    finally:
        PF.layer_norm = layer_norm
        TF.gelu, rl.row_linear = saved[:2]
        cached_mod.flash_attention_decode = saved[2]
    print(json.dumps(dict(check="rows_against_batch_1", kv=KV,
                          window=WINDOW,
                          layer_norm=layer_norm.__name__, **counts)),
          flush=True)

    # each decode call of batch-1 generate against the engine's row
    calls = []

    def recorded(q, k, v, kv_len, scale=None, **scales):
        out = saved[2](q, k, v, kv_len, scale, **scales)
        for b in range(q.shape[0]):
            if int(kv_len[b]) > 0:
                calls.append(((int(kv_len[b]), digest(q[b])),
                              digest(out[b])))
        return out

    cached_mod.flash_attention_decode = recorded
    engine = ServingEngine(chip_smoke._serve_config(
        model, speculative=SPEC, kv_cache_dtype=KV_DTYPE))
    handles = engine.serve_forever(work)
    served = collections.defaultdict(set)
    for key, out in calls:
        served[key].add(out)
    for i in range(8):
        calls.clear()
        p = prompts[i]
        bucket = next(bk for bk in engine.buckets if bk >= p.size)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :p.size] = p
        ref = generate(model, ids, 64, prompt_len=[p.size],
                       cache_max_len=engine.max_len,
                       kv_cache_dtype=KV_DTYPE,
                       speculative=SPEC).cpu().numpy()[0]
        unmatched = [j for j, (key, out) in enumerate(calls)
                     if out not in served[key]]
        print(json.dumps(dict(
            check="generate_against_engine", kv=KV, window=WINDOW,
            layer_norm=layer_norm.__name__, request=i,
            decode_calls=len(calls), calls_without_an_equal_engine_row=len(
                unmatched),
            first=None if not unmatched else dict(
                step=unmatched[0] // 12, layer=unmatched[0] % 12),
            tokens_equal=bool(np.array_equal(ref, handles[i].tokens)))),
            flush=True)
    cached_mod.flash_attention_decode = saved[2]


if __name__ == "__main__":
    main()
