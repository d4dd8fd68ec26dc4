#!/usr/bin/env python3
"""Where a two-replica fleet's time goes when both replicas step on
pump threads of one process:

    python3 experiments/fleet_probe.py [--rounds=N]

Builds ``chip_smoke.py``'s gpt2-small (bf16, random weights from its
seed) and serves its 16 prompts (64 new tokens) on the card four ways:

- ``one``: one dense engine, ``serve_forever`` (``chip_smoke.py``'s
  ``serve`` run);
- ``inline``: two dense replicas behind a ``FleetRouter``, stepped in
  turn by the main thread (no pump thread);
- ``threads``: the same two replicas, each on its pump thread
  (``start()``), at the interpreter's switch interval (5 ms);
- ``threads_short``: the same with ``sys.setswitchinterval(0.0002)``.

Each round runs them in the order one, inline, threads, threads_short,
then reversed, so every variant runs twice a round. Per run it prints
one JSON line: tokens/s over the run's wall, p50 TTFT and p50 per-token
latency from the handles' host clocks, and whether every stream equals
the ``one`` run's. Needs the card.
"""
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.models.gpt import gpt  # noqa: E402
from paddle_tpu_torch.serving import (FleetRouter, RequestParams,  # noqa: E402
                                      ServingEngine)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ROUNDS = int(next((a.split("=", 1)[1] for a in sys.argv
                   if a.startswith("--rounds=")), "1"))
PARAMS = RequestParams(max_new_tokens=64)


def fields(name, handles, t0, t1, ref):
    inner = [getattr(h, "inner", h) for h in handles]
    ttft = [r.first_token_at - t0 for r in inner]
    per_token = [r.per_token_latency for r in inner]
    toks = [r.tokens for r in inner]
    return dict(variant=name, wall_s=t1 - t0,
                tokens_per_s=sum(int(t.size) for t in toks) / (t1 - t0),
                p50_ttft_ms=float(np.percentile(ttft, 50)) * 1e3,
                p50_per_token_ms=float(np.percentile(per_token, 50)) * 1e3,
                streams_equal=None if ref is None else all(
                    np.array_equal(a, b) for a, b in zip(toks, ref)),
                switch_interval_s=sys.getswitchinterval())


def run_one(model, prompts):
    eng = ServingEngine(chip_smoke._serve_config(model))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    handles = eng.serve_forever([(p, PARAMS) for p in prompts])
    torch.cuda.synchronize()
    t1 = time.monotonic()
    eng.shutdown()
    return handles, t0, t1


def run_fleet(model, prompts, threads):
    engines = {f"r{i}": ServingEngine(chip_smoke._serve_config(model))
               for i in range(2)}
    router = FleetRouter(engines, seed=chip_smoke.SEED)
    if threads:
        for e in engines.values():
            e.start()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        handles = [router.submit(p, PARAMS) for p in prompts]
        if threads:
            for h in handles:
                h.result(timeout=600)
        else:
            while any(e.busy for e in engines.values()):
                for e in engines.values():
                    if e.busy:
                        e.step()
        torch.cuda.synchronize()
        t1 = time.monotonic()
    finally:
        router.shutdown()
        for e in engines.values():
            e.shutdown()
    return handles, t0, t1


def main():
    if not torch.cuda.is_available():
        sys.exit("fleet_probe: needs a CUDA card")
    dev = torch.device("cuda", 0)
    _build.build_all(["flash_fwd", "flash_decode"])
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(
                    chip_smoke.SEED)).eval()
    prompts = chip_smoke._serve_prompts(model)
    default = sys.getswitchinterval()
    ref = None
    order = ["one", "inline", "threads", "threads_short"]
    for _ in range(ROUNDS):
        for name in order + order[::-1]:
            sys.setswitchinterval(0.0002 if name == "threads_short"
                                  else default)
            if name == "one":
                got = run_one(model, prompts)
            else:
                got = run_fleet(model, prompts, name != "inline")
            line = fields(name, *got, ref)
            if ref is None:
                ref = [getattr(h, "inner", h).tokens for h in got[0]]
            print(json.dumps(line), flush=True)
    sys.setswitchinterval(default)


if __name__ == "__main__":
    main()
