#!/usr/bin/env python3
"""Time the port's two main-path steps for one or more trees of the port
on one card, in turns, so that a change and its parent are compared in
one call:

    python3 experiments/main_path_probe.py TREE [TREE ...]

Each TREE (a root holding ``paddle_tpu_torch``; ``.`` for this checkout)
runs in a process of its own, in the order given (for a parent P and a
change C: ``P C C P``), and prints one JSON line for each step:

- ``train``: gpt2-small with ``bench.py``'s recipe (bf16, ``AdamW(1e-4,
  multi_precision=True)``, the fused LM-head loss, ``jit.TrainStep``) at
  b16 s1024 on one fixed batch, as ``chip_smoke.py``'s ``train`` phase:
  the median wall of 20 steps after a warm one, the device-busy ms of one
  profiled step and the idle share;
- ``decode_step``: the dense 8-slot serving engine on gpt2-small (bf16),
  through this checkout's ``chip_smoke._decode_step_profile``: a decode
  step's wall, device-busy ms, idle share and launches;
- ``decode_walls``: the same engine's wall for each of 40 decode steps
  with all 8 slots live, each step between two synchronizes, and their
  median.

``--decode-only`` skips the train step (for more turns in one call).

Random weights from ``chip_smoke.SEED``. Prints the card's name and
power limit first. Needs a CUDA card; each tree builds its own kernels
into its ``build/`` on first use.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TRAIN_STEPS = 20
DECODE_STEPS = 40


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tree(tree, train=True):
    """Both steps for ``tree`` (the decode step alone without
    ``train``), in this process (``--child`` mode)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.models.gpt import gpt
    from paddle_tpu_torch.serving import RequestParams, ServingEngine
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    if train:
        _train(tree, cs, np, torch, jit, optimizer, gpt, profile,
               ProfilerActivity)
    _decode(tree, cs, np, torch, gpt, RequestParams, ServingEngine)


def _train(tree, cs, np, torch, jit, optimizer, gpt, profile,
           ProfilerActivity):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    batch, seq = 16, 1024
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=gen, max_position_embeddings=seq,
                fused_lm_loss=True, lm_loss_chunk=seq)
    model.train()
    ids = np.random.RandomState(cs.SEED).randint(
        0, model.cfg.vocab_size, (batch, seq))
    x = torch.as_tensor(ids.astype(np.int32), device=dev)
    y = torch.as_tensor(ids.astype(np.int64), device=dev)
    opt = optimizer.AdamW(1e-4, parameters=model.parameters(),
                          multi_precision=True)
    step = jit.TrainStep(model, opt, lambda out, lbl: model.loss(out, lbl))
    step(x, y)
    torch.cuda.synchronize()
    walls = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    devev = [e for e in prof.key_averages()
             if e.device_time_total > 0 and e.cpu_time_total == 0]
    busy = sum(e.device_time_total for e in devev) / 1e3
    wall = float(np.median(walls))
    print(json.dumps({"probe": "train", "tree": tree, "step_wall_ms": walls,
                      "median_step_ms": wall, "device_busy_ms": busy,
                      "device_idle_share": max(0.0, 1.0 - busy / wall)}),
          flush=True)
    del model, opt, step
    torch.cuda.empty_cache()


def _decode(tree, cs, np, torch, gpt, RequestParams, ServingEngine):
    dev = torch.device("cuda", 0)
    model = gpt("gpt2-small", device=dev, dtype=torch.bfloat16,
                generator=torch.Generator(device=dev).manual_seed(
                    cs.SEED)).eval()
    prompts = cs._serve_prompts(model)
    engine = ServingEngine(cs._serve_config(model))
    engine.serve_forever([(prompts[0], RequestParams(max_new_tokens=4))])
    cs.say = lambda phase, **f: print(json.dumps(
        {"probe": phase, "tree": tree, **f}), flush=True)
    cs._decode_step_profile(torch, engine, prompts[8:], 0.0, "dense")
    for p in prompts[8:]:
        engine.submit(p, RequestParams(max_new_tokens=64))
    engine.step()                           # admits all 8
    walls = []
    for _ in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._dispatch_decode()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    while engine.busy:
        engine.step()
    print(json.dumps({"probe": "decode_walls", "tree": tree,
                      "step_wall_ms": walls,
                      "median_step_ms": float(np.median(walls))}),
          flush=True)


def main():
    args = sys.argv[1:]
    if args and args[0] == "--child":
        run_tree(os.path.abspath(args[1]), train=args[2:] != ["--decode"])
        return
    decode_only = "--decode-only" in args
    args = [a for a in args if a != "--decode-only"]
    import torch
    if not torch.cuda.is_available() or not args:
        sys.exit("usage: main_path_probe.py TREE [TREE ...] (needs a CUDA "
                 "card)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tree in args:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--child", tree]
                            + (["--decode"] if decode_only else [])
                            ).returncode
        if rc:
            sys.exit(f"tree {tree} failed with exit code {rc}")


if __name__ == "__main__":
    main()
