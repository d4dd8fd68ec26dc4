#!/usr/bin/env python3
"""Seconds that ``import paddle_tpu_torch`` takes in a fresh process, for
each tree given (default: this checkout), in turns.

    python3 experiments/import_time_probe.py [TREE ...] [--rounds=N]

Each round imports once from every tree, alternating the order (a, b,
b, a, ...), so a warm file cache favours no tree. Prints one JSON line:
the seconds by tree, and whether JAX was loaded (it must not be).
"""
import json
import os
import subprocess
import sys

CODE = ("import sys, time; t = time.perf_counter(); import paddle_tpu_torch; "
        "print(time.perf_counter() - t, 'jax' in sys.modules)")


def once(tree):
    out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: {out.stderr.strip()[-400:]}")
    secs, jax = out.stdout.split()
    return float(secs), jax == "True"


def main():
    rounds = 3
    trees = []
    for a in sys.argv[1:]:
        if a.startswith("--rounds="):
            rounds = int(a.split("=", 1)[1])
        else:
            trees.append(os.path.abspath(a))
    trees = trees or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    got = {t: [] for t in trees}
    jax = False
    for r in range(rounds):
        for t in (trees if r % 2 == 0 else trees[::-1]):
            s, j = once(t)
            got[t].append(s)
            jax |= j
    print(json.dumps({"import_s": got, "jax_loaded": jax}))


if __name__ == "__main__":
    main()
