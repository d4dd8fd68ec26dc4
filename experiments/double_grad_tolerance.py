#!/usr/bin/env python3
"""What ``chip_smoke.py``'s eager_dygraph check reads for its double grad
when the arithmetic is sound, of a lower precision, or wrong.

    python3 experiments/double_grad_tolerance.py

The check's inputs (``a`` [16, 32], ``m`` [32, 8] from RandomState(1)),
the function ``sum(tanh(a m))``, its gradient ``gx`` with respect to
``a`` and the double grad ``d sum(gx^2) / d a``, written out in numpy.
Each variant is held to float64 by the check's metric,
max |diff| / max |reference|, and by the per-element one,
max |diff| / (1 + |reference|). Variants: fp32; fp32 with every product's
operands rounded to TF32 (10 mantissa bits) or bf16 (7); the
second derivative of tanh with its sign flipped. Prints one JSON line.
"""
import json

import numpy as np


def _round(x, bits):
    """x (fp32) rounded to ``bits`` mantissa bits, to nearest."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    drop = 23 - bits
    u = ((u + (1 << (drop - 1))) >> drop) << drop
    return u.astype(np.uint32).view(np.float32)


def grads(a, m, dtype, rnd=None, sign=1.0):
    """(gx, double grad) with every product's operands passed through
    ``rnd``."""
    r = rnd or (lambda x: x)
    a, m = a.astype(dtype), m.astype(dtype)
    t = np.tanh(r(a) @ r(m))
    s = 1 - t * t                      # tanh'
    gx = r(s) @ r(m.T)
    ds = r(2 * gx) @ r(m)              # d sum(gx^2) / d s
    dz = ds * (-2 * sign * t * s)      # tanh'' = -2 t tanh'
    return gx, r(dz) @ r(m.T)


def main():
    rng = np.random.RandomState(1)
    a = rng.randn(16, 32).astype(np.float32)
    m = rng.randn(32, 8).astype(np.float32)
    ref = grads(a, m, np.float64)
    out = {}
    for name, kw in (("fp32", {}),
                     ("tf32", {"rnd": lambda x: _round(x, 10)}),
                     ("bf16", {"rnd": lambda x: _round(x, 7)}),
                     ("tanh2_sign_flipped", {"sign": -1.0})):
        got = grads(a, m, np.float32, **kw)
        out[name] = {
            k: {"of_largest": float(np.max(np.abs(g - w)) / np.max(np.abs(w))),
                "per_element": float(np.max(np.abs(g - w) / (1 + np.abs(w))))}
            for k, g, w in zip(("grad", "double_grad"), got, ref)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
