"""Parity harness for the port's op registry against the JAX package's.

Each case of ``tests/_port_op_cases.py`` runs through the JAX op and the
port's op of the same name: outputs compared for values and dtypes, and
for a differentiable op the gradient of ``sum(out * w)`` (``w`` fixed
random weights) with respect to its first floating operand, by each
package's own ``backward``, under that module's tolerances.
"""
import numpy as np

from _port_op_cases import (  # noqa: F401
    CASES, EXACT, EXCEPTIONS, TR, _dtype_name, _grad_index, _leaves, _np,
    _to, options, tolerance)


def run(pkg, name, with_grad):
    """(outputs as numpy, dtype names, gradient or None) of op ``name``
    of package ``pkg`` (``paddle_tpu`` or ``paddle_tpu_torch``)."""
    from importlib import import_module
    reg = import_module(pkg.__name__ + ".ops.op_registry").OPS[name]
    args, kwargs = CASES[name][0], CASES[name][1]
    gi = _grad_index(name, reg.differentiable) if with_grad else None
    targs = []
    target = None
    for i, a in enumerate(args):
        if i == gi:
            t = _to(pkg, a, stop_gradient=False)
            target = t[0] if isinstance(t, list) else t
            targs.append(t)
        else:
            targs.append(_to(pkg, a))
    out = reg.public(*targs, **kwargs)
    leaves = _leaves(out)
    vals = [_np(o) for o in leaves]
    dtypes = [_dtype_name(o) if hasattr(o, "dtype") else type(o).__name__
              for o in leaves]
    grad = None
    if target is not None:
        loss = None
        w_rng = np.random.RandomState(len(name))
        for o in leaves:
            if not hasattr(o, "dtype") or _dtype_name(o) not in (
                    "float32", "float16"):
                continue
            w = np.asarray(w_rng.randn(*o.shape), np.float32)
            term = (o.astype("float32") * pkg.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        if loss is not None and not loss.stop_gradient:
            loss.backward()
        g = target.grad
        grad = None if g is None else _np(g)
    return vals, dtypes, grad


def registered_by(module: str):
    """The names the JAX package's ``ops/<module>.py`` registers in
    ``OPS``: impls defined in that file, and ``jnp`` functions it
    registers under a name it binds."""
    import importlib
    from paddle_tpu.ops.op_registry import OPS
    mod = importlib.import_module("paddle_tpu.ops." + module)
    names = {n for n, d in OPS.items()
             if getattr(getattr(d.impl, "__code__", None), "co_filename",
                        None) == mod.__file__}
    for v in vars(mod).values():
        on = getattr(v, "op_name", None)
        if on in OPS and OPS[on].impl is getattr(v, "raw", None):
            names.add(on)
    return sorted(names)


def compare(name, jax_run, port_run):
    """Assert the port's (values, dtypes, gradient) equal the JAX
    package's under this module's tolerances."""
    jv, jd, jg = jax_run
    pv, pd, pg = port_run
    tol = tolerance(name)
    assert pd == jd, f"{name}: dtypes {pd} != JAX {jd}"
    assert len(pv) == len(jv)
    for a, b in zip(jv, pv):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{name}: shape {b.shape} != {a.shape}"
        if options(name).get("sorted"):
            a, b = np.sort_complex(a.ravel()), np.sort_complex(b.ravel())
        if name in EXACT or a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=name)
    if jg is None:
        assert pg is None, f"{name}: a gradient where JAX has none"
    elif pg is None:
        # torch records no graph where the gradient is zero by definition
        assert not np.any(jg), f"{name}: no gradient where JAX has one"
    else:
        np.testing.assert_allclose(pg, jg, rtol=tol, atol=tol,
                                   err_msg=name + " gradient")
