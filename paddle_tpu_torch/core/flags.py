"""Typed flag/config tree with env-var overrides.

Plays the role of the reference's gflags layer
(paddle/fluid/platform/flags.cc:36-163 defines 69 exported FLAGS_*;
paddle/fluid/pybind/global_value_getter_setter.cc exposes them to Python as
``paddle.set_flags``/``get_flags``). Here: one typed registry, ``FLAGS_*``
env vars honored at first read, same set/get API shape.

The port's copy of the JAX package's ``core/flags.py``: the same names,
defaults and validators. ``check_nan_inf_in_program`` turns on the
eager ``TrainStep``'s non-finite check (one host read a step, none when
off) where the reference turns on ``jax_debug_nans``; ``amp_dtype`` is
``amp.auto_cast``'s default low-precision dtype.
``use_native_tensor_store`` and ``jit_cache_dir`` are registered for
modules not ported yet and read by nothing.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _FlagDef:
    name: str
    default: Any
    type: type
    help: str
    validator: Optional[Callable[[Any], bool]] = None


_REGISTRY: Dict[str, _FlagDef] = {}
_VALUES: Dict[str, Any] = {}
_LOCK = threading.RLock()


def define_flag(name: str, default, help: str = "", type: type = None, validator=None):
    t = type if type is not None else default.__class__
    with _LOCK:
        _REGISTRY[name] = _FlagDef(name, default, t, help, validator)


def _coerce(defn: _FlagDef, value):
    if defn.type is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return defn.type(value)


def get_flag(name: str):
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(f"Unknown flag {name!r}")
        if name in _VALUES:
            return _VALUES[name]
        env = os.environ.get("FLAGS_" + name)
        defn = _REGISTRY[name]
        if env is not None:
            val = _coerce(defn, env)
            _VALUES[name] = val
            return val
        return defn.default


def get_flags(names=None) -> Dict[str, Any]:
    with _LOCK:
        if names is None:
            names = list(_REGISTRY)
        return {n: get_flag(n) for n in names}


def set_flags(flags: Dict[str, Any]):
    with _LOCK:
        for name, value in flags.items():
            key = name[6:] if name.startswith("FLAGS_") else name
            if key not in _REGISTRY:
                raise KeyError(f"Unknown flag {name!r}")
            defn = _REGISTRY[key]
            val = _coerce(defn, value)
            if defn.validator is not None and not defn.validator(val):
                raise ValueError(f"Invalid value {value!r} for flag {name}")
            _VALUES[key] = val


# ---------------------------------------------------------------- core flags
define_flag("default_dtype", "float32", "Default floating dtype for tensor creation")
define_flag("use_native_tensor_store", True,
            "Route paddle.save/load tensor payloads through the native "
            "parallel CRC-checked blob store (native/tensor_store.cc) "
            "when the C++ toolchain is available")
define_flag("check_nan_inf", False, "Scan op outputs for NaN/Inf after each eager op "
            "(analog of reference FLAGS_check_nan_inf, "
            "paddle/fluid/framework/details/nan_inf_utils_detail.cc:33). "
            "Host-syncs every eager op; for jitted/TrainStep code use "
            "check_nan_inf_in_program instead")
define_flag("check_nan_inf_in_program", False,
            "Trap NaNs inside TrainStep: raises FloatingPointError at "
            "the first non-finite loss or gradient, before the update "
            "(in-program analog of FLAGS_check_nan_inf; the reference "
            "turns on jax debug_nans)")
define_flag("eager_op_profile", False, "Record per-op host timing in eager mode")
define_flag("jit_cache_dir", "", "Persistent compile cache directory ('' = disabled)")
define_flag("seed", 0, "Global RNG seed (0 = nondeterministic)")
define_flag("amp_dtype", "bfloat16", "Autocast low-precision dtype (bfloat16 first on TPU)")
define_flag("log_level", "INFO", "Framework log level")
