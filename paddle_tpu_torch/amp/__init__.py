"""Automatic mixed precision (the JAX package's ``amp/``): ``auto_cast``
(O1), ``decorate`` (O2) and ``GradScaler``. The ported functions call
``amp.maybe_cast`` through this package, where a caller can wrap it."""
from .auto_cast import (amp_guard, auto_cast, decorate,  # noqa: F401
                        get_autocast_dtype, get_autocast_level,
                        is_autocast_enabled, maybe_cast)
from .grad_scaler import GradScaler  # noqa: F401
