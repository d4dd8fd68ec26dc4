"""Paddle's ``fleet.utils.recompute`` and ``RecomputeConfig`` (the JAX
package's ``distributed/fleet/utils/recompute.py``).

``RecomputeConfig`` names the policies with the JAX package's names, so
one config file dials the memory/FLOPs trade in both packages:

    ============================  =========================================
    policy                        keeps
    ============================  =========================================
    ``None``                      everything (recompute OFF)
    ``"full"``                    nothing (alias ``"nothing_saveable"``)
    ``"dots_saveable"``           the outputs of mm, addmm, bmm, baddbmm
                                  (alias ``"core_attn"``)
    ``"dots_with_no_batch_dims_saveable"``  the outputs of mm and addmm
                                  (alias ``"selective"``)
    ============================  =========================================

Where the JAX package takes a raw ``jax.checkpoint_policies`` callable,
this one takes a selective-checkpoint policy function ``(ctx, op, *args,
**kwargs) -> torch.utils.checkpoint.CheckpointPolicy``. What a region
keeps and re-runs is ``distributed.parallel.recompute``'s rule: a
hand-written kernel always runs again.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ...parallel.recompute import _POLICIES, checkpoint_region

__all__ = ["RecomputeConfig", "recompute"]

#: policy name -> selective-checkpoint policy function (None: keep
#: nothing)
_JAX_POLICIES = {
    "full": None,
    "nothing_saveable": None,
    "dots_saveable": _POLICIES["save_dots"],
    "dots_with_no_batch_dims_saveable": _POLICIES["save_dots_no_batch"],
    # the reference's granularity names (models/gpt.py)
    "selective": _POLICIES["save_dots_no_batch"],
    "core_attn": _POLICIES["save_dots"],
}


@dataclass(frozen=True)
class RecomputeConfig:
    """The recompute knob of train steps and model configs.
    ``policy=None`` turns recompute off (``wrap`` is the identity); a
    policy name or function runs a wrapped function as one recompute
    region under that policy."""

    #: a name from _JAX_POLICIES, a selective-checkpoint policy
    #: function, or None (recompute OFF)
    policy: Optional[object] = "full"

    def __post_init__(self):
        if self.policy is not None and not callable(self.policy) \
                and self.policy not in _JAX_POLICIES:
            raise ValueError(
                f"unknown recompute policy {self.policy!r}; one of "
                f"{sorted(set(_JAX_POLICIES))}, a selective-checkpoint "
                f"policy function, or None")

    @property
    def enabled(self) -> bool:
        return self.policy is not None

    def checkpoint_policy(self):
        """The selective-checkpoint policy function (None: keep
        nothing)."""
        if callable(self.policy):
            return self.policy
        return _JAX_POLICIES.get(self.policy)

    def wrap(self, fn: Callable, modules=()) -> Callable:
        """``fn`` as one recompute region under this config, the forward
        state of ``modules`` re-entered when it is recomputed; ``fn``
        itself when disabled."""
        if not self.enabled:
            return fn
        modules = list(modules)

        def wrapped(*args, **kwargs):
            return checkpoint_region(fn, args, kwargs,
                                     self.checkpoint_policy(), modules)
        return wrapped


def _as_config(policy) -> Optional[RecomputeConfig]:
    if policy is None or isinstance(policy, RecomputeConfig):
        return policy
    return RecomputeConfig(policy=policy)


def recompute(function: Callable, *args, **kwargs):
    """``paddle.distributed.fleet.utils.recompute(function, *args)``:
    run ``function`` now, recompute its intermediates in backward.

    The reference's ``use_reentrant`` and ``preserve_rng_state`` are
    accepted and dropped: the region is always non-reentrant and always
    restores the generators. ``policy=`` is a name of
    ``RecomputeConfig`` or a selective-checkpoint policy function;
    ``policy=None`` means "full" (Paddle's recompute always recomputes
    everything); pass ``RecomputeConfig(None)`` to run ``function``
    plainly."""
    kwargs.pop("use_reentrant", None)
    kwargs.pop("preserve_rng_state", None)
    policy = kwargs.pop("policy", "full")
    cfg = _as_config("full" if policy is None else policy)
    if not cfg.enabled:
        return function(*args, **kwargs)
    modules = function.modules() if isinstance(function, torch.nn.Module) \
        else ()
    return checkpoint_region(function, args, kwargs,
                             cfg.checkpoint_policy(), modules)
