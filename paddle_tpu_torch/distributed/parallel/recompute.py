"""Activation recompute (the JAX package's
``distributed/parallel/recompute.py``): ``recompute``,
``RecomputeWrapper``.

A recompute region runs its function now and keeps only its inputs
(under a selective policy also the products the policy names); the
backward pass runs the function again to get what its gradients need.
It is ``torch.utils.checkpoint`` in non-reentrant mode. The policies:

- ``"full"`` (or None): nothing is kept;
- ``"save_dots"``: the outputs of ``aten.mm``, ``addmm``, ``bmm`` and
  ``baddbmm`` are kept (JAX's ``dots_saveable``);
- ``"save_dots_no_batch"``: the outputs of ``mm`` and ``addmm`` only,
  the Linear products and not attention's batched ones (JAX's
  ``dots_with_no_batch_dims_saveable``).

Either selective policy is ``torch.utils.checkpoint``'s selective
checkpointing, which sees aten ops only. A hand-written kernel
(``kernels/``, launched through ``ctypes``) is never an aten op, so it
runs again in backward under every policy: a recomputed GPT block
launches the flash forward twice a step.

The recomputation runs as the forward ran, as upstream Paddle's
``RecomputeFunction`` makes sure: the forward's state is captured when
it starts and re-entered around the recomputation, then the state of
that moment is put back. That state is the port's own default
generators (``core.random``; dropout draws its masks from them, and
``torch.utils.checkpoint``'s ``preserve_rng_state`` restores only
torch's default generators), the AMP state (``amp.auto_cast``), the
``TrainStep`` mark (``nn.layers_common.train_step_trace``) and each
module's ``training`` flag. Batch norm's running statistics stay as they
are during a recomputation: the forward moved them already.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp.auto_cast import _get_state as _amp_state
from ...amp.auto_cast import _set_state as _set_amp_state
from ...core import random as random_mod
from ...nn import layers_common

__all__ = ["recompute", "RecomputeWrapper", "checkpoint_region"]

_aten = torch.ops.aten


def _saving(packets):
    """A selective-checkpoint policy that keeps the outputs of
    ``packets`` and recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in packets:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


_POLICIES = {
    None: None,
    "full": None,  # save nothing, recompute everything
    "save_dots": _saving({_aten.mm, _aten.addmm, _aten.bmm,
                          _aten.baddbmm}),
    "save_dots_no_batch": _saving({_aten.mm, _aten.addmm}),
}


class _ForwardState:
    """What a region's forward saw: taken by ``capture()`` as the
    forward starts; entered around each recomputation (this object is
    the recompute context), it puts that state back with the running
    statistics frozen, and after it what was current then."""

    def __init__(self, modules):
        self.modules = list(modules)
        self.taken = None

    def _now(self):
        return (random_mod.get_states(), _amp_state(),
                layers_common.in_train_step(),
                [m.training for m in self.modules])

    def _put(self, state):
        gens, amp_state, traced, training = state
        random_mod.set_states(gens)
        _set_amp_state(amp_state)
        layers_common._FROZEN.traced = traced
        for m, t in zip(self.modules, training):
            m.training = t

    @contextlib.contextmanager
    def capture(self):
        self.taken = self._now()
        yield

    def __enter__(self):
        self.current = self._now()
        self._put(self.taken)
        self.frozen = layers_common.frozen_running_stats()
        self.frozen.__enter__()

    def __exit__(self, *exc):
        self.frozen.__exit__(*exc)
        self._put(self.current)
        return False


class _Both:
    """Two context managers as one, ``outer`` entered first."""

    def __init__(self, outer, inner):
        self.outer, self.inner = outer, inner

    def __enter__(self):
        self.outer.__enter__()
        try:
            self.inner.__enter__()
        except BaseException:
            self.outer.__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        try:
            self.inner.__exit__(*exc)
        finally:
            self.outer.__exit__(*exc)
        return False


def checkpoint_region(function: Callable, args, kwargs, policy=None,
                      modules: Iterable[torch.nn.Module] = ()):
    """``function(*args, **kwargs)`` as one recompute region under the
    selective-checkpoint ``policy`` function (None: keep nothing), with
    the forward state of ``modules`` re-entered at recomputation."""
    def context_fn():
        fs = _ForwardState(modules)
        fwd, rec = fs.capture(), fs
        if policy is not None:
            sac_fwd, sac_rec = create_selective_checkpoint_contexts(policy)
            fwd, rec = _Both(sac_fwd, fwd), _Both(sac_rec, rec)
        return fwd, rec

    return checkpoint(function, *args, use_reentrant=False,
                      context_fn=context_fn, **kwargs)


def _policy_fn(policy):
    if policy is None or callable(policy):
        return policy
    try:
        return _POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown recompute policy {policy!r}; one of "
                         f"{sorted(k for k in _POLICIES if k)}, a "
                         f"selective-checkpoint policy function, or "
                         f"None") from None


def recompute(function: Callable, *args, policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` now and recompute its
    intermediates in backward. ``policy`` is a name of ``_POLICIES``
    or a selective-checkpoint policy function ``(ctx, op, *args,
    **kwargs) -> CheckpointPolicy``. A module's parameters need no
    special handling: autograd reaches them through the region."""
    modules = function.modules() if isinstance(function, torch.nn.Module) \
        else ()
    return checkpoint_region(function, args, kwargs, _policy_fn(policy),
                             modules)


class RecomputeWrapper(torch.nn.Module):
    """A sublayer whose forward is recomputed in backward."""

    def __init__(self, layer: torch.nn.Module, policy=None):
        super().__init__()
        self.inner = layer
        self.policy = policy

    def forward(self, *args, **kwargs):
        return recompute(self.inner, *args, policy=self.policy, **kwargs)
