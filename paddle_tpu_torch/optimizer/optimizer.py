"""Optimizer base (the JAX package's ``optimizer/optimizer.py``).

Every optimizer defines one update rule ``_update(param, grad, state,
lr, step)`` that writes the new parameter and state in place (the JAX
package's pure rule returns them; in PyTorch the in-place write saves
a copy of every parameter and moment per step). ``step()`` applies it
to each parameter's ``.grad``; ``apply_gradients()`` to given
gradients, which is how ``jit.TrainStep`` calls it. State is kept per
parameter tensor, and ``state_dict()`` lays it out as the JAX package
does (``param_{i}`` by position in the parameter list, plus
``_step_count`` and ``LR_Scheduler``).

A parameter's ``regularizer`` attribute (``regularizer.L1Decay`` or
``L2Decay``) wins over the optimizer's ``weight_decay`` for that
parameter. With ``offload_state`` (``jit.TrainStep(offload_opt_state=
True)`` sets it on a CUDA card), the state lives in pinned host memory
between updates: each parameter's state is copied to the card for its
update and back after it, and the update waits for the copies before it
returns.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from .lr import LRScheduler


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = False):
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = float(weight_decay) \
            if isinstance(weight_decay, (int, float)) else weight_decay
        self.multi_precision = multi_precision
        self._state: Dict[torch.Tensor, Dict[str, torch.Tensor]] = {}
        self._step_count = 0
        self.offload_state = False

    # ------------------------------------------------------------- LR
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value: float):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    # ------------------------------------------------------------- rule
    def _init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def state_for(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The state of ``param``, created on first use."""
        st = self._state.get(param)
        if st is None:
            st = self._state[param] = self._init_state(param)
        return st

    def _update(self, p, g, state, lr, step):
        """Update ``p`` and ``state`` in place from gradient ``g``."""
        raise NotImplementedError

    def _decoupled_decay(self) -> bool:
        return False

    def _apply_decay(self, g, p, reg=None):
        """A parameter's own regularizer ``reg`` wins; else a float
        weight decay is coupled L2 (added to the gradient) except for
        decoupled optimizers (AdamW), and a callable weight decay maps
        (grad, param) to the decayed grad."""
        if reg is not None:
            return reg(g, p)
        wd = self._weight_decay
        if callable(wd) and not isinstance(wd, float):
            return wd(g, p)
        if isinstance(wd, float) and wd and not self._decoupled_decay():
            # the coefficient in p's dtype, as JAX's weak-typed scalar
            return g + torch.tensor(wd, dtype=p.dtype, device=p.device) * p
        return g

    @torch.no_grad()
    def apply_gradients(self, params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor], lr=None, step=None):
        """Clip ``grads`` as a whole, then update each parameter and its
        state in place with learning rate ``lr`` (default: the current
        one) at step number ``step`` (default: the next)."""
        lr = self.get_lr() if lr is None else float(lr)
        step = (self._step_count + 1) if step is None else int(step)
        params, grads = list(params), list(grads)
        regs = self._param_regularizers(params) or [None] * len(params)
        if self._grad_clip is not None:
            grads = self._grad_clip(grads)
        offload = self.offload_state and any(p.is_cuda for p in params)
        for p, g, reg in zip(params, grads, regs):
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            g = self._apply_decay(g, p, reg)
            if offload:
                self._update_offloaded(p, g, lr, step)
            else:
                self._update(p, g, self.state_for(p), lr, step)
        if offload:
            torch.cuda.current_stream(params[0].device).synchronize()

    def _update_offloaded(self, p, g, lr, step):
        """``_update`` on a card copy of ``p``'s state, which then goes
        back into pinned host tensors (made at the first update)."""
        host = self.state_for(p)
        dev = {k: v.to(p.device, non_blocking=True)
               for k, v in host.items()}
        self._update(p, g, dev, lr, step)
        parked = {}
        for k, v in dev.items():
            h = host.get(k)
            if h is None or h.is_cuda:
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            parked[k] = h.copy_(v, non_blocking=True)
        self._state[p] = parked

    def _param_regularizers(self, params):
        """The ``regularizer`` of each of ``params``, or None when no
        parameter of the optimizer has one. Parameters of the
        optimizer's list match by identity; otherwise the list is read
        in order, and a count mismatch raises (the JAX package's rule
        for its functional update)."""
        plist = self._parameter_list
        if plist is None:
            return None
        by_id = {id(p): getattr(p, "regularizer", None) for p in plist}
        if not any(r is not None for r in by_id.values()):
            return None
        if all(id(p) in by_id for p in params):
            return [by_id[id(p)] for p in params]
        if len(plist) != len(params):
            raise ValueError(
                f"per-parameter regularizers are set but the update "
                f"received {len(params)} params vs the optimizer's "
                f"{len(plist)} — construct the optimizer with the same "
                f"parameter list the train step uses (e.g. "
                f"model.parameters()) so they can be matched")
        return [getattr(p, "regularizer", None) for p in plist]

    # ------------------------------------------------------------- dygraph
    def step(self):
        if self._parameter_list is None:
            raise RuntimeError("Optimizer was constructed without "
                               "parameters; use apply_gradients instead")
        live = [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        lr = self.get_lr()
        self._step_count += 1
        self.apply_gradients(live, [p.grad for p in live], lr,
                             self._step_count)
        if isinstance(self._lr, LRScheduler) and self._lr._step_each_iter:
            self._lr.step()

    def clear_grad(self):
        if self._parameter_list is not None:
            for p in self._parameter_list:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward, step and clear_grad on an eager loss. The static
        program path is not ported (ROADMAP A13)."""
        if startup_program is not None or parameters is not None or \
                no_grad_set is not None:
            raise NotImplementedError(
                "minimize with a program, parameters or no_grad_set is the "
                "static path, not ported yet (ROADMAP A13)")
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # ------------------------------------------------------------- state io
    def state_dict(self) -> Dict[str, Any]:
        sd: Dict[str, Any] = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list or ()):
            st = self._state.get(p)
            if st:
                sd[f"param_{i}"] = dict(st)
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state_dict: Dict[str, Any]):
        """Load a ``state_dict()``: per-parameter tensors (or arrays) are
        copied onto their parameter's device; shapes must match the
        parameter's."""
        plist: List[torch.Tensor] = self._parameter_list or []
        for i, p in enumerate(plist):
            entry = state_dict.get(f"param_{i}")
            if entry is None:
                continue
            st = {}
            for k, v in entry.items():
                t = torch.as_tensor(v).to(p.device).clone()
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"param_{i}.{k}: shape "
                                     f"{tuple(t.shape)} != {tuple(p.shape)}")
                st[k] = t
            self._state[p] = st
        self._step_count = int(state_dict.get("_step_count", 0))
        if isinstance(self._lr, LRScheduler) and \
                "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(state_dict["LR_Scheduler"])

