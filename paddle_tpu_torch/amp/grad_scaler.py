"""``GradScaler`` (the JAX package's ``amp/grad_scaler.py``): dynamic
loss scaling for float16 training.

``scale`` multiplies the loss by the scale; ``step`` unscales every
gradient of the optimizer's parameter list, skips the update when any
of them is not finite, and moves the scale: times ``decr_ratio`` (not
below 1) after ``decr_every_n_nan_or_inf`` bad steps in a row, times
``incr_ratio`` after ``incr_every_n_steps`` good ones. ``step`` unscales
even when ``unscale_`` ran before it, as the reference's does. One host
read a step decides the skip, over all the gradients together (the
reference reads each gradient's check on its own; the decision is the
same). With the monitor on, each step records ``amp.scaler.steps``,
``amp.scaler.skipped`` and the gauge ``amp.loss_scale``.
"""
from __future__ import annotations

import torch

from ..core import monitor


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.**15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self) -> bool:
        return self._enable

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Every gradient of ``optimizer``'s parameters times 1/scale, in
        place; remembers whether any of them is not finite."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list or ()
                 if p.grad is not None]
        inv = 1.0 / self._scale
        for g in grads:
            g.mul_(inv)
        self._found_inf = bool(grads) and not bool(
            torch.stack([torch.isfinite(g).all() for g in grads]).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        monitor.record_scaler_step(self._found_inf, self._scale)
        self._update_scale()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass  # the scale moves in step(), as in the reference

    def _update_scale(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
