"""SGD, Momentum, Adam and AdamW (the JAX package's
``optimizer/optimizers.py:28-77, 124-199``).

Moments and velocities are fp32 whatever the parameter's dtype. With
``multi_precision``, a bf16 or fp16 parameter also gets an fp32 master
copy, made from the parameter (Adam and AdamW when the state is
created, SGD and Momentum at their first update, where the JAX
package's state holds ``None`` until then); the update runs on the
master and the parameter receives its rounding. The other optimizers
of the JAX package are not ported yet (ROADMAP A4).
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer


def _low_precision(param):
    return param.dtype in (torch.bfloat16, torch.float16)


def _step_master(p, state, upd):
    """master -= upd (the master made from p at the first update) and
    p = master rounded to p's dtype."""
    master = state.get("master")
    if master is None:
        master = state["master"] = p.detach().float().clone()
    master.sub_(upd)
    p.copy_(master)


class SGD(Optimizer):
    """p -= lr * g, in p's dtype (on the fp32 master with
    ``multi_precision``)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)

    def _update(self, p, g, state, lr, step):
        if self.multi_precision and _low_precision(p):
            _step_master(p, state, lr * g.float())
            return
        p.copy_(p - lr * g)


class Momentum(Optimizer):
    """v = momentum*v + g (fp32); p -= lr * v, or lr * (g + momentum*v)
    with ``use_nesterov``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, param):
        return {"velocity": torch.zeros(param.shape, dtype=torch.float32,
                                        device=param.device)}

    def _update(self, p, g, state, lr, step):
        g32 = g.float()
        v = state["velocity"]
        v.mul_(self._momentum).add_(g32)
        upd = lr * ((g32 + self._momentum * v) if self._nesterov else v)
        if self.multi_precision and _low_precision(p):
            _step_master(p, state, upd)
            return
        p.copy_(p.float() - upd)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision=multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, param):
        st = {"moment1": torch.zeros(param.shape, dtype=torch.float32,
                                     device=param.device),
              "moment2": torch.zeros(param.shape, dtype=torch.float32,
                                     device=param.device)}
        if self.multi_precision and param.dtype in (torch.bfloat16,
                                                    torch.float16):
            st["master"] = param.detach().float().clone()
        return st

    def _adam_step(self, g, state, lr, step):
        """Advance the moments in place; return lr * mhat / (sqrt(vhat)
        + eps), the JAX package's order of operations."""
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m, v = state["moment1"], state["moment2"]
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32.square() * (1 - b2))
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        return lr * mhat / (vhat.sqrt() + self._epsilon)

    def _decay_factor(self, lr) -> float:
        return 1.0

    def _update(self, p, g, state, lr, step):
        upd = self._adam_step(g, state, lr, step)
        decay = self._decay_factor(lr)
        if "master" in state:
            master = state["master"]
            if decay != 1.0:
                master.mul_(decay)
            master.sub_(upd)
            p.copy_(master)
            return
        p32 = p.float()
        if decay != 1.0:
            p32 = p32 * decay
        p.copy_(p32 - upd)


class Adam(_AdamBase):
    """Adam; a float ``weight_decay`` is coupled L2 on the gradient."""


class AdamW(_AdamBase):
    """Decoupled weight decay: ``param *= 1 - lr * weight_decay`` before
    the Adam step (coefficient default 0.01).

    ``apply_decay_param_fun`` is accepted and, as in the JAX package's
    code, not applied: every parameter decays (ROADMAP C4)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 apply_decay_param_fun=None, lr_ratio=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         float(weight_decay), grad_clip,
                         multi_precision=multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_decay(self):
        return True

    def _decay_factor(self, lr) -> float:
        return 1.0 - lr * (self._weight_decay or 0.0)
