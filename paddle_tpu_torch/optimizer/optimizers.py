"""SGD, Momentum, Adagrad, RMSProp, Adam, AdamW, Adamax and Lamb (the
JAX package's ``optimizer/optimizers.py``).

The moments of Momentum and the ``_AdamBase`` family (Adam, AdamW,
Adamax, Lamb) are fp32 whatever the parameter's dtype; Adagrad and
RMSProp keep their state in the parameter's dtype, as the JAX package
does. With ``multi_precision``, a bf16 or fp16 parameter of SGD,
Momentum, Adam or AdamW also gets an fp32 master copy, made from the
parameter (Adam and AdamW when the state is created, SGD and Momentum
at their first update, where the JAX package's state holds ``None``
until then); the update runs on the master and the parameter receives
its rounding.
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


class Adagrad(Optimizer):
    """moment += g^2; p -= lr*g / (sqrt(moment) + eps). The accumulator
    is in the parameter's dtype and starts at
    ``initial_accumulator_value``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": torch.full(param.shape, self._init_acc,
                                     dtype=param.dtype, device=param.device)}

    def _update(self, p, g, state, lr, step):
        m = state["moment"]
        m.add_(g.square())
        p.copy_(p - lr * g / (m.sqrt() + self._epsilon))


class RMSProp(Optimizer):
    """mean_square = rho*ms + (1-rho)*g^2; with ``centered`` also
    mean_grad = rho*mg + (1-rho)*g and the denominator
    sqrt(ms - mg^2 + eps), else sqrt(ms + eps); momentum =
    momentum*mom + lr*g/denom; p -= momentum. State in the parameter's
    dtype."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, param):
        names = ["mean_square", "momentum"] + \
            (["mean_grad"] if self._centered else [])
        return {n: torch.zeros(param.shape, dtype=param.dtype,
                               device=param.device) for n in names}

    def _update(self, p, g, state, lr, step):
        rho = self._rho
        ms = state["mean_square"]
        ms.mul_(rho).add_((1 - rho) * g.square())
        if self._centered:
            mg = state["mean_grad"]
            mg.mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - mg.square() + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = state["momentum"]
        mom.mul_(self._momentum).add_(lr * g / denom)
        p.copy_(p - mom)


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

    def _adam_moments(self, g, state, step):
        """Advance the moments in place; return (mhat, vhat), the JAX
        package's ``_adam_m_v``."""
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        m, v = state["moment1"], state["moment2"]
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32.square() * (1 - b2))
        return m / (1 - b1 ** step), v / (1 - b2 ** step)

    def _adam_step(self, g, state, lr, step):
        """Advance the moments in place; return lr * mhat / (sqrt(vhat)
        + eps), the JAX package's order of operations."""
        mhat, vhat = self._adam_moments(g, state, step)
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


class Adamax(_AdamBase):
    """moment = b1*m + (1-b1)*g, inf_norm = max(b2*u, |g|) (both fp32);
    p -= lr / (1 - b1^step) * m / (u + eps): the bias correction scales
    the step size only."""

    def _init_state(self, param):
        return {n: torch.zeros(param.shape, dtype=torch.float32,
                               device=param.device)
                for n in ("moment", "inf_norm")}

    def _update(self, p, g, state, lr, step):
        b1 = self._beta1
        g32 = g.float()
        m, u = state["moment"], state["inf_norm"]
        m.mul_(b1).add_((1 - b1) * g32)
        torch.maximum(self._beta2 * u, g32.abs(), out=u)
        upd = lr / (1 - b1 ** step) * m / (u + self._epsilon)
        p.copy_(p.float() - upd)


class Lamb(_AdamBase):
    """Layer-wise adaptive moments: r = mhat / (sqrt(vhat) + eps) +
    lamb_weight_decay * p, p -= lr * trust * r with trust = |p| / |r|
    (per-tensor fp32 norms), or 1 when either norm is 0.

    ``exclude_from_weight_decay_fn`` is accepted and, as in the JAX
    package's code, never applied: every parameter decays (ROADMAP
    C8)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update(self, p, g, state, lr, step):
        mhat, vhat = self._adam_moments(g, state, step)
        p32 = p.float()
        r = mhat / (vhat.sqrt() + self._epsilon) + self._lamb_wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.copy_(p32 - lr * trust * r)
