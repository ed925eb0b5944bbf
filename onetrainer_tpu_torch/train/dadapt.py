"""D-Adaptation (Defazio and Mishchenko, ICML 2023) and its directions.

Counterpart of onetrainer_tpu/train/dadapt.py, which re-derives the
reference's DAdaptSGD, DAdaptLion, DAdaptAdaGrad and DAdaptAdan (the
dadaptation package) rather than copying them, and says so; the port
follows the JAX package, not the package. `DAdaptation` wraps a direction
(an un-scaled descent direction with its own state) in the dual-averaging
estimate of d: with gamma = lr(count) and |g0| the first step's gradient
norm, dlr = d gamma / |g0|; the numerator accumulates dlr <g, s>,
s += dlr g, d = max(d, min(2 numerator / |s|, d growth_rate)) for the next
step, and the update is -dlr times the direction. s and the scalars are
fp32, the update too. Aida (scale_by_aida) is train/optimizers.py:`Aida`.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.train.optimizers import (
    OptState, Step, _GroupWide, _rss, _sum_products, _trace, _zeros, LeafLocal, Lion,
    _norm_f32, _f32,
)


class SGDDirection(LeafLocal):
    """The gradient, or its optax.trace(momentum) when momentum is set."""

    def __init__(self, momentum: float = 0.0):
        super().__init__()
        self.momentum = momentum

    def leaf_state(self, p, dtype):
        return {"trace": _zeros(p, dtype)} if self.momentum else {}

    def direction(self, params, grads, st, s):
        if not self.momentum:
            return [g.clone() for g in grads]
        return _trace(st["trace"], grads, self.momentum, False, s)


class LionDirection(Lion):
    """optax.scale_by_lion: sign((1-b1) g + b1 mu), mu = (1-b2) g + b2 mu."""

    def __init__(self, b1: float = 0.9, b2: float = 0.99):
        super().__init__(None, b1, b2)


class AdaGradDirection(LeafLocal):
    """optax.scale_by_rss from 0: g / sqrt(sum g^2 + eps)."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def leaf_state(self, p, dtype):
        return {"sum_of_squares": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        return _rss(st["sum_of_squares"], grads, self.eps, s)


class AdanDirection(LeafLocal):
    """scale_by_adan (Xie et al. 2022), fp32: with the gradient difference
    dg (0 at the first step), m = b1 m + (1-b1) g, v = b2 v + (1-b2) dg,
    n = b3 n + (1-b3) (g + (1-b2) dg)^2, direction (m / c1 + (1-b2) v / c2)
    / (sqrt(n / c3) + eps)."""

    state_dtype = torch.float32

    def __init__(self, b1=0.98, b2=0.92, b3=0.99, eps=1e-8):
        super().__init__()
        self.b1, self.b2, self.b3, self.eps = b1, b2, b3, eps

    def leaf_state(self, p, dtype):
        return {name: _zeros(p, torch.float32) for name in ("m", "v", "n", "prev_grad")}

    def direction(self, params, grads, st, s):
        grads = [g.float() for g in grads]
        diff = torch._foreach_sub(grads, st["prev_grad"])
        if s.t == 1:
            torch._foreach_zero_(diff)
        torch._foreach_mul_(st["m"], s.r(self.b1))
        torch._foreach_add_(st["m"], torch._foreach_mul(grads, s.r(1.0 - self.b1)))
        torch._foreach_mul_(st["v"], s.r(self.b2))
        torch._foreach_add_(st["v"], torch._foreach_mul(diff, s.r(1.0 - self.b2)))
        nesterov = torch._foreach_mul(diff, s.r(1.0 - self.b2))
        del diff
        torch._foreach_add_(nesterov, grads)
        torch._foreach_mul_(nesterov, nesterov)
        torch._foreach_mul_(nesterov, s.r(1.0 - self.b3))
        torch._foreach_mul_(st["n"], s.r(self.b3))
        torch._foreach_add_(st["n"], nesterov)
        del nesterov
        torch._foreach_copy_(st["prev_grad"], grads)
        u = torch._foreach_div(st["m"], s.correction(self.b1))
        v = torch._foreach_mul(st["v"], s.r(1.0 - self.b2))
        torch._foreach_div_(v, s.correction(self.b2))
        torch._foreach_add_(u, v)
        del v
        denom = torch._foreach_div(st["n"], s.correction(self.b3))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, s.r(self.eps))
        torch._foreach_div_(u, denom)
        return u


class DAdaptation(_GroupWide):
    """`d_adaptation(base, lr, d0, growth_rate)` of the JAX package, with
    `l2` p added to the gradient first (add_decayed_weights chained before
    it, as the JAX package builds every D-Adapt variant)."""

    def __init__(self, base: LeafLocal, learning_rate, d0: float = 1e-6,
                 growth_rate: float = float("inf"), l2: float = 0.0):
        super().__init__(learning_rate)
        self.base, self.d0, self.growth_rate, self.l2 = base, d0, growth_rate, l2

    def init(self, params):
        like = params[0] if params else torch.zeros(())

        def scalar(x):
            return torch.tensor(x, dtype=torch.float32, device=like.device)
        return OptState({"s": [_zeros(p, torch.float32) for p in params]},
                        {"numerator": scalar(0.0), "d": scalar(self.d0),
                         "g0_norm": scalar(0.0)},
                        inner=self.base.init(params))

    def _updates(self, params, grads, state):
        if self.l2:
            l2 = Step(params[0].dtype, 0, 0.0).r(self.l2)
            grads = torch._foreach_add(grads, torch._foreach_mul(params, l2))
        gamma = _f32(float(self.schedule(state.count))).item()
        if state.count == 0:
            state.g0_norm.copy_(_norm_f32(grads))
        dlr = state.d * gamma / torch.clamp(state.g0_norm, min=1e-30)
        state.numerator.add_(dlr * _sum_products(grads, state.s))
        torch._foreach_add_(state.s, torch._foreach_mul([g.float() for g in grads], dlr))
        d_hat = 2.0 * state.numerator / torch.clamp(_norm_f32(state.s), min=1e-30)
        directions = self.base.updates(params, grads, state.inner)
        state.count += 1
        state.d.copy_(torch.maximum(state.d, torch.minimum(d_hat, state.d * self.growth_rate)))
        u = [t.float() for t in directions]
        del directions
        torch._foreach_mul_(u, -dlr)
        return u


def dadapt_sgd(learning_rate, momentum=0.0, d0=1e-6, weight_decay=0.0,
               growth_rate=float("inf")):
    return DAdaptation(SGDDirection(momentum), learning_rate, d0, growth_rate, weight_decay)


def dadapt_lion(learning_rate, b1=0.9, b2=0.99, d0=1e-6, weight_decay=0.0):
    return DAdaptation(LionDirection(b1, b2), learning_rate, d0, l2=weight_decay)


def dadapt_adagrad(learning_rate, eps=0.0, d0=1e-6, weight_decay=0.0):
    return DAdaptation(AdaGradDirection(max(eps, 1e-8)), learning_rate, d0, l2=weight_decay)


def dadapt_adan(learning_rate, b1=0.98, b2=0.92, b3=0.99, eps=1e-8, d0=1e-6,
                weight_decay=0.0):
    return DAdaptation(AdanDirection(b1, b2, b3, eps), learning_rate, d0, l2=weight_decay)
