"""Optimizers, gradient accumulation and the schedule-free eval params.

Counterpart of onetrainer_tpu/train/optimizers.py (`create_optimizer`, the
clip + multi-group chain that setup/sd_setup.py builds with optax, wrapped
in optax.MultiSteps for gradient accumulation, and
`schedule_free_eval_params`). Every optimizer the reference builds is
written here by hand to the formulas of optax 0.2.6 (or of the reference's
own transforms: CAME, Tiger; D-Adaptation and Aida are train/dadapt.py),
so the two sides take the same steps:

- clip by global norm: g * (c / |g|) when |g| >= c, else g
  (optax.clip_by_global_norm; not torch's clip_grad_norm_, which adds
  1e-6 to the norm);
- optax counts steps from 0: a schedule is read at the step count before
  the update, a bias correction at the count after it (schedule-free reads
  its averaging weight at the count after it too);
- the `_8BIT` variants keep every fp32 state tensor of at least 16384
  elements as block-wise int8 (ops/quant_opt.py), quantized leaf by leaf
  inside the update;
- accumulation: optax.MultiSteps over the clipped group optimizer, the
  running mean of k micro-batch gradients, one update every k micro-steps
  and none in between (`MultiSteps`).

The optimizer returns each step's updates and the caller adds them
(optax.apply_updates, `add_updates_`), or rounds them in stochastically
for bf16 parameters. The updates keep optax's dtypes and operation order:
the state is held in the parameters' dtype (bf16 for bf16 adapters) where
optax holds it so, python constants are rounded to that dtype before use
(jnp's weakly typed scalars), and every operation rounds its result, so a
bf16 update is what optax computes in bf16 and an fp32 update what it
computes in fp32. fp16 parameters (fp16 LoRA weights) are the exception:
in fp16, optax's eps 1e-8 and the squares of small gradients underflow to
0, and AdamW gives every element with a zero gradient 0/0 (ROADMAP F15), so
their state is fp32 and their update is computed and returned in fp32:
`add_updates_` adds it in fp32 and rounds the sum once to fp16. fp8
parameters (fp8 LoRA weights) are updated alike (optax computes it all in
fp8, where AdamW's first update is NaN in every element: ROADMAP F17), and
torch has no arithmetic in 1-byte floats, so their gradients and
MultiSteps' means are fp32 too (`arithmetic_dtype`). The global norm of
bf16 gradients is taken in bf16 too.

Elementwise work runs as one `_foreach` launch per operation over a
group. Optimizers whose step reduces over the whole group first (Prodigy,
D-Adaptation, schedule-free's averaging weight) finish those reductions,
kept as 0-dim device tensors, when their first update is asked for, while
every gradient of the group still exists (the step frees the gradients of
each chunk it has applied).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from onetrainer_tpu_torch.ops.quant_opt import Q8, dequantize, eligible, quantize, quantize_into
from onetrainer_tpu_torch.util.enums import Optimizer


def _d(value, default):
    return default if value is None else value


def arithmetic_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the gradients, means and updates of parameters of
    `dtype`: their own, but fp32 for 1-byte floats (fp8), in which torch
    has no arithmetic."""
    return torch.float32 if dtype.is_floating_point and dtype.itemsize == 1 else dtype


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The state and arithmetic of parameters of `dtype`: their own, but
    fp32 for fp16 and fp8 (see the module docstring)."""
    return torch.float32 if dtype == torch.float16 else arithmetic_dtype(dtype)


@torch.no_grad()
def add_updates_(params: list[torch.Tensor], updates: list[torch.Tensor]) -> None:
    """p += u for each pair (optax.apply_updates); a parameter whose
    update is wider (the fp32 updates of fp16 and fp8 parameters) takes
    the sum made in the update's dtype, rounded once."""
    same = [i for i, (p, u) in enumerate(zip(params, updates)) if p.dtype == u.dtype]
    if len(same) == len(params):
        torch._foreach_add_(params, updates)
        return
    if same:
        torch._foreach_add_([params[i] for i in same], [updates[i] for i in same])
    for p, u in zip(params, updates):
        if p.dtype != u.dtype:
            p.copy_(p.to(u.dtype) + u)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _as_schedule(learning_rate):
    return learning_rate if callable(learning_rate) else (lambda step, lr=learning_rate: lr)


class OptState:
    """An optimizer's state for one group: the step count, per-tensor state
    lists by name (a tensor, an int8 `Q8`, or None where a tensor has no
    such entry), 0-dim scalars by name, and the state of a wrapped
    optimizer (`inner`), which counts the same steps. Lists and scalars
    read as attributes (`state.mu`)."""

    def __init__(self, leaves: dict | None = None, scalars: dict | None = None,
                 inner: OptState | None = None):
        self.__dict__.update(_count=0, leaves=leaves or {}, scalars=scalars or {},
                             inner=inner, b1=None)

    @property
    def count(self) -> int:
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._count = value
        if self.inner is not None:
            self.inner.count = value

    def __getattr__(self, name):
        for table in ("leaves", "scalars"):
            if name in self.__dict__[table]:
                return self.__dict__[table][name]
        raise AttributeError(name)

    def tensors(self) -> dict[str, torch.Tensor]:
        """Every state tensor by a stable name (backups copy them in place):
        <name>/<index>, an int8 tensor's as <name>/<index>/codes and
        /scales, a scalar as <name>, a wrapped state's under inner/."""
        out = {}
        for name, values in self.leaves.items():
            for i, t in enumerate(values):
                if isinstance(t, Q8):
                    out[f"{name}/{i}/codes"], out[f"{name}/{i}/scales"] = t.codes, t.scales
                elif t is not None:
                    out[f"{name}/{i}"] = t
        out.update(self.scalars)
        if self.inner is not None:
            out.update({f"inner/{k}": t for k, t in self.inner.tensors().items()})
        return out


class Step:
    """One step's constants: `count`, optax's count before the update
    (the schedule's step), `t` = count + 1 (the bias corrections'), the
    learning rate at `count`, and `r(x)`, a python constant rounded to the
    state's dtype as jnp rounds a weakly typed scalar."""

    def __init__(self, dtype: torch.dtype, count: int, lr: float):
        self.dtype, self.count, self.t, self.lr = dtype, count, count + 1, lr

    def r(self, x) -> float:
        return s_r(self.dtype, x)

    def correction(self, decay: float, count: int | None = None) -> float:
        """1 - decay^t in fp32 (powf, as XLA), then the state's dtype."""
        t = self.t if count is None else count
        return self.r(1.0 - _f32(decay) ** _f32(t))


def _sum_products(xs: list[torch.Tensor], ys: list[torch.Tensor]) -> torch.Tensor:
    """sum over the tensors of sum(x * y), fp32 (optax.tree.vdot)."""
    if not xs:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([torch.dot(x.reshape(-1).float(), y.reshape(-1).float())
                        for x, y in zip(xs, ys)]).sum()


def _sum_abs(xs: list[torch.Tensor]) -> torch.Tensor:
    """sum over the tensors of sum(|x|), fp32 (optax.tree.sum of abs)."""
    return torch.stack(torch._foreach_norm([x.float() for x in xs], 1)).sum()


def _norm_f32(xs: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element, fp32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([x.float() for x in xs])))


def _tensor_norms(xs: list[torch.Tensor]) -> torch.Tensor:
    """Each tensor's 2-norm (jnp.linalg.norm over all its elements)."""
    return torch.stack(torch._foreach_norm(xs))


def _trust_ratios(params, updates, coefficient: float, eps: float) -> list[torch.Tensor]:
    """optax.scale_by_trust_ratio's factor per tensor: c |p| / (|u| + eps),
    1 where either norm is 0."""
    p_norm, u_norm = _tensor_norms(params), _tensor_norms(updates)
    ratio = coefficient * p_norm / (u_norm + eps)
    ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)
    return list(ratio.unbind())


def _check_one_dtype(params) -> torch.dtype:
    dtype = params[0].dtype
    if any(p.dtype != dtype for p in params):
        raise TypeError("one optimizer group must hold one dtype")
    return dtype


class LeafLocal:
    """An optimizer whose update of a tensor reads only that tensor's
    gradient, parameter and state, and the step's constants. Subclasses
    give `leaf_state` (the state entries of one parameter) and `direction`
    (optax's scale_by_* transform, updating the state lists in place); the
    chain around it is `l2` p added to the gradient before it
    (add_decayed_weights chained first), `weight_decay` p added after it,
    then the learning rate (`scale`, which subclasses with a different
    chain replace).

    With `int8` (the `_8BIT` variants) every state tensor that
    ops/quant_opt.py takes persists as int8: each such tensor's state is
    dequantized, updated and quantized back when its update is asked for,
    one tensor at a time; the other tensors' updates are made together
    with the first."""

    l2 = 0.0
    weight_decay = 0.0
    int8 = False
    state_dtype: torch.dtype | None = None   # a fixed state dtype (else the params')

    def __init__(self, learning_rate=None):
        # None: a direction for another optimizer to scale (train/dadapt.py)
        self.schedule = None if learning_rate is None else _as_schedule(learning_rate)

    def leaf_state(self, p: torch.Tensor, dtype: torch.dtype) -> dict[str, torch.Tensor]:
        return {}

    def init(self, params: list[torch.Tensor]) -> OptState:
        state = OptState()
        for p in params:
            dtype = self.state_dtype or _compute_dtype(p.dtype)
            for name, t in self.leaf_state(p, dtype).items():
                state.leaves.setdefault(name, []).append(
                    quantize(t) if self.int8 and t is not None and eligible(t) else t)
        return state

    def direction(self, params, grads, st: dict, s: Step) -> list[torch.Tensor]:
        raise NotImplementedError

    def scale(self, params, u: list[torch.Tensor], st: dict, s: Step) -> list[torch.Tensor]:
        if self.schedule is not None:
            torch._foreach_mul_(u, s.r(-s.lr))
        return u

    def compute(self, params, grads, st: dict, s: Step) -> list[torch.Tensor]:
        """The updates of the tensors whose state lists are `st`."""
        if self.l2:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, s.r(self.l2)))
        u = self.direction(params, grads, st, s)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params, s.r(self.weight_decay)))
        return self.scale(params, u, st, s)

    def begin(self, params, state: OptState) -> Step:
        """The step's constants; advances the count."""
        lr = 0.0 if self.schedule is None else float(self.schedule(state.count))
        s = Step(self.state_dtype or _compute_dtype(params[0].dtype), state.count, lr)
        state.count += 1
        return s

    def updates(self, params, grads, state: OptState) -> list[torch.Tensor]:
        """One step's updates (to add to `params`), advancing `state`."""
        return list(self.leaf_updates(params, grads, state))

    @torch.no_grad()
    def leaf_updates(self, params, grads, state: OptState):
        """`updates`' tensors one by one."""
        if not params:
            return
        dtype = _check_one_dtype(params)
        compute_dtype = _compute_dtype(dtype)
        if compute_dtype != dtype:
            grads = [g.to(compute_dtype) for g in grads]
            params = [p.to(compute_dtype) for p in params]
        s = self.begin(params, state)
        names = list(state.leaves)
        quantized = [any(isinstance(state.leaves[k][i], Q8) for k in names)
                     for i in range(len(params))]
        if not any(quantized):
            yield from self.compute(params, grads, state.leaves, s)
            return
        plain = [i for i, q in enumerate(quantized) if not q]
        done = dict(zip(plain, self.compute(
            [params[i] for i in plain], [grads[i] for i in plain],
            {k: [v[i] for i in plain] for k, v in state.leaves.items()}, s) if plain else []))
        for i, q in enumerate(quantized):
            if not q:
                yield done.pop(i)
                continue
            st = {k: [dequantize(v[i]) if isinstance(v[i], Q8) else v[i]]
                  for k, v in state.leaves.items()}
            u = self.compute([params[i]], [grads[i]], st, s)[0]
            for k, v in state.leaves.items():
                if isinstance(v[i], Q8):
                    quantize_into(v[i], st[k][0])
            del st
            yield u


def _ema_(moments, grads, decay: float, s: Step) -> None:
    """moments = (1 - decay) g + decay moments, in place
    (optax.tree.update_moment of order 1)."""
    torch._foreach_mul_(moments, s.r(decay))
    torch._foreach_add_(moments, torch._foreach_mul(grads, s.r(1.0 - decay)))


def _ema_sq_(moments, grads, decay: float, s: Step) -> None:
    """moments = (1 - decay) g^2 + decay moments, in place (order 2)."""
    squares = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(squares, s.r(1.0 - decay))
    torch._foreach_mul_(moments, s.r(decay))
    torch._foreach_add_(moments, squares)


def _zeros(p, dtype):
    return torch.zeros_like(p, dtype=dtype)


class AdamW(LeafLocal):
    """optax.adamw (and optax.adam with the L2 term `l2` added to the
    gradient first, as the reference builds ADAM; with `amsgrad`,
    optax.scale_by_amsgrad): mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2
    nu, u = -lr (mu / c1 / (sqrt(nu / c2) + eps) + wd p), the second moment
    replaced by its running maximum nu_max under amsgrad."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2, l2: float = 0.0,
                 amsgrad: bool = False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.l2, self.amsgrad = l2, amsgrad

    def leaf_state(self, p, dtype):
        out = {"mu": _zeros(p, dtype), "nu": _zeros(p, dtype)}
        if self.amsgrad:
            out["nu_max"] = _zeros(p, dtype)
        return out

    def direction(self, params, grads, st, s):
        mu, nu = st["mu"], st["nu"]
        _ema_(mu, grads, self.b1, s)
        _ema_sq_(nu, grads, self.b2, s)
        update = torch._foreach_div(mu, s.correction(self.b1))
        denom = torch._foreach_div(nu, s.correction(self.b2))
        if self.amsgrad:
            torch._foreach_maximum_(st["nu_max"], denom)
            denom = [t.clone() for t in st["nu_max"]]
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, s.r(self.eps))
        torch._foreach_div_(update, denom)
        return update


class SGD(LeafLocal):
    """optax.sgd: without momentum u = -lr g; with it, the trace t = g + m t
    (optax.trace) and u = -lr t, or -lr (g + m t) with nesterov; `l2` p
    added to the gradient first (schedule-free SGD's weight decay)."""

    def __init__(self, learning_rate, momentum: float | None = None, nesterov: bool = False,
                 l2: float = 0.0):
        super().__init__(learning_rate)
        self.momentum, self.nesterov, self.l2 = momentum, nesterov, l2

    def leaf_state(self, p, dtype):
        return {} if self.momentum is None else {"trace": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        if self.momentum is None:
            return [g.clone() for g in grads]
        return _trace(st["trace"], grads, self.momentum, self.nesterov, s)


def _trace(trace, updates, decay: float, nesterov: bool, s: Step) -> list[torch.Tensor]:
    """optax.trace: t = u + decay t in place; -> t (u + decay t with nesterov)."""
    torch._foreach_mul_(trace, s.r(decay))
    torch._foreach_add_(trace, updates)
    if nesterov:
        out = torch._foreach_mul(trace, s.r(decay))
        torch._foreach_add_(out, updates)
        return out
    return [t.clone() for t in trace]


class Adagrad(LeafLocal):
    """optax.adagrad (optax.scale_by_rss): G = g^2 + G from
    `initial_accumulator_value`, u = -lr_t g / sqrt(G + eps) (0 where G is
    0), with the reference's `lr_decay`: lr_t = lr / (1 + count lr_decay)."""

    def __init__(self, learning_rate, initial_accumulator_value: float = 0.0,
                 eps: float = 1e-10, lr_decay: float = 0.0, l2: float = 0.0):
        super().__init__(learning_rate)
        self.initial, self.eps, self.lr_decay, self.l2 = \
            initial_accumulator_value, eps, lr_decay, l2

    def leaf_state(self, p, dtype):
        return {"sum_of_squares": torch.full_like(p, self.initial, dtype=dtype)}

    def begin(self, params, state):
        s = super().begin(params, state)
        if self.lr_decay:
            s.lr = (_f32(s.lr) / (1.0 + _f32(s.count) * _f32(self.lr_decay))).item()
        return s

    def direction(self, params, grads, st, s):
        return _rss(st["sum_of_squares"], grads, self.eps, s)


def _rss(sums, grads, eps: float, s: Step) -> list[torch.Tensor]:
    """optax.scale_by_rss: G = g^2 + G in place; g / sqrt(G + eps), 0 where
    G is 0."""
    torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
    scaling = torch._foreach_add(sums, s.r(eps))
    torch._foreach_rsqrt_(scaling)
    if eps <= 0:   # G = 0 -> rsqrt = inf; a positive eps leaves g (= 0 there) times a finite
        scaling = [torch.where(t > 0, r, torch.zeros_like(r)) for t, r in zip(sums, scaling)]
    torch._foreach_mul_(scaling, grads)
    return scaling


class RMSProp(LeafLocal):
    """optax.rmsprop: nu = (1-d) g^2 + d nu (and, `centered`, the mean mu),
    u = -lr g / sqrt(nu [- mu^2] + eps), then through optax.trace when
    `momentum` is set; `l2` p added to the gradient first."""

    def __init__(self, learning_rate, decay: float = 0.99, eps: float = 1e-8,
                 momentum: float | None = None, centered: bool = False, l2: float = 0.0):
        super().__init__(learning_rate)
        self.decay, self.eps, self.momentum, self.centered, self.l2 = \
            decay, eps, momentum, centered, l2

    def leaf_state(self, p, dtype):
        out = {"nu": _zeros(p, dtype)}
        if self.centered:
            out["mu"] = _zeros(p, dtype)
        if self.momentum is not None:
            out["trace"] = _zeros(p, dtype)
        return out

    def direction(self, params, grads, st, s):
        _ema_sq_(st["nu"], grads, self.decay, s)
        if self.centered:
            _ema_(st["mu"], grads, self.decay, s)
            scaling = torch._foreach_sub(st["nu"], torch._foreach_mul(st["mu"], st["mu"]))
            torch._foreach_add_(scaling, s.r(self.eps))
        else:
            scaling = torch._foreach_add(st["nu"], s.r(self.eps))
        torch._foreach_rsqrt_(scaling)
        torch._foreach_mul_(scaling, grads)
        return scaling

    def scale(self, params, u, st, s):
        u = super().scale(params, u, st, s)
        if self.momentum is None:
            return u
        return _trace(st["trace"], u, self.momentum, False, s)


class Lion(LeafLocal):
    """optax.lion: u = -lr (sign((1-b1) g + b1 mu) + wd p), then
    mu = (1-b2) g + b2 mu."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay

    def leaf_state(self, p, dtype):
        return {"mu": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        u = torch._foreach_mul(grads, s.r(1.0 - self.b1))
        torch._foreach_add_(u, torch._foreach_mul(st["mu"], s.r(self.b1)))
        torch._foreach_sign_(u)
        _ema_(st["mu"], grads, self.b2, s)
        return u


class Tiger(LeafLocal):
    """The reference's Tiger (onetrainer_tpu/train/optimizers.py:40-61):
    m = b1 m + (1-b1) g, u = -lr (sign(m) + wd p)."""

    def __init__(self, learning_rate, b1: float = 0.965, weight_decay: float = 0.01):
        super().__init__(learning_rate)
        self.b1, self.weight_decay = b1, weight_decay

    def leaf_state(self, p, dtype):
        return {"momentum": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        _ema_(st["momentum"], grads, self.b1, s)
        return torch._foreach_sign(st["momentum"])


class LARS(LeafLocal):
    """optax.lars: g' = g + wd p, u = g' * 0.001 |p| / |g'| per tensor (1
    where a norm is 0), times -lr, through optax.trace(momentum)."""

    def __init__(self, learning_rate, weight_decay: float = 0.0, momentum: float = 0.0,
                 nesterov: bool = False, trust_coefficient: float = 0.001):
        super().__init__(learning_rate)
        self.l2, self.momentum, self.nesterov = weight_decay, momentum, nesterov
        self.trust_coefficient = trust_coefficient

    def leaf_state(self, p, dtype):
        return {"trace": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        return torch._foreach_mul(grads, _trust_ratios(params, grads,
                                                       self.trust_coefficient, 0.0))

    def scale(self, params, u, st, s):
        u = super().scale(params, u, st, s)
        return _trace(st["trace"], u, self.momentum, self.nesterov, s)


class LAMB(AdamW):
    """optax.lamb: Adam's direction plus wd p, times |p| / |u| per tensor
    (1 where a norm is 0), times -lr."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        super().__init__(learning_rate, b1, b2, eps, weight_decay)

    def scale(self, params, u, st, s):
        u = torch._foreach_mul(u, _trust_ratios(params, u, 1.0, 0.0))
        return super().scale(params, u, st, s)


class AdEMAMix(LeafLocal):
    """optax.contrib.ademamix: m1 = (1-b1) g + b1 m1, m2 = (1-b3) g + b3 m2,
    nu = (1-b2) g^2 + b2 nu, u = -lr ((m1 / c1 + alpha m2) / (sqrt(nu / c2)
    + eps) + wd p); the slow average m2 takes no bias correction."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, b3=0.9999, alpha=5.0, eps=1e-8,
                 weight_decay=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.b3, self.alpha, self.eps = b1, b2, b3, alpha, eps
        self.weight_decay = weight_decay

    def leaf_state(self, p, dtype):
        return {"m1": _zeros(p, dtype), "m2": _zeros(p, dtype), "nu": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        _ema_(st["m1"], grads, self.b1, s)
        _ema_(st["m2"], grads, self.b3, s)
        _ema_sq_(st["nu"], grads, self.b2, s)
        u = torch._foreach_div(st["m1"], s.correction(self.b1))
        torch._foreach_add_(u, torch._foreach_mul(st["m2"], s.r(self.alpha)))
        denom = torch._foreach_div(st["nu"], s.correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, s.r(self.eps))
        torch._foreach_div_(u, denom)
        return u


class ADOPT(LeafLocal):
    """optax.contrib.adopt: at count 0 only nu = g^2 (no update); after,
    mu = (1-b1) clip(g / max(sqrt(nu), eps), +-count^0.25) + b1 mu with the
    previous nu, nu = (1-b2) g^2 + b2 nu, u = -lr mu; `l2` p added to the
    gradient first."""

    def __init__(self, learning_rate, b1=0.9, b2=0.9999, eps=1e-6, l2=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.l2 = b1, b2, eps, l2

    def leaf_state(self, p, dtype):
        return {"mu": _zeros(p, dtype), "nu": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        first = s.count == 0
        # jnp.where(count > 0, b, 0 or 1) is an fp32 array: 1 - it is fp32 math
        b1 = 1.0 if first else s.r(self.b1)
        b2 = 0.0 if first else s.r(self.b2)
        clip = (_f32(s.count) ** _f32(0.25)).item()
        denom = torch._foreach_sqrt(st["nu"])
        torch._foreach_clamp_min_(denom, s.r(self.eps))
        mu_updates = torch._foreach_div(grads, denom)
        del denom
        torch._foreach_clamp_min_(mu_updates, -clip)
        torch._foreach_clamp_max_(mu_updates, clip)
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squares, s.r(_f32(1.0) - _f32(b2)))
        torch._foreach_mul_(st["nu"], b2)
        torch._foreach_add_(st["nu"], squares)
        del squares
        torch._foreach_mul_(mu_updates, s.r(_f32(1.0) - _f32(b1)))
        torch._foreach_mul_(st["mu"], b1)
        torch._foreach_add_(st["mu"], mu_updates)
        return [m.clone() for m in st["mu"]]


class AdaBelief(LeafLocal):
    """optax.adabelief: mu = (1-b1) g + b1 mu, s = (1-b2) (g - mu)^2 + b2 s
    + eps_root, u = -lr mu / c1 / (sqrt(s / c2) + eps); `l2` p added to the
    gradient first."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16, l2=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root, self.l2 = b1, b2, eps, eps_root, l2

    def leaf_state(self, p, dtype):
        return {"mu": _zeros(p, dtype), "nu": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        _ema_(st["mu"], grads, self.b1, s)
        _ema_sq_(st["nu"], torch._foreach_sub(grads, st["mu"]), self.b2, s)
        torch._foreach_add_(st["nu"], s.r(self.eps_root))
        u = torch._foreach_div(st["mu"], s.correction(self.b1))
        denom = torch._foreach_div(st["nu"], s.correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, s.r(self.eps))
        torch._foreach_div_(u, denom)
        return u


class Yogi(LeafLocal):
    """optax.yogi: mu and nu from 1e-6, mu = (1-b1) g + b1 mu,
    nu = nu - (1-b2) sign(nu - g^2) g^2, u = -lr mu / c1 / (sqrt(nu / c2) +
    eps); `l2` p added to the gradient first."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-3, l2=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.l2 = b1, b2, eps, l2

    def leaf_state(self, p, dtype):
        return {"mu": torch.full_like(p, 1e-6, dtype=dtype),
                "nu": torch.full_like(p, 1e-6, dtype=dtype)}

    def direction(self, params, grads, st, s):
        _ema_(st["mu"], grads, self.b1, s)
        squares = torch._foreach_mul(grads, grads)
        step = torch._foreach_sub(st["nu"], squares)
        torch._foreach_sign_(step)
        torch._foreach_mul_(step, s.r(1.0 - self.b2))
        torch._foreach_mul_(step, squares)
        del squares
        torch._foreach_sub_(st["nu"], step)
        del step
        u = torch._foreach_div(st["mu"], s.correction(self.b1))
        denom = torch._foreach_div(st["nu"], s.correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, s.r(self.eps))
        torch._foreach_div_(u, denom)
        return u


def came_factored_axes(shape) -> tuple[int, int] | None:
    """(row axis, column axis) of a tensor's factored CAME moments, None for
    1-D. The reference factors the last two axes of its flax layout ([...,
    in, out]); the port's tensors are in torch layout ([out, in, ...]), where
    those are axes 1 and 0."""
    return None if len(shape) < 2 else (1, 0)


class CAME(LeafLocal):
    """The reference's CAME (onetrainer_tpu/train/optimizers.py:69-173;
    arXiv:2307.02047): per tensor, the factored (`came_factored_axes`) or
    full second moment of g^2 + eps1 with decay b2, u = g / sqrt(v) clipped
    to an RMS of at most `clip_threshold`, m = (1-b1) u + b1 m, the
    factored confidence r of (u - m)^2 + eps2 with decay b3, update
    -lr (m / max(sqrt(r), 1e-30) + wd p). One tensor at a time: each
    reduces over its own axes."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, b3=0.9999, eps1=1e-30, eps2=1e-16,
                 clip_threshold=1.0, weight_decay=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.b3, self.eps1, self.eps2 = b1, b2, b3, eps1, eps2
        self.clip_threshold, self.weight_decay = clip_threshold, weight_decay

    def leaf_state(self, p, dtype):
        out = {"m": _zeros(p, dtype)}
        axes = came_factored_axes(p.shape)
        for name in ("v", "r"):
            if axes is None:
                out[name], out[f"{name}_row"], out[f"{name}_col"] = _zeros(p, dtype), None, None
            else:
                row, col = axes
                shape = list(p.shape)
                out[name] = None
                out[f"{name}_row"] = p.new_zeros(shape[:col] + shape[col + 1:], dtype=dtype)
                out[f"{name}_col"] = p.new_zeros(shape[:row] + shape[row + 1:], dtype=dtype)
        return out

    def _moment(self, st, name: str, i: int, sq, decay: float, s: Step):
        """The decayed moment of `sq` in place; -> its full-shape estimate."""
        axes = came_factored_axes(sq.shape)
        if axes is None:
            v = st[name][i].mul_(s.r(decay)).add_(sq * s.r(1.0 - decay))
            return v
        r_axis, c_axis = axes
        row = st[f"{name}_row"][i].mul_(s.r(decay)).add_(sq.mean(c_axis) * s.r(1.0 - decay))
        col = st[f"{name}_col"][i].mul_(s.r(decay)).add_(sq.mean(r_axis) * s.r(1.0 - decay))
        reduced_r = r_axis - 1 if c_axis < r_axis else r_axis
        row_n = row / torch.clamp(row.mean(reduced_r, keepdim=True), min=s.r(1e-30))
        return row_n.unsqueeze(c_axis) * col.unsqueeze(r_axis)

    def direction(self, params, grads, st, s):
        out = []
        for i, g in enumerate(grads):
            v = self._moment(st, "v", i, g * g + s.r(self.eps1), self.b2, s)
            u = g / v.sqrt()
            del v
            rms = u.square().mean().sqrt()
            u = u / torch.clamp(rms / s.r(self.clip_threshold), min=1.0)
            m = st["m"][i].mul_(s.r(self.b1)).add_(u * s.r(1.0 - self.b1))
            conf = (u - m).square_().add_(s.r(self.eps2))
            del u
            r = self._moment(st, "r", i, conf, self.b3, s)
            out.append(m / torch.clamp(r.sqrt(), min=s.r(1e-30)))
        return out


class Aida(LeafLocal):
    """The reference's Aida (train/dadapt.py: scale_by_aida): fp32 moments,
    m = b1 m + (1-b1) g, the gradient projected `k` times onto m (per
    tensor), v = b2 v + (1-b2) proj^2, u = -lr ((m / c1) / (sqrt(v / c2) +
    eps) + wd p)."""

    state_dtype = torch.float32

    def __init__(self, learning_rate, b1=0.9, b2=0.999, k=2, xi=1e-20, eps=1e-8,
                 weight_decay=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.k, self.xi, self.eps = b1, b2, k, xi, eps
        self.weight_decay = weight_decay

    def leaf_state(self, p, dtype):
        return {"m": _zeros(p, torch.float32), "v": _zeros(p, torch.float32)}

    def direction(self, params, grads, st, s):
        grads = [g.float() for g in grads]
        _ema_(st["m"], grads, self.b1, s)
        projected = []
        for m, g in zip(st["m"], grads):
            proj = g
            mm = torch.dot(m.reshape(-1), m.reshape(-1)) + self.xi
            for _ in range(self.k):
                proj = m * (torch.dot(m.reshape(-1), proj.reshape(-1)) / mm)
            projected.append(proj)
        squares = torch._foreach_mul(projected, s.r(1.0 - self.b2))
        torch._foreach_mul_(squares, projected)
        del projected
        torch._foreach_mul_(st["v"], s.r(self.b2))
        torch._foreach_add_(st["v"], squares)
        del squares
        u = torch._foreach_div(st["m"], s.correction(self.b1))
        denom = torch._foreach_div(st["v"], s.correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, s.r(self.eps))
        torch._foreach_div_(u, denom)
        return u

    def compute(self, params, grads, st, s):
        return super().compute([p.float() for p in params], grads, st, s)


class RMSBiasCorrected(LeafLocal):
    """Schedule-free AdamW's base (optax.contrib.schedule_free_adamw):
    optax.scale_by_rms(eps_in_sqrt=False, bias_correction=True), nu =
    (1-d) g^2 + d nu, u = -lr (g / (sqrt(nu / c) + eps) + wd p), the
    reciprocal taken first as optax does."""

    def __init__(self, learning_rate, decay=0.999, eps=1e-8, weight_decay=0.0):
        super().__init__(learning_rate)
        self.decay, self.eps, self.weight_decay = decay, eps, weight_decay

    def leaf_state(self, p, dtype):
        return {"nu": _zeros(p, dtype)}

    def direction(self, params, grads, st, s):
        _ema_sq_(st["nu"], grads, self.decay, s)
        scaling = torch._foreach_div(st["nu"], s.correction(self.decay))
        torch._foreach_sqrt_(scaling)
        torch._foreach_add_(scaling, s.r(self.eps))
        torch._foreach_reciprocal_(scaling)
        torch._foreach_mul_(scaling, grads)
        return scaling


# optax.adafactor's default, which the reference keeps
_MIN_DIM_SIZE_TO_FACTOR = 128


def factored_dims(shape) -> tuple[int, int] | None:
    """(d1, d0), the two largest axes of `shape` (ties in axis order), when
    the smaller of them has at least `_MIN_DIM_SIZE_TO_FACTOR` elements, else
    None: optax's `_factored_dims` with factored=True. A torch layout
    ([out, in, kh, kw]) picks the same two sizes as the reference's
    ([kh, kw, in, out]); the factored estimate is symmetric in them."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < _MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


@dataclass
class AdafactorState:
    count: int = 0
    v_row: list = field(default_factory=list)   # factored leaves; else [1] zeros
    v_col: list = field(default_factory=list)
    v: list = field(default_factory=list)       # unfactored leaves; else [1] zeros
    momentum: list | None = None                # fp32, when momentum is on

    def tensors(self) -> dict[str, torch.Tensor]:
        names = ("v_row", "v_col", "v") + (("momentum",) if self.momentum is not None else ())
        return {f"{name}/{i}": t for name in names for i, t in enumerate(getattr(self, name))}


class Adafactor:
    """optax.adafactor (Shazeer and Stern, 2018) over a list of tensors, as
    the reference builds it (onetrainer_tpu/train/optimizers.py:306-318):
    per leaf, the factored (two largest axes, both >= 128) or full second
    moment of g^2 + eps with decay 1 - (t+1)^-decay_rate, the update g /
    sqrt(v) clipped to an RMS of at most `clipping_threshold`, times the
    learning rate, times the parameter's RMS (at least 1e-3) when
    `multiply_by_parameter_scale`, through an fp32 momentum average
    (no bias correction) when `momentum` is set, plus `weight_decay_rate`
    p, negated.

    The second moments are held and the update computed in fp32 whatever
    the parameters' dtype; the update is returned in the parameters' dtype,
    or in fp32 with momentum on, the dtypes optax's chain gives it. For
    fp32 parameters this is optax's arithmetic; for bf16 ones optax
    computes every step in bf16 (ROADMAP queue 3, F8)."""

    def __init__(self, learning_rate, decay_rate: float = 0.8,
                 clipping_threshold: float | None = 1.0, momentum: float | None = None,
                 weight_decay_rate: float | None = None, eps: float = 1e-30,
                 multiply_by_parameter_scale: bool = True):
        self.schedule = learning_rate if callable(learning_rate) \
            else (lambda step, lr=learning_rate: lr)
        self.decay_rate, self.clipping_threshold = decay_rate, clipping_threshold
        self.momentum, self.weight_decay_rate, self.eps = momentum, weight_decay_rate, eps
        self.multiply_by_parameter_scale = multiply_by_parameter_scale

    def init(self, params: list[torch.Tensor]) -> AdafactorState:
        state = AdafactorState(momentum=[] if self.momentum is not None else None)
        for p in params:
            zeros = torch.zeros(1, dtype=torch.float32, device=p.device)
            dims = factored_dims(tuple(p.shape))
            if dims is None:
                state.v_row.append(zeros)
                state.v_col.append(zeros.clone())
                state.v.append(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                state.v_row.append(torch.zeros(shape[:d0] + shape[d0 + 1:],
                                               dtype=torch.float32, device=p.device))
                state.v_col.append(torch.zeros(shape[:d1] + shape[d1 + 1:],
                                               dtype=torch.float32, device=p.device))
                state.v.append(zeros)
            if state.momentum is not None:
                state.momentum.append(torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device))
        return state

    def updates(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdafactorState) -> list[torch.Tensor]:
        """One step's updates (to add to `params`), advancing `state`."""
        return list(self.leaf_updates(params, grads, state))

    @torch.no_grad()
    def leaf_updates(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                     state: AdafactorState):
        """One step's updates leaf by leaf, each made when the caller asks
        for it (the step applies them in chunks, freeing each leaf's
        gradient and update as it goes); `state` advances at the first."""
        t = _f32(state.count + 1)
        decay = 1.0 - t ** _f32(-self.decay_rate)
        d, one_minus_d = decay.item(), (1.0 - decay).item()
        lr = _f32(self.schedule(state.count)).item()
        state.count += 1
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            grad_sqr = g * g + self.eps
            dims = factored_dims(tuple(p.shape))
            if dims is not None:
                d1, d0 = dims
                v_row = state.v_row[i].mul_(d).add_(grad_sqr.mean(d0) * one_minus_d)
                v_col = state.v_col[i].mul_(d).add_(grad_sqr.mean(d1) * one_minus_d)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt_()
                u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            else:
                v = state.v[i].mul_(d).add_(grad_sqr * one_minus_d)
                u = g * v.rsqrt()
            del grad_sqr
            if self.clipping_threshold is not None:
                rms = u.square().mean().sqrt()
                u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            u = u * lr
            if self.multiply_by_parameter_scale:
                p_rms = p.float().square().mean().sqrt()
                u = u * torch.where(p_rms <= 1e-3, torch.full_like(p_rms, 1e-3), p_rms)
            if self.momentum is not None:
                u = state.momentum[i].mul_(self.momentum).add_(u * (1.0 - self.momentum))
            elif p.dtype != torch.float32:
                u = u.to(arithmetic_dtype(p.dtype))
            if self.weight_decay_rate is not None:
                u = u + p.to(arithmetic_dtype(p.dtype)) * self.weight_decay_rate
            yield -u


class _GroupWide:
    """Base of the optimizers that reduce over the whole group before any
    tensor's update: every update is made when the first is asked for."""

    def __init__(self, learning_rate):
        self.schedule = _as_schedule(learning_rate)

    def updates(self, params, grads, state: OptState) -> list[torch.Tensor]:
        """One step's updates (to add to `params`), advancing `state`."""
        if not params:
            return []
        _check_one_dtype(params)
        with torch.no_grad():
            return self._updates(params, grads, state)

    def leaf_updates(self, params, grads, state: OptState):
        yield from self.updates(params, grads, state)


def _scalar(value: float, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device).to(dtype)


def _bias_factor(b1: float, b2: float, t: int) -> float:
    """sqrt(1 - b2^t) / (1 - b1^t) in fp32, as optax's D-Adapt and Prodigy."""
    return ((1.0 - _f32(b2) ** _f32(t)) ** _f32(0.5) / (1.0 - _f32(b1) ** _f32(t))).item()


class DAdaptAdamW(_GroupWide):
    """optax.contrib.dadapt_adamw: AdamW whose step size d (`estim_lr`, from
    `estim_lr0`) is estimated from a weighted sum of past gradients.
    dlr = d lr(count) sqrt(1 - b2^t) / (1 - b1^t); the numerator
    accumulates dlr <g, s / (sqrt(v) + eps)>, s = sqrt(b2) s + (1 -
    sqrt(b2)) dlr g, d = max(d, numerator / ((1 - sqrt(b2)) |s|_1)) for the
    next step; u = -(m / (sqrt(v) + eps) + wd dlr p) with m's EMA of dlr g.
    d and the numerator are 0-dim tensors in the parameters' dtype."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, estim_lr0=1e-6,
                 weight_decay=0.0, l2=0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.estim_lr0 = b1, b2, eps, estim_lr0
        self.weight_decay, self.l2 = weight_decay, l2

    def init(self, params):
        dtype = _compute_dtype(params[0].dtype) if params else torch.float32
        like = params[0] if params else torch.zeros(())
        zeros = lambda: [torch.zeros_like(p, dtype=dtype) for p in params]   # noqa: E731
        return OptState({"exp_avg": zeros(), "exp_avg_sq": zeros(), "grad_sum": zeros()},
                        {"estim_lr": _scalar(self.estim_lr0, like, dtype),
                         "numerator_weighted": _scalar(0.0, like, dtype)})

    def _updates(self, params, grads, state):
        dtype = state.estim_lr.dtype
        s = Step(dtype, state.count, float(self.schedule(state.count)))
        state.count += 1
        if dtype != params[0].dtype:
            params, grads = [p.to(dtype) for p in params], [g.to(dtype) for g in grads]
        if self.l2:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, s.r(self.l2)))
        sb2 = self.b2 ** 0.5
        dlr = (state.estim_lr.float() * _f32(s.lr).item()
               * _bias_factor(self.b1, self.b2, s.t)).to(dtype)
        ea, eas, gs = state.exp_avg, state.exp_avg_sq, state.grad_sum
        weighted = torch._foreach_sqrt(eas)
        torch._foreach_add_(weighted, s.r(self.eps))
        weighted = torch._foreach_div(gs, weighted)
        numerator_acum = _sum_products(grads, weighted).to(dtype)
        del weighted
        torch._foreach_mul_(ea, s.r(self.b1))
        torch._foreach_add_(ea, torch._foreach_mul(grads, s.r(1.0 - self.b1) * dlr))
        squares = torch._foreach_mul(grads, s.r(1.0 - self.b2))
        torch._foreach_mul_(squares, grads)
        torch._foreach_mul_(eas, s.r(self.b2))
        torch._foreach_add_(eas, squares)
        del squares
        torch._foreach_mul_(gs, s.r(sb2))
        torch._foreach_add_(gs, torch._foreach_mul(grads, s.r(1.0 - sb2) * dlr))
        grad_sum_l1 = _sum_abs(gs).to(dtype)
        nw = state.numerator_weighted
        nw.copy_(s.r(sb2) * nw + s.r(1.0 - sb2) * dlr * numerator_acum)
        d_estimate = nw / (s.r(1.0 - sb2) * grad_sum_l1)
        state.estim_lr.copy_(torch.maximum(state.estim_lr, d_estimate))
        denom = torch._foreach_sqrt(eas)
        torch._foreach_add_(denom, s.r(self.eps))
        u = torch._foreach_div(ea, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params, s.r(self.weight_decay) * dlr))
        torch._foreach_neg_(u)
        return u


class Prodigy(_GroupWide):
    """optax.contrib.prodigy: D-Adapt AdamW that weights recent gradients
    more. dlr = d lr(count) sqrt(1 - b2^t) / (1 - b1^t); with dg = d g,
    m = b1 m + (1-b1) dg, v = b2 v + (1-b2) dg^2, s = b3 s + dlr dg / d0
    (d dg / d0 under `safeguard_warmup`), the numerator = b3 numerator +
    (d / d0) dlr <g, p0 - p>, d = max(d, d_coef numerator / |s|_1), then
    u = -wd dlr p - dlr m / (sqrt(v) + d eps) with the new d. d and the
    numerator are 0-dim tensors in the parameters' dtype; p0 is a copy of
    the parameters at init."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, beta3=None, eps=1e-8, estim_lr0=1e-6,
                 estim_lr_coef=1.0, weight_decay=0.0, safeguard_warmup=False):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps, self.estim_lr0 = b1, b2, eps, estim_lr0
        self.b3 = b2 ** 0.5 if beta3 is None else beta3
        self.estim_lr_coef, self.weight_decay = estim_lr_coef, weight_decay
        self.safeguard_warmup = safeguard_warmup

    def init(self, params):
        dtype = _compute_dtype(params[0].dtype) if params else torch.float32
        like = params[0] if params else torch.zeros(())
        zeros = lambda: [torch.zeros_like(p, dtype=dtype) for p in params]   # noqa: E731
        return OptState({"exp_avg": zeros(), "exp_avg_sq": zeros(), "grad_sum": zeros(),
                         "params0": [p.detach().to(dtype, copy=True) for p in params]},
                        {"estim_lr": _scalar(self.estim_lr0, like, dtype),
                         "numerator_weighted": _scalar(0.0, like, dtype)})

    def _updates(self, params, grads, state):
        dtype = state.estim_lr.dtype
        s = Step(dtype, state.count, float(self.schedule(state.count)))
        state.count += 1
        if dtype != params[0].dtype:
            params, grads = [p.to(dtype) for p in params], [g.to(dtype) for g in grads]
        d = state.estim_lr.clone()
        dlr = (d.float() * _f32(s.lr).item() * _bias_factor(self.b1, self.b2, s.t)).to(dtype)
        dg = torch._foreach_mul(grads, d)
        diff = torch._foreach_sub(state.params0, params)
        numerator_acum = _sum_products(grads, diff).to(dtype)
        del diff
        ea, eas, gs = state.exp_avg, state.exp_avg_sq, state.grad_sum
        torch._foreach_mul_(ea, s.r(self.b1))
        torch._foreach_add_(ea, torch._foreach_mul(dg, s.r(1.0 - self.b1)))
        squares = torch._foreach_mul(dg, s.r(1.0 - self.b2))
        torch._foreach_mul_(squares, dg)
        torch._foreach_mul_(eas, s.r(self.b2))
        torch._foreach_add_(eas, squares)
        del squares
        torch._foreach_mul_(dg, d if self.safeguard_warmup else dlr)
        torch._foreach_div_(dg, s.r(self.estim_lr0))
        torch._foreach_mul_(gs, s.r(self.b3))
        torch._foreach_add_(gs, dg)
        del dg
        nw = state.numerator_weighted
        nw.copy_(s.r(self.b3) * nw + d / s.r(self.estim_lr0) * dlr * numerator_acum)
        denominator = _sum_abs(gs).to(dtype)
        lr_estimate = s.r(self.estim_lr_coef) * nw / denominator
        state.estim_lr.copy_(torch.maximum(d, lr_estimate))
        denom = torch._foreach_sqrt(eas)
        torch._foreach_add_(denom, state.estim_lr * s.r(self.eps))
        u = torch._foreach_mul(ea, dlr)
        torch._foreach_div_(u, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params, s.r(self.weight_decay) * dlr))
        torch._foreach_neg_(u)
        return u


class ScheduleFree(_GroupWide):
    """optax.contrib.schedule_free around `base` (which makes the step of
    the z sequence): the state keeps z (from the parameters) and the
    averaging weight's sum; with lr_max the largest learning rate read so
    far (at count + 1), c = lr_max^power / (sum + lr_max^power),
    z += base's update, x = (1 - c) x_prev + c z with x_prev = (y - (1 -
    b1) z_prev) / b1, and the parameters move to y = b1 x + (1 - b1) z.
    `eval_params` gives x."""

    def __init__(self, base, learning_rate, b1: float = 0.9, weight_lr_power: float = 2.0):
        super().__init__(learning_rate)
        self.base, self.b1, self.weight_lr_power = base, b1, weight_lr_power

    def init(self, params):
        dtype = _compute_dtype(params[0].dtype) if params else torch.float32
        like = params[0] if params else torch.zeros(())
        state = OptState({"z": [p.detach().to(dtype, copy=True) for p in params]},
                         {"weight_sum": _scalar(0.0, like, dtype),
                          "max_lr": _scalar(0.0, like, dtype)},
                         inner=self.base.init(params))
        state.b1 = self.b1
        return state

    def _updates(self, params, grads, state):
        dtype = state.max_lr.dtype
        lr = _scalar(float(self.schedule(state.count + 1)), state.max_lr, torch.float32).to(dtype)
        torch.maximum(state.max_lr, lr, out=state.max_lr)
        weight = state.max_lr ** self.weight_lr_power
        total = state.weight_sum + weight
        ck = torch.nan_to_num(weight / total, nan=0.0, posinf=math.inf)
        ck = torch.where(weight.isnan() | total.isnan(), torch.full_like(ck, math.nan), ck)
        state.weight_sum.copy_(total)
        base_updates = self.base.updates(params, grads, state.inner)
        state.count += 1
        y = params if dtype == params[0].dtype else [p.to(dtype) for p in params]
        z = state.z
        b1 = self.b1
        x = torch._foreach_mul(z, s_r(dtype, 1.0 - b1))
        torch._foreach_sub_(x, y)
        torch._foreach_neg_(x)
        torch._foreach_div_(x, s_r(dtype, b1))
        torch._foreach_add_(z, [u.to(dtype) for u in base_updates])
        del base_updates
        torch._foreach_mul_(x, 1.0 - ck)
        torch._foreach_add_(x, torch._foreach_mul(z, ck))
        torch._foreach_mul_(x, s_r(dtype, b1))
        torch._foreach_add_(x, torch._foreach_mul(z, s_r(dtype, 1.0 - b1)))
        torch._foreach_sub_(x, y)
        return x


def s_r(dtype: torch.dtype, x) -> float:
    """A python constant rounded to `dtype` (a weakly typed jnp scalar)."""
    return torch.as_tensor(x, dtype=torch.float32).to(dtype).item()


@torch.no_grad()
def eval_params(state: OptState, params: list[torch.Tensor]) -> list[torch.Tensor]:
    """A schedule-free group's x, (y - (1 - b1) z) / b1, from its state and
    its parameters y (optax.contrib.schedule_free_eval_params, which takes
    b1 from the state: 1 - b1 in the state's dtype)."""
    dtype = state.max_lr.dtype
    b1 = s_r(dtype, state.b1)
    x = torch._foreach_mul(state.z, s_r(dtype, s_r(dtype, 1.0) - b1))
    torch._foreach_sub_(x, [p.to(dtype) for p in params])
    torch._foreach_neg_(x)
    torch._foreach_div_(x, b1)
    return [t.to(p.dtype) for t, p in zip(x, params)]


def create_optimizer(optimizer: Optimizer, cfg, learning_rate):
    """The optimizer of one param group (`cfg` is TrainOptimizerConfig),
    built as the reference's `_create_base_optimizer` builds it, with its
    defaults; an `_8BIT` variant is its base optimizer with int8 state."""
    tx = _create_base_optimizer(optimizer, cfg, learning_rate)
    if optimizer.value.endswith("_8BIT"):
        tx.int8 = True
    return tx


def _create_base_optimizer(optimizer: Optimizer, cfg, lr):
    from onetrainer_tpu_torch.train import dadapt
    wd = _d(cfg.weight_decay, 0.0)
    O = Optimizer   # noqa: N806
    match optimizer:
        case O.ADAMW | O.ADAMW_8BIT:
            return AdamW(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                         eps=_d(cfg.eps, 1e-8), weight_decay=_d(cfg.weight_decay, 1e-2),
                         amsgrad=cfg.amsgrad)
        case O.ADAM | O.ADAM_8BIT:
            # torch's Adam adds its L2 term to the gradient
            return AdamW(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                         eps=_d(cfg.eps, 1e-8), weight_decay=0.0, l2=wd, amsgrad=cfg.amsgrad)
        case O.SGD | O.SGD_8BIT:
            return SGD(lr, momentum=_d(cfg.momentum, 0.0) or None, nesterov=cfg.nesterov)
        case O.ADAGRAD | O.ADAGRAD_8BIT:
            return Adagrad(lr, initial_accumulator_value=float(
                _d(cfg.initial_accumulator_value, 0)), eps=_d(cfg.eps, 1e-10),
                lr_decay=_d(cfg.lr_decay, 0.0), l2=wd)
        case O.RMSPROP | O.RMSPROP_8BIT:
            return RMSProp(lr, decay=_d(cfg.alpha, 0.99), eps=_d(cfg.eps, 1e-8),
                           momentum=_d(cfg.momentum, 0.0) or None, centered=cfg.centered,
                           l2=wd)
        case O.LION | O.LION_8BIT:
            return Lion(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.99),
                        weight_decay=_d(cfg.weight_decay, 0.0))
        case O.LARS | O.LARS_8BIT:
            return LARS(lr, weight_decay=wd, momentum=_d(cfg.momentum, 0.0),
                        nesterov=cfg.nesterov)
        case O.LAMB | O.LAMB_8BIT:
            return LAMB(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                        eps=_d(cfg.eps, 1e-8), weight_decay=wd)
        case O.ADEMAMIX | O.ADEMAMIX_8BIT:
            return AdEMAMix(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                            b3=_d(cfg.beta3, 0.9999), alpha=_d(cfg.alpha, 5.0),
                            eps=_d(cfg.eps, 1e-8), weight_decay=_d(cfg.weight_decay, 0.0))
        case O.ADOPT:
            return ADOPT(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.9999),
                         eps=_d(cfg.eps, 1e-6), l2=wd)
        case O.ADABELIEF:
            return AdaBelief(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                             eps=_d(cfg.eps, 1e-16), eps_root=_d(cfg.eps2, 1e-16), l2=wd)
        case O.YOGI:
            return Yogi(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                        eps=_d(cfg.eps, 1e-3), l2=wd)
        case O.TIGER:
            return Tiger(lr, b1=_d(cfg.beta1, 0.965), weight_decay=_d(cfg.weight_decay, 0.01))
        case O.ADAFACTOR:
            # the reference's torch convention is a negative decay_rate
            # (-0.8); optax takes its magnitude
            return Adafactor(
                lr, decay_rate=abs(_d(cfg.decay_rate, -0.8)),
                clipping_threshold=_d(cfg.clip_threshold, 1.0), momentum=cfg.beta1,
                weight_decay_rate=_d(cfg.weight_decay, 0.0) or None, eps=_d(cfg.eps, 1e-30),
                multiply_by_parameter_scale=bool(cfg.scale_parameter))
        case O.CAME:
            return CAME(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                        b3=_d(cfg.beta3, 0.9999), eps1=_d(cfg.eps, 1e-30),
                        eps2=_d(cfg.eps2, 1e-16), clip_threshold=_d(cfg.clip_threshold, 1.0),
                        weight_decay=_d(cfg.weight_decay, 1e-2))
        case O.SCHEDULE_FREE_ADAMW:
            return ScheduleFree(
                RMSBiasCorrected(lr, decay=_d(cfg.beta2, 0.999), eps=_d(cfg.eps, 1e-8),
                                 weight_decay=_d(cfg.weight_decay, 0.01)),
                lr, b1=_d(cfg.beta1, 0.9), weight_lr_power=_d(cfg.weight_lr_power, 2.0))
        case O.SCHEDULE_FREE_SGD:
            # the reference's SGDScheduleFree takes `momentum`, not beta1
            momentum = _d(cfg.momentum, 0.9)
            if momentum == 0.0:
                raise ValueError(
                    "SCHEDULE_FREE_SGD needs momentum > 0: the schedule-free eval "
                    "params divide by it (default: 0.9)")
            return ScheduleFree(SGD(lr, l2=_d(cfg.weight_decay, 0.01)), lr, b1=momentum,
                                weight_lr_power=_d(cfg.weight_lr_power, 2.0))
        case O.DADAPT_ADAM:
            # decouple=False (the reference's default) is dadaptation's
            # L2-into-gradient mode
            return DAdaptAdamW(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                               eps=_d(cfg.eps, 1e-8), weight_decay=wd if cfg.decouple else 0.0,
                               l2=0.0 if cfg.decouple else wd)
        case O.DADAPT_SGD:
            return dadapt.dadapt_sgd(lr, momentum=_d(cfg.momentum, 0.0), d0=_d(cfg.d0, 1e-6),
                                     weight_decay=_d(cfg.weight_decay, 0.0),
                                     growth_rate=_d(cfg.growth_rate, float("inf")))
        case O.DADAPT_LION:
            return dadapt.dadapt_lion(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                                      d0=_d(cfg.d0, 1e-6), weight_decay=_d(cfg.weight_decay, 0.0))
        case O.DADAPT_ADA_GRAD:
            return dadapt.dadapt_adagrad(lr, eps=_d(cfg.eps, 0.0), d0=_d(cfg.d0, 1e-6),
                                         weight_decay=_d(cfg.weight_decay, 0.0))
        case O.DADAPT_ADAN:
            return dadapt.dadapt_adan(lr, b1=_d(cfg.beta1, 0.98), b2=_d(cfg.beta2, 0.92),
                                      b3=_d(cfg.beta3, 0.99), eps=_d(cfg.eps, 1e-8),
                                      d0=_d(cfg.d0, 1e-6),
                                      weight_decay=_d(cfg.weight_decay, 0.02))
        case O.AIDA:
            return Aida(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999), k=_d(cfg.k, 2),
                        xi=_d(cfg.xi, 1e-20), eps=_d(cfg.eps, 1e-8),
                        weight_decay=_d(cfg.weight_decay, 0.0))
        case O.PRODIGY:
            return Prodigy(lr, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999), beta3=cfg.beta3,
                           eps=_d(cfg.eps, 1e-8), estim_lr0=_d(cfg.d0, 1e-6),
                           estim_lr_coef=_d(cfg.d_coef, 1.0),
                           weight_decay=_d(cfg.weight_decay, 0.0),
                           safeguard_warmup=cfg.safeguard_warmup)
        case O.PRODIGY_PLUS_SCHEDULE_FREE:
            # Prodigy's step sizes without its momentum (b1 = 0), inside
            # schedule-free's averaging at beta1
            inner = Prodigy(lr, b1=0.0, b2=_d(cfg.beta2, 0.99), beta3=cfg.beta3,
                            eps=_d(cfg.eps, 1e-8), estim_lr0=_d(cfg.d0, 1e-6),
                            estim_lr_coef=_d(cfg.d_coef, 1.0),
                            weight_decay=_d(cfg.weight_decay, 0.0),
                            safeguard_warmup=cfg.safeguard_warmup)
            return ScheduleFree(inner, lr, b1=_d(cfg.beta1, 0.9),
                                weight_lr_power=_d(cfg.weight_lr_power, 2.0))
    raise NotImplementedError(f"optimizer {optimizer} is not ported")


# elements of the bf16 squares global_norm holds at once: each tensor's sum
# is its own, so the chunks give what one list would without a second
# copy of every gradient (22 GiB for FLUX's transformer)
SQUARES_CHUNK_ELEMENTS = 1 << 30


def chunk_lengths(sizes: list[int], max_elements: int) -> list[int]:
    """The lengths of the consecutive runs of `sizes` that hold at most
    `max_elements` elements each (a larger size alone)."""
    out, total = [], 0
    for n in sizes:
        if not out or total + n > max_elements:
            out.append(0)
            total = 0
        out[-1] += 1
        total += n
    return out


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element (optax.global_norm): fp32 on
    the tensors' device when any tensor is fp32; else, as optax over bf16
    leaves, in bf16: each tensor's sum of bf16 squares rounded to bf16, the
    sums added one by one in bf16, and the square root of the total. The
    one-by-one additions run on the host (one copy of the per-tensor sums,
    which waits for them) rather than as one launch each on the card; the
    squares are made in chunks of `SQUARES_CHUNK_ELEMENTS`."""
    if any(t.dtype == torch.float32 for t in tensors) or not tensors:
        norms = torch._foreach_norm([t.float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    sums, first = [], 0
    for n in chunk_lengths([t.numel() for t in tensors], SQUARES_CHUNK_ELEMENTS):
        chunk = tensors[first:first + n]
        sums += torch._foreach_norm(torch._foreach_mul(chunk, chunk), 1)
        first += n
    sums = torch.stack(sums).cpu()
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: g / |g| * c where |g| >= c.
    A bf16 norm (bf16 gradients, on the host) divides and then multiplies
    by c in bf16, as optax."""
    if norm.dtype == torch.float32:
        # (g / |g|) c in optax's order, 1 and 1 where nothing is clipped
        below = norm < max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(below, one, norm))
        torch._foreach_mul_(grads, torch.where(below, one, torch.full_like(norm, max_norm)))
        return
    if norm < max_norm:
        return
    torch._foreach_div_(grads, norm.item())
    torch._foreach_mul_(grads, torch.tensor(max_norm).to(norm.dtype).item())


class GroupOptimizer:
    """One optimizer per named param group, each with its own schedule,
    behind an optional global-norm clip over all groups (the optax chain
    of setup/sdxl_setup.py)."""

    def __init__(self, group_schedules: dict, optimizer: Optimizer, cfg,
                 clip_grad_norm: float | None = None):
        self.groups = {name: create_optimizer(optimizer, cfg, schedule)
                       for name, schedule in group_schedules.items()}
        self.clip_grad_norm = clip_grad_norm

    def init(self, params: dict[str, list[torch.Tensor]]) -> dict:
        return {name: opt.init(params[name]) for name, opt in self.groups.items()}

    def updates(self, params: dict[str, list[torch.Tensor]],
                grads: dict[str, list[torch.Tensor]], state: dict,
                norm: torch.Tensor | None = None) -> dict[str, list[torch.Tensor]]:
        """Clip (when configured; `norm` is the gradients' global norm,
        taken here when None) and return every group's updates."""
        return _regroup(params, self.groups, list(self.leaf_updates(params, grads, state,
                                                                    norm)))

    @torch.no_grad()
    def leaf_updates(self, params: dict[str, list[torch.Tensor]],
                     grads: dict[str, list[torch.Tensor]], state: dict,
                     norm: torch.Tensor | None = None):
        """`updates`, leaf by leaf in the groups' order (each group's
        optimizer makes a leaf's update when it is asked for)."""
        if self.clip_grad_norm:
            flat = [g for n in self.groups for g in grads[n]]
            clip_by_global_norm_(flat, self.clip_grad_norm,
                                 global_norm(flat) if norm is None else norm)
            del flat
        for name, opt in self.groups.items():
            yield from opt.leaf_updates(params[name], grads[name], state[name])


def _regroup(params: dict, groups, leaves: list) -> dict[str, list[torch.Tensor]]:
    """{group: its leaves' updates} from the updates of every group's leaves
    in the groups' order."""
    out, i = {}, 0
    for name in groups:
        out[name] = leaves[i:i + len(params[name])]
        i += len(params[name])
    return out


@dataclass
class MultiStepsState:
    inner: dict                 # the wrapped optimizer's state
    acc_grads: dict             # group -> running mean of this cycle's gradients
    mini_step: int = 0          # micro-steps accumulated in this cycle


class MultiSteps:
    """optax.MultiSteps(tx, every_k_schedule=k) with the gradients' mean:
    each micro-step folds its gradients into a running mean, acc + (g -
    acc) / (n + 1) in the parameters' dtype; every k-th hands the mean to
    `tx` (clip included) and returns its updates, and resets the mean. The
    micro-steps between return None where optax returns zero updates: p +
    0 is p, bf16 stochastic rounding included, so nothing is applied."""

    def __init__(self, tx: GroupOptimizer, every_k: int):
        self.tx, self.every_k = tx, every_k

    def init(self, params: dict[str, list[torch.Tensor]]) -> MultiStepsState:
        return MultiStepsState(self.tx.init(params),
                               {name: [torch.zeros_like(p, dtype=arithmetic_dtype(p.dtype))
                                       for p in params[name]]
                                for name in self.tx.groups})

    @torch.no_grad()
    def updates(self, params: dict, grads: dict, state: MultiStepsState,
                norm: torch.Tensor | None = None) -> dict | None:
        """Fold in this micro-step's gradients (`norm`, theirs, is not the
        mean's and goes unused); -> the updates on every k-th, else None."""
        leaves = list(self.leaf_updates(params, grads, state, norm))
        return None if state.mini_step else _regroup(params, self.tx.groups, leaves)

    @torch.no_grad()
    def leaf_updates(self, params: dict, grads: dict, state: MultiStepsState,
                     norm: torch.Tensor | None = None):
        """`updates` leaf by leaf: nothing between every k-th micro-step."""
        n = state.mini_step
        for name, acc in state.acc_grads.items():
            delta = torch._foreach_sub(grads[name], acc)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(acc, delta)
        if n + 1 < self.every_k:
            state.mini_step = n + 1
            return
        yield from self.tx.leaf_updates(params, state.acc_grads, state.inner)
        for acc in state.acc_grads.values():
            torch._foreach_zero_(acc)
        state.mini_step = 0


def create_group_optimizer(group_schedules: dict, optimizer: Optimizer, cfg,
                           clip_grad_norm: float | None = None,
                           accumulation_steps: int = 1):
    """The clipped group optimizer, wrapped in `MultiSteps` when
    `accumulation_steps` > 1 (setup/sd_setup.py:406-411 in the reference)."""
    tx = GroupOptimizer(group_schedules, optimizer, cfg, clip_grad_norm)
    return MultiSteps(tx, accumulation_steps) if accumulation_steps > 1 else tx


def opt_state_tensors(opt_state) -> tuple[dict, dict]:
    """(tensors, counts) of an optimizer state for a backup: each group's
    state tensors under <group>/<name>, MultiSteps' running means under
    acc_grads/<group>/<index>; its step counts (and mini step) by name."""
    inner = opt_state.inner if isinstance(opt_state, MultiStepsState) else opt_state
    tensors = {f"{group}/{name}": t for group, opt in inner.items()
               for name, t in opt.tensors().items()}
    counts = {f"count/{group}": opt.count for group, opt in inner.items()}
    if isinstance(opt_state, MultiStepsState):
        tensors.update({f"acc_grads/{group}/{i}": t
                        for group, acc in opt_state.acc_grads.items()
                        for i, t in enumerate(acc)})
        counts["mini_step"] = opt_state.mini_step
    return tensors, counts


def set_opt_state_counts(opt_state, counts: dict) -> None:
    """Restore what `opt_state_tensors` gave as counts."""
    inner = opt_state.inner if isinstance(opt_state, MultiStepsState) else opt_state
    for group, opt in inner.items():
        opt.count = int(counts[f"count/{group}"])
    if isinstance(opt_state, MultiStepsState):
        opt_state.mini_step = int(counts["mini_step"])


def schedule_free_eval_params(opt_state, params: dict[str, list]) -> dict[str, list] | None:
    """Each group's schedule-free x (`eval_params`), or None when the
    optimizer is not schedule-free."""
    inner = opt_state.inner if isinstance(opt_state, MultiStepsState) else opt_state
    if not all(isinstance(st, OptState) and st.b1 is not None for st in inner.values()):
        return None
    return {group: eval_params(st, params[group]) for group, st in inner.items()}


@contextmanager
def schedule_free_eval(opt_state, params: dict[str, list]):
    """Within the block, the trained tensors (`params`, {group: tensors},
    updated in place) hold schedule-free's x; after it, y again, bit for
    bit (OneTrainer's optimizer.eval() and .train() around a save or a
    sample). No-op for other optimizers."""
    x = schedule_free_eval_params(opt_state, params)
    if x is None:
        yield
        return
    saved = {}
    with torch.no_grad():
        for group, tensors in x.items():
            saved[group] = [p.detach().to("cpu", copy=True) for p in params[group]]
            for p, t in zip(params[group], tensors):
                p.copy_(t)
        del x
    try:
        yield
    finally:
        with torch.no_grad():
            for group, tensors in saved.items():
                for p, t in zip(params[group], tensors):
                    p.copy_(t)
