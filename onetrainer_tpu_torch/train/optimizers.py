"""Optimizers: ADAMW and ADAFACTOR, and gradient accumulation.

Counterpart of the ADAMW and ADAFACTOR branches of
onetrainer_tpu/train/optimizers.py (`_create_base_optimizer`) and of the
clip + multi-group chain, wrapped in optax.MultiSteps for gradient
accumulation, that setup/sd_setup.py and setup/sdxl_setup.py build with
optax. Written by hand to optax's formulas, so the two sides take the
same steps:

- clip by global norm: g * (c / |g|) when |g| >= c, else g
  (optax.clip_by_global_norm; not torch's clip_grad_norm_, which adds
  1e-6 to the norm);
- adamw: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
  u = mu_hat / (sqrt(nu_hat) + eps) + wd p, p -= lr(count) u, with
  count starting at 0 (optax.adamw);
- adafactor: optax.adafactor as the reference builds it (`Adafactor`);
- accumulation: optax.MultiSteps over the clipped group optimizer, the
  running mean of k micro-batch gradients, one update every k micro-steps
  and none in between (`MultiSteps`).

The optimizer returns each step's updates and the caller adds them
(optax.apply_updates, `add_updates_`), or rounds them in stochastically
for bf16 parameters. AdamW's `updates` keeps optax's dtypes and operation order:
the moments are held in the parameters' dtype (bf16 for bf16 adapters),
the bias corrections and the learning rate are rounded to that dtype
before use, and every operation rounds its result, so a bf16 update is
what optax computes in bf16 and an fp32 update what it computes in fp32.
fp16 parameters (fp16 LoRA weights) are the exception: in fp16, optax's
eps 1e-8 and the squares of small gradients underflow to 0, and every
element with a zero gradient gets 0/0 (ROADMAP F15), so their moments are
fp32 and their update is computed and returned in fp32: `add_updates_`
adds it in fp32 and rounds the sum once to fp16. fp8 parameters (fp8 LoRA
weights) are updated alike (optax computes it all in fp8, where AdamW's
first update is NaN in every element: ROADMAP F17), and torch has no
arithmetic in 1-byte floats, so their gradients and MultiSteps' means are
fp32 too (`arithmetic_dtype`). The global norm of bf16 gradients is taken
in bf16 too. Other optimizers and
amsgrad raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from onetrainer_tpu_torch.util.enums import Optimizer


def _d(value, default):
    return default if value is None else value


def arithmetic_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the gradients, means and updates of parameters of
    `dtype`: their own, but fp32 for 1-byte floats (fp8), in which torch
    has no arithmetic."""
    return torch.float32 if dtype.is_floating_point and dtype.itemsize == 1 else dtype


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """AdamW's moments and arithmetic for parameters of `dtype`: their own,
    but fp32 for fp16 and fp8 (see the module docstring)."""
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


@dataclass
class AdamWState:
    count: int = 0
    mu: list = field(default_factory=list)
    nu: list = field(default_factory=list)

    def tensors(self) -> dict[str, torch.Tensor]:
        """Every state tensor by a stable name (backups copy them in place)."""
        return {f"{moment}/{i}": t for moment in ("mu", "nu")
                for i, t in enumerate(getattr(self, moment))}


class AdamW:
    """optax.adamw over a list of tensors, with a step -> lr schedule."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        self.schedule = learning_rate if callable(learning_rate) \
            else (lambda step, lr=learning_rate: lr)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=_compute_dtype(p.dtype))
        return AdamWState(0, [zeros(p) for p in params], [zeros(p) for p in params])

    @torch.no_grad()
    def updates(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                state: AdamWState) -> list[torch.Tensor]:
        """One step's updates (to add to `params`), advancing `state`, in
        optax.adamw's order and the parameters' dtype (fp32 for fp16 and
        fp8 parameters):
        mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu;
        u = -lr * (mu / c1 / (sqrt(nu / c2) + eps) + wd p)."""
        if not params:
            return []
        param_dtype = params[0].dtype
        if any(p.dtype != param_dtype for p in params):
            raise TypeError("one optimizer group must hold one dtype")
        dtype = _compute_dtype(param_dtype)
        if dtype != param_dtype:
            grads = [g.to(dtype) for g in grads]
            params = [p.to(dtype) for p in params] if self.weight_decay else params

        def rounded(x) -> float:
            return torch.as_tensor(x, dtype=torch.float32).to(dtype).item()

        def correction(decay: float, count: int) -> float:
            # 1 - decay^count in fp32 (powf, as XLA), then the moments' dtype
            f32 = torch.float32
            return rounded(1.0 - torch.tensor(decay, dtype=f32) ** torch.tensor(count, dtype=f32))

        # python scalars meet the moments as weakly typed constants: in
        # their dtype, as jnp rounds them
        b1, b2, eps = rounded(self.b1), rounded(self.b2), rounded(self.eps)
        lr = float(self.schedule(state.count))
        state.count += 1
        t = state.count
        # in place where the result rounds as the out-of-place op would
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, rounded(1.0 - self.b1)))
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squares, rounded(1.0 - self.b2))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, squares)
        del squares
        update = torch._foreach_div(state.mu, correction(self.b1, t))
        denom = torch._foreach_div(state.nu, correction(self.b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(params, rounded(self.weight_decay)))
        torch._foreach_mul_(update, rounded(-lr))
        return update

    @torch.no_grad()
    def leaf_updates(self, params: list[torch.Tensor], grads: list[torch.Tensor],
                     state: AdamWState):
        """`updates`' tensors one by one (all made at once: the moments
        update with one `_foreach` launch per operation)."""
        yield from self.updates(params, grads, state)


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


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


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


def create_optimizer(optimizer: Optimizer, cfg, learning_rate):
    """The optimizer of one param group (`cfg` is TrainOptimizerConfig;
    defaults follow the reference's per-optimizer tables)."""
    if optimizer == Optimizer.ADAFACTOR:
        # the reference's torch convention is a negative decay_rate (-0.8);
        # optax takes its magnitude
        return Adafactor(
            learning_rate, decay_rate=abs(_d(cfg.decay_rate, -0.8)),
            clipping_threshold=_d(cfg.clip_threshold, 1.0),
            momentum=cfg.beta1, weight_decay_rate=_d(cfg.weight_decay, 0.0) or None,
            eps=_d(cfg.eps, 1e-30), multiply_by_parameter_scale=bool(cfg.scale_parameter))
    if optimizer != Optimizer.ADAMW:
        raise NotImplementedError(
            f"optimizer {optimizer} is not ported yet (ADAMW and ADAFACTOR only)")
    if cfg.amsgrad:
        raise NotImplementedError("AdamW with amsgrad is not ported yet")
    return AdamW(learning_rate, b1=_d(cfg.beta1, 0.9), b2=_d(cfg.beta2, 0.999),
                 eps=_d(cfg.eps, 1e-8), weight_decay=_d(cfg.weight_decay, 1e-2))


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
        factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, factor)
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
