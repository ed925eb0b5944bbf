"""Parity of the port's optimizers with the reference's
(onetrainer_tpu_torch/train/optimizers.py, train/dadapt.py,
ops/quant_opt.py against onetrainer_tpu/train/optimizers.py,
train/dadapt.py, ops/quant_opt.py and optax 0.2.6).

1. The int8 state quantizer: codes and scales bit for bit on the same
   values, and the dequantized tensor too.
2. Every value of `Optimizer`, and the flags that change a formula, for
   three steps of the reference's `create_group_optimizer` chained behind
   optax.clip_by_global_norm (jitted, as the reference's step runs it)
   against the port's `GroupOptimizer`, over a tree with a 32768-element
   leaf (so the 8-bit state applies), a 1-D bias, a 4-D conv leaf with two
   axes >= 128 and a small 2-D leaf, in two groups with different learning
   rates, with the clip reached. The port's clip takes the reference's
   global norm (the two sides sum the squares in different orders, and a
   last-bit change of the norm moves every clipped gradient).
   fp32 bounds, per tensor and step:
   - updates rel L2 <= 1e-5, and every int8 code equal;
   - LAMB and Aida 1e-4: they take fp32 norms and dot products of whole
     tensors, which each side sums in its own order (sqrt(32768) 2^-24 is
     1.1e-5);
   - schedule-free (SCHEDULE_FREE_ADAMW/SGD, PRODIGY_PLUS_SCHEDULE_FREE):
     the update is the difference of two iterates y' - y much smaller than
     y, so one rounding of y' (XLA contracts its multiply-adds, torch does
     not) is up to 2^-24 |y| / |update| of it: per element within 4 ulps of
     the tensor's largest |y| plus 1e-5 of its largest update, and z within
     rel L2 1e-5.
   CAME's leaves go in torch layout to the port and flax layout to the
   reference (it factors the reference's last two axes, the port's axes 1
   and 0); every other optimizer gets the same arrays on both sides (the
   int8 blocks follow the memory order).
   bf16 parameters (ADAMW_8BIT, PRODIGY, LION, CAME, SCHEDULE_FREE_ADAMW):
   the state dtypes optax keeps, updates within rel L2 2e-2 (bf16 rounds
   each operation to 2^-8; the two sides round in different places).
3. ROADMAP F23: the reference's `schedule_free_eval_params` returns y on
   the setup's chained state; the port's returns x. F24: a bf16 group
   under ADAMW_8BIT holds no int8 tensor on either side.
4. optax.MultiSteps(every 2) around the clipped group optimizer, under
   PRODIGY and ADAMW_8BIT, the port's norm its own (1e-5, codes within one).
5. Two SD 1.5-shaped LoRA steps through the setups and `make_train_step`
   under PRODIGY and ADAMW_8BIT against the reference's step, at the
   bounds of tests/test_torch_port_train_sd.py, the prompts' word ids by
   crc32 (the same in every process); the step's chunked update
   (a small UPDATE_CHUNK_ELEMENTS) equal to one chunk bit for bit under
   PRODIGY and SCHEDULE_FREE_ADAMW.
6. The train command: one epoch, a backup, a resume and one more epoch
   equal two uninterrupted epochs bit for bit under ADAMW_8BIT (with
   the int8 floor lowered so the adapters' moments are int8), PRODIGY
   and SCHEDULE_FREE_ADAMW; a schedule-free LoRA file holds x, the
   backup y and z.
7. The CUSTOM scheduler's table against the reference's, and
   util/optimizer_util.py against the reference's module.

Torch runs one thread here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.ops import quant_opt as jax_quant_opt
from onetrainer_tpu.train import lr_schedules as jax_lr
from onetrainer_tpu.train.optimizers import create_group_optimizer as jax_group_optimizer
from onetrainer_tpu.train.optimizers import schedule_free_eval_params as jax_eval_params
from onetrainer_tpu.util import enums as E
from onetrainer_tpu.util import optimizer_util as jax_util
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.ops import quant_opt as pt_quant_opt
from onetrainer_tpu_torch.train import lr_schedules as pt_lr
from onetrainer_tpu_torch.train import optimizers as pt_opt
from onetrainer_tpu_torch.util import enums as pt_enums
from onetrainer_tpu_torch.util import optimizer_util as pt_util
from tests.test_torch_port_inpaint import crc32_words

O = E.Optimizer
REL = 1e-5
REDUCTION_REL = 1e-4
BF16_REL = 2e-2
SCHEDULE_FREE = ("SCHEDULE_FREE_ADAMW", "SCHEDULE_FREE_SGD", "PRODIGY_PLUS_SCHEDULE_FREE")
WHOLE_TENSOR_REDUCTIONS = ("LAMB", "LAMB_8BIT", "AIDA")
# group -> leaf -> shape (flax layout); the groups' learning rates
TREE = {"g1": {"a": (256, 128), "bias": (7,)},
        "g2": {"conv": (3, 3, 128, 160), "w": (16, 40)}}
LRS = {"g1": 1e-2, "g2": 3e-3}
ADAPTIVE_LRS = {"g1": 1.0, "g2": 0.5}   # d-adaptive optimizers take lr ~ 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _to_torch_layout(x: np.ndarray, torch_layout: bool) -> np.ndarray:
    if torch_layout and x.ndim == 2:
        return np.ascontiguousarray(x.T)
    if torch_layout and x.ndim == 4:   # [kh, kw, in, out] -> [out, in, kh, kw]
        return np.ascontiguousarray(x.transpose(3, 2, 0, 1))
    return x.copy()


def _from_torch_layout(x: np.ndarray, torch_layout: bool) -> np.ndarray:
    if torch_layout and x.ndim == 2:
        return x.T
    if torch_layout and x.ndim == 4:
        return x.transpose(2, 3, 1, 0)
    return x


def _configs(optimizer: str, flags: dict):
    config = TrainConfig.default_values()
    config.optimizer.optimizer = O(optimizer)
    for key, value in flags.items():
        setattr(config.optimizer, key, value)
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _both(optimizer: str, flags: dict, clip: float | None = 1.0, accumulation: int = 1):
    """(the reference's chained transformation, the port's group optimizer,
    the groups' learning rates) from one config."""
    config, pconfig = _configs(optimizer, flags)
    lrs = ADAPTIVE_LRS if O(optimizer).is_adaptive() else LRS
    labels = {g: {k: g for k in leaves} for g, leaves in TREE.items()}
    tx = jax_group_optimizer({g: (lambda lr: lambda c: lr * jnp.ones([], jnp.float32))(lr)
                              for g, lr in lrs.items()}, O(optimizer), config.optimizer, labels)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if accumulation > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accumulation)
    port = pt_opt.create_group_optimizer({g: (lambda lr: lambda c: lr)(lr) for g, lr in lrs.items()},
                                         pconfig.optimizer.optimizer, pconfig.optimizer, clip,
                                         accumulation)
    return tx, port


def _tree(rng, scale=0.1):
    return {g: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in sorted(leaves.items())} for g, leaves in TREE.items()}


def _grads(rng):
    return {g: {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-2, 0)).astype(np.float32)
                for k, s in sorted(leaves.items())} for g, leaves in TREE.items()}


def _port_tree(tree, dtype, torch_layout):
    return {g: [torch.from_numpy(_to_torch_layout(tree[g][k], torch_layout)).to(dtype)
                for k in sorted(tree[g])] for g in tree}


def _jax_codes(state) -> dict:
    """{(group, state name, leaf): int8 codes} of the reference's state."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state, is_leaf=lambda x: isinstance(x, jax_quant_opt.Q8State))[0]:
        if isinstance(leaf, jax_quant_opt.Q8State):
            keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
            group = next(k for k in keys if k in TREE)
            name = [k for k in keys if isinstance(k, str) and k not in TREE
                    and k not in ("inner_states", "inner_state")
                    and not any(k in leaves for leaves in TREE.values())][-1]
            out[(group, name, keys[-1])] = np.asarray(leaf.values)
    return out


def _port_codes(state) -> dict:
    inner = state.inner if isinstance(state, pt_opt.MultiStepsState) else state
    return {(g, name, sorted(TREE[g])[i]): t.codes.numpy()
            for g, st in inner.items() for name, values in getattr(st, "leaves", {}).items()
            for i, t in enumerate(values) if isinstance(t, pt_quant_opt.Q8)}


def _assert_codes(jax_state, port_state, exact: bool, what: str) -> int:
    want, got = _jax_codes(jax_state), _port_codes(port_state)
    assert set(got) == set(want), what
    for key, codes in want.items():
        diff = np.abs(got[key].astype(np.int32) - codes.astype(np.int32))
        if exact:
            assert not diff.any(), (what, key, int((diff > 0).sum()))
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (what, key)
    return len(want)


# --------------------------------------------------------------- quantizer

def test_quantizer_matches_the_reference_bitwise():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(8 * 2048 + 100) * np.exp(rng.uniform(-20, 2, 8 * 2048 + 100))
         ).astype(np.float32)
    x[2048:4096] = 0.0                      # an all-zero block keeps scale 0
    x[5] = 0.5 * 2.0 ** -20                 # exact half-codes round to even
    for value in (x, x[:16384].reshape(128, 128)):
        want = jax_quant_opt.quantize_leaf(jnp.asarray(value))
        got = pt_quant_opt.quantize(torch.from_numpy(value.copy()))
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.values))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
        np.testing.assert_array_equal(pt_quant_opt.dequantize(got).numpy(),
                                      np.asarray(jax_quant_opt.dequantize_leaf(want)))
    assert pt_quant_opt.eligible(torch.zeros(16384))
    assert not pt_quant_opt.eligible(torch.zeros(16383))
    assert not pt_quant_opt.eligible(torch.zeros(16384, dtype=torch.bfloat16))


# ------------------------------------------------- every optimizer, 3 steps

FLAG_CASES = [
    ("ADAMW", {"amsgrad": True}),
    ("ADAM", {"weight_decay": 0.01}),
    ("ADAM_8BIT", {"amsgrad": True, "weight_decay": 0.01}),
    ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True}),
    ("SGD_8BIT", {"momentum": 0.9}),
    ("ADAGRAD", {"lr_decay": 0.1, "weight_decay": 0.01, "initial_accumulator_value": 1}),
    ("RMSPROP", {"centered": True, "momentum": 0.9, "weight_decay": 0.01}),
    ("RMSPROP_8BIT", {"centered": True}),
    ("LARS", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01}),
    ("LARS_8BIT", {"momentum": 0.9}),
    ("LAMB", {"weight_decay": 0.01}),
    ("LION", {"weight_decay": 0.1}),
    ("ADEMAMIX_8BIT", {"weight_decay": 0.01}),
    ("ADOPT", {"weight_decay": 0.01}),
    ("ADABELIEF", {"weight_decay": 0.01}),
    ("YOGI", {"weight_decay": 0.01}),
    ("DADAPT_ADAM", {"decouple": True, "weight_decay": 0.01}),
    ("DADAPT_ADAM", {"weight_decay": 0.01}),
    ("DADAPT_SGD", {"momentum": 0.9, "growth_rate": 1.02}),
    ("DADAPT_LION", {"weight_decay": 0.01}),
    ("PRODIGY", {"beta3": 0.99}),
    ("PRODIGY", {"safeguard_warmup": True, "weight_decay": 0.01}),
    ("PRODIGY_PLUS_SCHEDULE_FREE", {"safeguard_warmup": True}),
    ("SCHEDULE_FREE_SGD", {"momentum": 0.8}),
    ("AIDA", {"weight_decay": 0.01}),
]
CASES = [(o.value, {}) for o in O] + FLAG_CASES


def _case_id(case):
    name, flags = case
    return name + "".join(f"-{k}={v}" for k, v in flags.items())


def _run_steps(optimizer, flags, dtype, steps=3, seed=0):
    """The two sides over `steps` steps from the same tree and gradients;
    -> per step [(group, leaf, reference update, port update, y before)],
    and the final states."""
    torch_layout = optimizer == "CAME"
    tx, port = _both(optimizer, flags)
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), params)
    tp = _port_tree(params, dtype, torch_layout)
    jstate, tstate = tx.init(jp), port.init(tp)
    update, norm_of = jax.jit(tx.update), jax.jit(optax.global_norm)
    history = []
    for _ in range(steps):
        grads = _grads(rng)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), grads)
        ju, jstate = update(jg, jstate, jp)
        norm = None if dtype == torch.bfloat16 else torch.tensor(float(norm_of(jg)))
        tu = port.updates(tp, _port_tree(grads, dtype, torch_layout), tstate, norm)
        step = []
        for g in TREE:
            for i, k in enumerate(sorted(TREE[g])):
                assert tu[g][i].dtype == dtype and ju[g][k].dtype == jdt
                step.append((g, k, np.asarray(ju[g][k], np.float32),
                             _from_torch_layout(tu[g][i].float().numpy(), torch_layout),
                             np.asarray(jp[g][k], np.float32)))
        history.append(step)
        jp = optax.apply_updates(jp, ju)
        for g in tp:
            pt_opt.add_updates_(tp[g], tu[g])
    return history, jstate, tstate


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_optimizer_matches_the_reference(case):
    optimizer, flags = case
    history, jstate, tstate = _run_steps(optimizer, flags, torch.float32)
    for n, step in enumerate(history):
        for group, leaf, want, got, y in step:
            what = f"step {n} {group}/{leaf}"
            if optimizer in SCHEDULE_FREE:
                atol = 4 * np.spacing(np.float32(np.abs(y).max())) + REL * np.abs(want).max()
                np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)
            else:
                bound = REDUCTION_REL if optimizer in WHOLE_TENSOR_REDUCTIONS else REL
                assert _rel(got, want) <= bound, what
    if optimizer in SCHEDULE_FREE:
        for g in TREE:
            for i, k in enumerate(sorted(TREE[g])):
                z = jstate[1].inner_states[g].inner_state.z[g][k]
                assert _rel(tstate[g].z[i].numpy(), z) <= REL
    # LARS's trust ratio, a quotient of whole-tensor norms, scales its
    # trace: a last-bit difference moves a code at a rounding boundary
    n_int8 = _assert_codes(jstate, tstate, exact=optimizer != "LARS_8BIT", what=optimizer)
    # the 32768- and 184320-element leaves' fp32 state is int8 (SGD without
    # momentum keeps none)
    stateless = optimizer == "SGD_8BIT" and not flags.get("momentum")
    assert (n_int8 > 0) == (optimizer.endswith("_8BIT") and not stateless)
    for st in tstate.values():
        for t in (st.tensors().values() if hasattr(st, "tensors") else []):
            assert t.dtype in (torch.float32, torch.int8)


@pytest.mark.parametrize("optimizer", ["ADAMW_8BIT", "PRODIGY", "LION", "CAME",
                                       "SCHEDULE_FREE_ADAMW"])
def test_bf16_parameters_keep_optax_state_dtypes(optimizer):
    history, jstate, tstate = _run_steps(optimizer, {}, torch.bfloat16)
    for n, step in enumerate(history):
        for group, leaf, want, got, _ in step:
            assert _rel(got, want) <= BF16_REL, f"step {n} {group}/{leaf}"
    jax_dtypes = {str(x.dtype) for x in jax.tree.leaves(jstate)
                  if jnp.issubdtype(x.dtype, jnp.floating)}
    port_dtypes = {str(t.dtype).removeprefix("torch.") for st in tstate.values()
                   for t in st.tensors().values()}
    assert jax_dtypes == port_dtypes == {"bfloat16"}


# --------------------------------------------------------- F23 and F24

def test_f23_reference_eval_params_return_y_and_the_port_returns_x():
    """ROADMAP F23: on the setup's chain(clip, multi_transform(...)) state
    the reference's schedule_free_eval_params finds no b1 and returns the
    parameters, y; the port's gives x = (y - (1 - b1) z) / b1, as optax's
    function gives it from the inner ScheduleFreeState."""
    tx, port = _both("SCHEDULE_FREE_ADAMW", {})
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _port_tree(params, torch.float32, False)
    jstate, tstate = tx.init(jp), port.init(tp)
    for _ in range(3):
        grads = _grads(rng)
        ju, jstate = jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu = port.updates(tp, _port_tree(grads, torch.float32, False), tstate)
        for g in tp:
            pt_opt.add_updates_(tp[g], tu[g])
    reference = jax_eval_params(jstate, jp)
    port_x = pt_opt.schedule_free_eval_params(tstate, tp)
    for g in TREE:
        # optax's schedule_free_eval_params on the inner ScheduleFreeState
        # (its z holds every group, the others masked)
        inner = jstate[1].inner_states[g].inner_state
        want = {k: (jp[g][k] - (1.0 - inner.b1) * inner.z[g][k]) / inner.b1 for k in TREE[g]}
        for i, k in enumerate(sorted(TREE[g])):
            np.testing.assert_array_equal(np.asarray(reference[g][k]), np.asarray(jp[g][k]))
            assert _rel(port_x[g][i].numpy(), want[k]) <= REL
            assert _rel(port_x[g][i].numpy(), np.asarray(jp[g][k])) > 1e-4
    assert pt_opt.schedule_free_eval_params(_both("ADAMW", {})[1].init(tp), tp) is None


def test_f24_bf16_groups_hold_no_int8_state_on_either_side():
    """ROADMAP F24: the reference quantizes fp32 state only, and optax keeps
    Adam's moments in the parameters' dtype, so a bf16 group under
    ADAMW_8BIT keeps bf16 moments on both sides; an fp32 one is int8."""
    tx, port = _both("ADAMW_8BIT", {})
    params = _tree(np.random.default_rng(2))
    for jdt, tdt, int8 in ((jnp.bfloat16, torch.bfloat16, False),
                           (jnp.float32, torch.float32, True)):
        jstate = tx.init(jax.tree.map(lambda x: jnp.asarray(x, jdt), params))
        tstate = port.init(_port_tree(params, tdt, False))
        assert bool(_jax_codes(jstate)) == bool(_port_codes(tstate)) == int8


# --------------------------------------------------------- accumulation

@pytest.mark.parametrize("optimizer", ["PRODIGY", "ADAMW_8BIT"])
def test_multisteps_matches_optax(optimizer):
    tx, port = _both(optimizer, {}, accumulation=2)
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _port_tree(params, torch.float32, False)
    jstate, tstate = tx.init(jp), port.init(tp)
    update = jax.jit(tx.update)
    for micro in range(4):
        grads = _grads(rng)
        ju, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        tu = port.updates(tp, _port_tree(grads, torch.float32, False), tstate)
        if micro % 2 == 0:
            assert tu is None and not any(np.any(np.asarray(x)) for x in jax.tree.leaves(ju))
            continue
        for g in TREE:
            for i, k in enumerate(sorted(TREE[g])):
                assert _rel(tu[g][i].numpy(), ju[g][k]) <= REL, (micro, g, k)
            pt_opt.add_updates_(tp[g], tu[g])
        jp = optax.apply_updates(jp, ju)
    assert all(st.count == 2 for st in tstate.inner.values())
    _assert_codes(jstate, tstate, exact=False, what=optimizer)


# ------------------------------------------------------ the train step

def _first_batch(setup, images, make_batch, jax_setup):
    encode_images, encode_text = jax_setup.make_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, make_batch(encode_images, encode_text, images,
                                                 jnp.asarray))
    return batch, jax.random.PRNGKey(0)


def _reference_run(optimizer: str, lr: float):
    """Two reference SD 1.5 LoRA steps under `optimizer` from the setup
    entry point (tests/test_torch_port_train_sd.py:_reference with the
    optimizer and learning rate set)."""
    from onetrainer_tpu.setup import sd_setup as jax_setup
    from tests.test_torch_port_train_sd import (
        SEED, STEPS, _batch, _configs, _images, _jax_draws, tiny_sd_pair,
    )
    jax_model, _, port = tiny_sd_pair("sd15")
    crc32_words(jax_model.tokenizer), crc32_words(port.tokenizer)
    config, _ = _configs("sd15")
    config.optimizer.optimizer = O(optimizer)
    config.learning_rate = lr
    setup = jax_setup.create_sd_setup(jax_model, config, total_steps=10)
    state = setup.state
    if optimizer == "PRODIGY":
        # ROADMAP F25: optax's prodigy keeps the parameters themselves as
        # params0, and the reference's step donates its state, so its first
        # step raises; a copy of the optimizer state lets it run
        with pytest.raises(Exception, match="donate the same buffer twice"):
            setup.train_step(state, setup.frozen, *_first_batch(setup, _images(),
                                                                _batch, jax_setup))
        state = state.replace(opt_state=jax.tree.map(jnp.copy, state.opt_state))
    init = jax.device_get(state.params)
    images = _images()
    encode_images, encode_text = jax_setup.make_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, encode_text, images,
                                             jnp.asarray))
    key = jax.random.PRNGKey(SEED)
    steps = []
    for step in range(STEPS):
        draws = _jax_draws(setup.step_cfg, batch, key, step)
        state, metrics = setup.train_step(state, setup.frozen, batch, key)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=jax.device_get(state.params)))
    return dict(shape="sd15", jax_model=jax_model, setup=setup, init=init, images=images,
                batch=jax.device_get(batch), steps=steps, port=port,
                port_config=PortTrainConfig.default_values().from_dict(config.to_dict()))


@pytest.mark.parametrize("optimizer,lr", [("PRODIGY", 1.0), ("ADAMW_8BIT", 1e-3)])
def test_lora_steps_match_the_reference_step(optimizer, lr):
    from tests.test_torch_port_train_sd import _port_run
    from tests.test_torch_port_train_sdxl import _assert_matches_reference
    ref = _reference_run(optimizer, lr)
    setup, metrics, up_max = _port_run(ref)
    assert up_max > 0.0
    _assert_matches_reference(ref, setup, metrics)
    # Prodigy's first steps are d0-sized: hold what the two steps moved too
    for group, adapters in ref["steps"][-1]["params"].items():
        moved = [(setup.state.params[group][key][name].detach().numpy() - ref["init"][group][
            key][name], np.asarray(value) - ref["init"][group][key][name])
            for key, entry in adapters.items() for name, value in entry.items()]
        got, want = (np.concatenate([m[i].ravel() for m in moved]) for i in (0, 1))
        assert np.abs(want).max() > 0 and _rel(got, want) <= 1e-4, group


@pytest.mark.parametrize("optimizer", ["PRODIGY", "SCHEDULE_FREE_ADAMW"])
def test_chunked_update_equals_one_chunk_bitwise(optimizer, monkeypatch):
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.train import sd_train_step
    from tests.test_torch_port_train_sd import _batch, _configs, _images, tiny_sd_pair
    results = []
    for chunk in (sd_train_step.UPDATE_CHUNK_ELEMENTS, 300):
        monkeypatch.setattr(sd_train_step, "UPDATE_CHUNK_ELEMENTS", chunk)
        _, _, port = tiny_sd_pair("sd15")
        crc32_words(port.tokenizer)
        _, config = _configs("sd15")
        config.optimizer.optimizer = pt_enums.Optimizer(optimizer)
        config.learning_rate = 1.0 if optimizer == "PRODIGY" else 1e-3
        family = get_family(config.model_type)
        torch.manual_seed(0)
        setup = family.create_setup(port, config, 10)
        encode_images, encode_text = family.make_encode_fns(setup)
        batch = _batch(encode_images, encode_text, torch.from_numpy(_images()),
                       torch.as_tensor)
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            setup.train_step(setup.state, batch, gen)
        results.append({k: t.detach().clone() for k, t in setup.state.opt_state[
            "unet_lora"].tensors().items()} | {f"{key}/{name}": t.detach().clone()
                                              for key, e in setup.state.params[
                                                  "unet_lora"].items()
                                              for name, t in e.items()})
    whole, chunked = results
    assert set(whole) == set(chunked)
    for key, t in whole.items():
        assert torch.equal(t, chunked[key]), key


# ------------------------------------------------- backups and resume

def _trainer_config(root, name, base, ds, optimizer):
    from tests.test_torch_port_trainer import _config, _port
    config = _port(_config(root, name, base, ds))
    config.optimizer.optimizer = pt_enums.Optimizer(optimizer)
    if optimizer == "PRODIGY":
        config.learning_rate = 1.0
    return config


def _train(config, resume: bool = False):
    from onetrainer_tpu_torch.trainer.generic_trainer import GenericTrainer
    config.continue_last_backup = resume
    trainer = GenericTrainer(config, device="cpu")
    trainer.start()
    trainer.train()
    trainer.end()
    return trainer


def _arrays(trainer) -> dict:
    from onetrainer_tpu_torch.trainer.generic_trainer import state_tensors
    tensors, meta = state_tensors(trainer.setup.state)
    return {k: t.detach().clone() for k, t in tensors.items()} | {
        f"meta/{k}": v for k, v in meta.items()}


@pytest.fixture(scope="module")
def trainer_files(tmp_path_factory):
    from tests.test_data import make_dataset
    from tests.test_torch_port_f19 import write_sd_dir
    root = str(tmp_path_factory.mktemp("optimizers"))
    base, ds = os.path.join(root, "ckpt"), make_dataset(os.path.join(root, "ds"), n=4)
    write_sd_dir(base)
    return root, base, ds


@pytest.mark.parametrize("optimizer", ["ADAMW_8BIT", "PRODIGY", "SCHEDULE_FREE_ADAMW"])
def test_resume_continues_bitwise(trainer_files, optimizer, monkeypatch):
    from onetrainer_tpu_torch.io.safetensors_io import SafetensorsFile, load_safetensors
    from onetrainer_tpu_torch.train.train_state import param_groups
    root, base, ds = trainer_files
    # the tiny adapters sit under the 16384-element floor: lower it so the
    # moments of the larger ones are int8
    monkeypatch.setattr(pt_quant_opt, "MIN_SIZE", 256)
    whole = _train(_trainer_config(root, f"{optimizer}-whole", base, ds, optimizer))
    first = _trainer_config(root, f"{optimizer}-split", base, ds, optimizer)
    first.epochs = 1
    first = _train(first)
    with SafetensorsFile(os.path.join(first.config.get_last_backup_path(),
                                      "optimizer.safetensors")) as f:
        keys = set(f.keys())
    if optimizer == "ADAMW_8BIT":
        assert any(k.endswith("/codes") for k in keys) and any(k.endswith("/scales")
                                                               for k in keys)
    if optimizer == "PRODIGY":
        assert "opt_state/unet_lora/estim_lr" in keys
    if optimizer == "SCHEDULE_FREE_ADAMW":
        assert {"opt_state/unet_lora/weight_sum", "opt_state/unet_lora/z/0"} <= keys
    resumed = _train(_trainer_config(root, f"{optimizer}-split", base, ds, optimizer),
                     resume=True)
    assert resumed.train_progress.to_dict() == whole.train_progress.to_dict()
    want, got = _arrays(whole), _arrays(resumed)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(got[key], value), key
        else:
            assert got[key] == value, key
    if optimizer == "SCHEDULE_FREE_ADAMW":
        # the LoRA file holds x (bf16 output), the state y
        state = whole.setup.state
        x = pt_opt.schedule_free_eval_params(state.opt_state, param_groups(state.params))
        out = load_safetensors(whole.config.output_model_destination)
        from onetrainer_tpu_torch.peft.lora import peft_to_kohya_state_dict
        y_file = peft_to_kohya_state_dict(state.params["unet_lora"], whole.setup.peft_cfg,
                                          "lora_unet")
        names = [(key, name) for key, e in state.params["unet_lora"].items()
                 for name in sorted(e)]
        assert len(names) == len(x["unet_lora"])
        swapped = {key: {name: None for name in e}
                   for key, e in state.params["unet_lora"].items()}
        for (key, name), t in zip(names, x["unet_lora"]):
            swapped[key][name] = t
        want_file = peft_to_kohya_state_dict(swapped, whole.setup.peft_cfg, "lora_unet")
        assert set(out) >= set(want_file)
        differs = 0
        for k, t in want_file.items():
            got = out[k].reshape(t.shape)   # a 0-dim alpha is stored as [1]
            assert torch.equal(got, t.to(torch.bfloat16)), k
            differs += not torch.equal(got, y_file[k].to(torch.bfloat16))
        assert differs > 0


# --------------------------------------------------------- CUSTOM, defaults

@pytest.mark.parametrize("class_name,params", [
    ("torch.optim.lr_scheduler.StepLR",
     [{"key": "step_size", "value": "%STEPS_PER_EPOCH%"}, {"key": "gamma", "value": "0.5"}]),
    ("torch.optim.lr_scheduler.CyclicLR",
     [{"key": "base_lr", "value": "1e-5"}, {"key": "max_lr", "value": "%LR%"},
      {"key": "step_size_up", "value": "%STEPS_PER_EPOCH%"},
      {"key": "cycle_momentum", "value": "False"}]),
])
def test_custom_schedule_matches_the_reference_table(class_name, params):
    args = dict(base_lr=3e-4, config_lr=3e-4, total_steps=20, warmup_steps=4,
                num_epochs=4, steps_per_epoch=5)
    want = jax_lr.tabulate_custom_schedule(class_name, params, **args)
    got = pt_lr.tabulate_custom_schedule(class_name, params, **args)
    for step in range(-1, 24):
        assert got(step) == float(want(jnp.asarray(step))), step
    assert got(4) != got(19)


def test_setup_builds_custom_and_schedule_free_schedules():
    from onetrainer_tpu.setup import sd_setup as jax_setup
    from onetrainer_tpu_torch.setup import sd_setup as pt_setup
    config = TrainConfig.default_values()
    config.learning_rate_scheduler = E.LearningRateScheduler.CUSTOM
    config.custom_learning_rate_scheduler = "torch.optim.lr_scheduler.ExponentialLR"
    config.scheduler_params = [{"key": "gamma", "value": "0.9"}]
    config.learning_rate_warmup_steps = 3.0
    for optimizer in (O.ADAMW, O.SCHEDULE_FREE_ADAMW):
        config.optimizer.optimizer = optimizer
        pconfig = PortTrainConfig.default_values().from_dict(config.to_dict())
        want = jax_setup._group_schedule(config, None, 12)
        got = pt_setup._group_schedule(pconfig, None, 12)
        # the port's constant schedule is a python float, rounded to the
        # state's dtype where an optimizer reads it
        assert [np.float32(got(s)) for s in range(12)] == \
            [np.float32(want(jnp.asarray(s))) for s in range(12)]


def test_optimizer_util_matches_the_reference():
    assert {o.value: v for o, v in pt_util.OPTIMIZER_DEFAULT_PARAMETERS.items()} == \
        {o.value: v for o, v in jax_util.OPTIMIZER_DEFAULT_PARAMETERS.items()}
    assert pt_util.OPTIMIZER_DEFAULT_PARAMETERS[pt_enums.Optimizer.SCHEDULE_FREE_SGD][
        "momentum"] == 0.9
    config = TrainConfig.default_values()
    pconfig = PortTrainConfig.default_values().from_dict(config.to_dict())
    for cfg, util, enums in ((config, jax_util, E), (pconfig, pt_util, pt_enums)):
        cfg.optimizer.beta1 = 0.8                    # a user's ADAMW setting
        util.save_optimizer_defaults(cfg)
        cfg.optimizer.optimizer = enums.Optimizer.PRODIGY
        cfg.optimizer = util.change_optimizer(cfg)
        util.init_optimizer_defaults(cfg)
        cfg.optimizer.optimizer = enums.Optimizer.ADAMW
        restored = util.change_optimizer(cfg)
        assert restored.beta1 == 0.8
    assert pconfig.optimizer.to_dict() == config.optimizer.to_dict()
    assert json.dumps(pconfig.to_dict()["optimizer_defaults"], sort_keys=True) == \
        json.dumps(config.to_dict()["optimizer_defaults"], sort_keys=True)


def test_every_optimizer_builds_and_schedule_free_sgd_refuses_momentum_zero():
    _, pconfig = _configs("ADAMW", {})
    for optimizer in pt_enums.Optimizer:
        pt_opt.create_optimizer(optimizer, pconfig.optimizer, 1e-3)
    pconfig.optimizer.momentum = 0.0
    with pytest.raises(ValueError, match="momentum"):
        pt_opt.create_optimizer(pt_enums.Optimizer.SCHEDULE_FREE_SGD, pconfig.optimizer, 1e-3)
