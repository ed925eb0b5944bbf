"""The port's stochastic rounding and bf16 optimizer arithmetic against
the reference's (onetrainer_tpu/ops/stochastic.py, ops/pallas_sr.py, and
optax's adamw / clip_by_global_norm / global_norm over bf16 leaves).

Tolerances: the plain rounding is bit-exact given the 16 random bits
`jax.random.bits` drew, and, with zero bits, bit-exact against the Pallas
kernel in interpret mode (whose generator reads zeros there, see
tests/test_pallas_sr.py); `apply_updates_stochastic` is bit-exact given
those bits. The plain Philox 4x32-10 that draws K5's bits equals the
generator's published known answers exactly, and the K5 wrapper's CPU
path is the plain rounding on those bits, bit for bit. K5 itself runs
only on the card (tests/test_torch_port_cuda.py holds it bit for bit to
that plain version, and to the properties of stochastic rounding); on the
CPU its wrapper's plain path keeps the properties, checked here. AdamW's bf16 updates: each
operation rounds to bf16 on the port's side, while XLA may keep fp32
between fused operations, so they agree to one bf16 step (2^-8 relative)
of the update; the fp32 updates agree to 1e-6 relative. The bf16 global
norm and the clip are bit-exact on these inputs (the same per-leaf fp32
sums and bf16 additions).

bf16 adapters with stochastic rounding off, through both setups and two
training steps on a tiny SDXL (tests/test_torch_port_train_sdxl.py's
model, draws and comparison): each side adds its bf16 updates as
optax.apply_updates does, p + u rounded to nearest bf16. The loss holds to
1e-4 relative (fp32 networks), the bf16 grad_norm to 2^-6 relative and
the adapters to 1e-3 relative L2 over the group, as that file's QLoRA
case: an update that differs by one bf16 step can move p + u across a
rounding threshold, one bf16 step of that element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from onetrainer_tpu.ops.pallas_sr import sr_update_pallas
from onetrainer_tpu.ops.stochastic import apply_updates_stochastic as jax_apply
from onetrainer_tpu.ops.stochastic import stochastic_round_to_bf16 as jax_round
from onetrainer_tpu_torch.ops.sr_update import leaf_table, sr_update, sr_update_leaves
from onetrainer_tpu_torch.ops.stochastic import (
    apply_updates_stochastic, philox4x32_10, philox_bits, stochastic_round_to_bf16,
)
from onetrainer_tpu_torch.train.optimizers import AdamW, clip_by_global_norm_, global_norm
from tests import test_torch_port_train_sdxl as train_sdxl
from tests.test_torch_port_train_sdxl import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy().view(np.uint32)
    return np.asarray(a.astype(jnp.float32)).view(np.uint32)


def _values(shape, seed):
    """fp32 values over many magnitudes, signs, zeros and exact bf16s."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 4, shape)
    x = x.astype(np.float32)
    x.flat[:4] = (0.0, -0.0, 1.5, -3.0)
    return x


@pytest.mark.parametrize("shape", [(37, 129), (1000,)])
def test_plain_rounding_matches_jax_bits(shape):
    x = _values(shape, 1)
    key = jax.random.PRNGKey(7)
    want = jax_round(jnp.asarray(x), key)
    bits = np.asarray(jax.random.bits(key, x.shape, dtype=jnp.uint32)).astype(np.int64)
    got = stochastic_round_to_bf16(torch.from_numpy(x), torch.from_numpy(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


@pytest.mark.parametrize("u_dtype", [jnp.float32, jnp.bfloat16])
def test_zero_bits_match_pallas_interpret(u_dtype):
    n = 256 * 128 + 77      # the kernel's padded tail
    rng = np.random.default_rng(2)
    p = jnp.asarray(rng.standard_normal(n), jnp.bfloat16)
    u = jnp.asarray(rng.standard_normal(n) * 1e-2, u_dtype)
    with pltpu.force_tpu_interpret_mode():
        want = sr_update_pallas(p, u.astype(jnp.float32), jnp.asarray(1234))
    pt = torch.from_numpy(np.asarray(p.astype(jnp.float32))).to(torch.bfloat16)
    ut = torch.from_numpy(np.asarray(u.astype(jnp.float32)))
    if u_dtype == jnp.bfloat16:
        ut = ut.to(torch.bfloat16)
    got = stochastic_round_to_bf16(pt.float() + ut.float(), torch.zeros(n, dtype=torch.int64))
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


_M32 = 0xFFFFFFFF
# Philox 4x32-10 known answers (Random123 1.09, kat_vectors): counter, key,
# output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((_M32,) * 4, (_M32,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_matches_known_answers(counter, key, want):
    got = philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert [int(w) for w in got] == list(want)


def test_sr_update_cpu_path_is_the_plain_rounding_on_philox_bits():
    """Word i of `philox_bits` is output i % 4 of Philox at counter i // 4,
    keyed by the seed's 32-bit halves, low first; K5's wrapper rounds on
    those words on the CPU."""
    seed, n = -0x123456789ABCDEF, 4 * 37 + 3
    bits = philox_bits(torch.tensor([seed]), n)
    assert bits.dtype == torch.int64 and bits.shape == (n,)
    assert int(bits.min()) >= 0 and int(bits.max()) <= _M32
    key = (seed & _M32, (seed >> 32) & _M32)
    for i in (0, 1, 2, 3, 4, 77, n - 1):
        zero = torch.zeros(1, dtype=torch.int64)
        words = philox4x32_10((torch.tensor([i // 4]), zero, zero, zero), key)
        assert int(bits[i]) == int(words[i % 4]), i
    gen = torch.Generator().manual_seed(1)
    p = torch.randn((n,), generator=gen).to(torch.bfloat16)
    for u in (torch.randn((n,), generator=gen) * 1e-3,
              (torch.randn((n,), generator=gen) * 1e-3).to(torch.bfloat16)):
        want = stochastic_round_to_bf16(p.float() + u.float(), bits)
        got = sr_update(p, u, torch.tensor([seed]))
        np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


def test_sr_update_cpu_path_keeps_the_properties():
    """The K5 wrapper on CPU tensors (its plain version): every output is
    one of the two bf16 neighbours of p + u, exact where p + u is
    representable, unbiased, and a function of the seed; on CPU tensors it
    launches nothing."""
    n = 1 << 16
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(n, generator=gen).to(torch.bfloat16)
    u = torch.randn(n, generator=gen) * 1e-3
    u[:100] = 0.0
    before = sr_update_leaves.launches
    out = sr_update(p, u, torch.tensor([5]))
    s = p.float() + u
    low = s.view(torch.int32) & ~0xFFFF
    got = out.float().view(torch.int32)
    assert bool(((got == low) | (got == low + 0x10000)).all())
    assert torch.equal(out[:100], p[:100])
    assert torch.equal(sr_update(p, u, torch.tensor([5])), out)
    assert not torch.equal(sr_update(p, u, torch.tensor([6])), out)
    r = sr_update(torch.ones(n, dtype=torch.bfloat16), torch.full((n,), 2.0 ** -9),
                  torch.tensor([9])).float()
    up = (r > 1).float().mean().item()
    assert abs(up - 0.25) <= 5 * (0.25 * 0.75 / n) ** 0.5
    in_place = p.clone()
    assert sr_update(in_place, u, torch.tensor([5]), out=in_place) is in_place
    assert torch.equal(in_place, out)
    assert sr_update_leaves.launches == before


# mixed leaf sizes: single elements, a tail of 1-3 after whole groups, and
# one leaf of 2^20 + 3 elements
LEAF_SIZES = (1, 3, 5, 4, 1000, (1 << 20) + 3, 7, 2)


@pytest.mark.parametrize("alias", [False, True], ids=["new_out", "out_is_p"])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_leaf_list_is_the_per_leaf_call(u_dtype, alias):
    """The list form of K5's wrapper on the CPU is, leaf by leaf and bit
    for bit, `sr_update` on that leaf with its own seed: the plain rounding
    on the Philox bits of seeds[seed_index[i]]."""
    gen = torch.Generator().manual_seed(8)
    ps = [torch.randn(n, generator=gen).to(torch.bfloat16) for n in LEAF_SIZES]
    us = [(torch.randn(n, generator=gen) * 1e-3).to(u_dtype) for n in LEAF_SIZES]
    seeds = torch.tensor([-0x123456789ABCDEF, 5, 1 << 40, -1, 77, 0, 3, 9, 11, 12],
                         dtype=torch.int64)
    seed_index = [9, 0, 2, 3, 1, 4, 6, 8]
    want = [sr_update(p, u, seeds[j:j + 1]) for p, u, j in zip(ps, us, seed_index)]
    for p, u, j, w in zip(ps, us, seed_index, want):
        bits = philox_bits(seeds[j], p.numel())
        np.testing.assert_array_equal(
            _bf16_bits(w), _bf16_bits(stochastic_round_to_bf16(p.float() + u.float(), bits)))
    before = sr_update_leaves.launches
    outs = [p.clone() for p in ps] if alias else None
    got = sr_update_leaves(outs or ps, us, seeds, seed_index=seed_index, outs=outs)
    assert sr_update_leaves.launches == before
    if alias:
        assert all(g is o for g, o in zip(got, outs))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_array_equal(_bf16_bits(g), _bf16_bits(w))


def _kernel_walk(first: np.ndarray, blocks: int, threads: int):
    """(leaf, local group) of every group of the flat range, as
    csrc/sr_update.cu's threads find them: each block takes a contiguous
    share, a thread binary-searches the leaf of its first group and then
    steps by `threads`, moving to the next non-empty leaf when it crosses."""
    groups, n_leaves = int(first[-1]), len(first) - 1
    leaf_of = np.full(groups, -1)
    local_of = np.full(groups, -1)
    per_block = -(-groups // blocks)
    for blk in range(blocks):
        begin, end = blk * per_block, min((blk + 1) * per_block, groups)
        for t in range(threads):
            g = begin + t
            if g >= end:
                continue
            lo, hi = 0, n_leaves
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if first[mid] <= g else (lo, mid)
            leaf = lo
            while g < end:
                while g >= first[leaf + 1]:
                    leaf += 1
                assert leaf_of[g] == -1
                leaf_of[g], local_of[g] = leaf, g - first[leaf]
                g += threads
    return leaf_of, local_of


@pytest.mark.parametrize("sizes", [LEAF_SIZES[:5] + (9, 1030),
                                   (0, 4, 0, 0, 5, 1, 0, 64, 3, 0)],
                         ids=["mixed", "with_empty_leaves"])
def test_leaf_table_maps_every_group_to_its_leaf(sizes):
    """The leaf table's first groups, walked as the kernel walks them, send
    every 4-element group of the flat range to its own leaf and local
    index, at every leaf boundary; the rest of the table holds each leaf's
    pointers, element count and seed index."""
    ps = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    us = [torch.zeros(n, dtype=torch.float32) for n in sizes]
    outs = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    seed_index = np.arange(len(sizes))[::-1].copy()
    table = leaf_table(outs, ps, us, seed_index)
    n_leaves = len(sizes)
    first, rows = table[:n_leaves + 1], table[n_leaves + 1:].reshape(n_leaves, 5)
    want_leaf = np.concatenate([np.full(-(-n // 4), i) for i, n in enumerate(sizes)])
    want_local = np.concatenate([np.arange(-(-n // 4)) for n in sizes])
    assert first[0] == 0 and first[-1] == len(want_leaf)
    for blocks, threads in ((1, 1), (1, 4), (3, 2), (5, 8), (64, 3)):
        leaf, local = _kernel_walk(first, blocks, threads)
        np.testing.assert_array_equal(leaf, want_leaf)
        np.testing.assert_array_equal(local, want_local)
    np.testing.assert_array_equal(rows[:, 0], [t.data_ptr() for t in outs])
    np.testing.assert_array_equal(rows[:, 1], [t.data_ptr() for t in ps])
    np.testing.assert_array_equal(rows[:, 2], [t.data_ptr() for t in us])
    np.testing.assert_array_equal(rows[:, 3], sizes)
    np.testing.assert_array_equal(rows[:, 4], seed_index)


def test_leaf_list_refuses_what_the_kernel_cannot_take():
    p = torch.zeros(8, dtype=torch.bfloat16)
    seeds = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        sr_update_leaves([p.float()], [p], seeds)
    with pytest.raises(ValueError):
        sr_update_leaves([p], [torch.zeros(9)], seeds)
    with pytest.raises(ValueError):
        sr_update_leaves([p], [p], seeds, seed_index=[2])
    with pytest.raises(ValueError):
        sr_update_leaves([p, p], [p], seeds)
    with pytest.raises(ValueError):
        sr_update_leaves([p], [p], seeds.int())


def test_apply_updates_stochastic_gives_each_leaf_its_seed():
    """With interleaved fp32 leaves, bf16 leaf i rounds on seed i of the
    step's draw (one seed per leaf, as before the list kernel), and fp32
    leaves add exactly."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(8, 33), (50,), (4, 3, 3), (1,), (7,)]
    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16, torch.float32]
    params = [torch.randn(s, generator=gen).to(dt) for s, dt in zip(shapes, dtypes)]
    updates = [(torch.randn(s, generator=gen) * 1e-3).to(dt) for s, dt in zip(shapes, dtypes)]
    step = torch.Generator().manual_seed(21)
    seeds = torch.empty(len(params), dtype=torch.int64)
    seeds.random_(generator=torch.Generator().manual_seed(21))
    want = [p + u if p.dtype == torch.float32 else sr_update(p, u, seeds[i:i + 1])
            for i, (p, u) in enumerate(zip(params, updates))]
    got = [p.clone() for p in params]
    apply_updates_stochastic(got, updates, step)
    for g, w in zip(got, want):
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bf16_bits(g), _bf16_bits(w))
        else:
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_apply_updates_stochastic_matches_jax():
    """fp32 leaves add exactly, bf16 leaves round on the reference's bits
    (one key per leaf, in its leaf order)."""
    rng = np.random.default_rng(3)
    params = {"a": jnp.asarray(rng.standard_normal((8, 33)), jnp.bfloat16),
              "b": jnp.asarray(rng.standard_normal(50), jnp.float32),
              "c": jnp.asarray(rng.standard_normal((4, 3, 3)), jnp.bfloat16)}
    updates = {k: jnp.asarray(rng.standard_normal(v.shape) * 1e-3, v.dtype)
               for k, v in params.items()}
    key = jax.random.PRNGKey(11)
    want = jax_apply(params, updates, key)
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    names = sorted(params)          # jax's dict leaf order
    bits = [torch.from_numpy(np.asarray(jax.random.bits(
        k, params[name].shape, dtype=jnp.uint32)).astype(np.int64))
        for k, name in zip(keys, names)]

    def to_torch(a):
        t = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t
    got = [to_torch(params[name]) for name in names]
    apply_updates_stochastic(got, [to_torch(updates[name]) for name in names], bits=bits)
    for name, value in zip(names, got):
        if value.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bf16_bits(value), _bf16_bits(want[name]))
        else:
            np.testing.assert_array_equal(value.numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_updates_follow_optax(dtype):
    """Three steps of AdamW's returned updates (moments in the parameters'
    dtype) against optax.adamw over the same gradients."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(4)
    shapes = [(16, 40), (7,), (3, 3, 8)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    schedule = optax.linear_schedule(1e-3, 5e-4, 10)
    tx = optax.adamw(schedule, weight_decay=1e-2)
    jp = [jnp.asarray(p, jdt) for p in params]
    state = tx.init(jp)
    opt = AdamW(lambda step: float(schedule(step)), weight_decay=1e-2)
    tp = [torch.from_numpy(p).to(tdt) for p in params]
    tstate = opt.init(tp)
    assert all(m.dtype == tdt for m in tstate.mu + tstate.nu)
    for step_grads in grads:
        want, state = tx.update([jnp.asarray(g, jdt) for g in step_grads], state, jp)
        got = opt.updates(tp, [torch.from_numpy(g).to(tdt) for g in step_grads], tstate)
        for g, w in zip(got, want):
            assert g.dtype == tdt
            w = np.asarray(w.astype(jnp.float32), np.float64)
            g = g.float().numpy().astype(np.float64)
            if dtype == "bfloat16":
                np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=0)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
        jp = optax.apply_updates(jp, want)
        tp = [torch.from_numpy(np.asarray(p.astype(jnp.float32))).to(tdt) for p in jp]
    assert tstate.count == 3


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_bf16_global_norm_and_clip_follow_optax(max_norm):
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal(s).astype(np.float32) * rng.uniform(0.01, 1)
              for s in [(4096,), (16, 640), (333,), (64, 64, 3, 3), (17,)] * 4]
    jl = [jnp.asarray(x, jnp.bfloat16) for x in leaves]
    tl = [torch.from_numpy(x).to(torch.bfloat16) for x in leaves]
    want_norm = optax.global_norm(jl)
    norm = global_norm(tl)
    assert norm.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(norm), _bf16_bits(want_norm))
    want, _ = optax.clip_by_global_norm(max_norm).update(jl, optax.EmptyState())
    clip_by_global_norm_(tl, max_norm, norm)
    for got, w in zip(tl, want):
        np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(w))


@pytest.fixture(scope="module")
def bf16_nearest_reference():
    return train_sdxl._reference(train_te=False, bf16_nearest=True)


def test_bf16_adapters_without_stochastic_rounding_match_jax(bf16_nearest_reference):
    ref = bf16_nearest_reference
    assert all(np.asarray(t).dtype.name == "bfloat16"
               for e in ref["init"]["unet_lora"].values() for t in e.values())
    launches = sr_update_leaves.launches
    setup, metrics, up_max, _ = train_sdxl._port_run(ref)
    assert not setup.step_cfg.stochastic_rounding
    assert sr_update_leaves.launches == launches
    assert up_max > 0.0     # gradient-flow canary
    assert all(t.dtype == torch.bfloat16 for v in setup.state.params.values()
               for e in v.values() for t in e.values())
    train_sdxl._assert_matches_reference(ref, setup, metrics, params_rel=train_sdxl.QLORA_REL,
                                         norm_rel=train_sdxl.QLORA_NORM_REL)
