"""Parity of the port's folded flash-attention backward (K2 dq, K3 dk/dv:
onetrainer_tpu_torch/ops/flash_folded.py) with the JAX reference's custom
VJP (onetrainer_tpu/ops/flash_folded.py `_bwd`).

On the CPU the JAX side runs its Pallas kernels in interpret mode, as
tests/test_flash_folded.py does: `_dq_kernel`, and `_dkv_kernel` or, with
`_DKV_RESIDENT_MAX_SEQ` lowered, `_dkv_stream_kernel`. The port's wrappers
run their plain PyTorch versions (CPU tensors). Inputs are made with numpy
from a seed and fed to both sides in fp32.

Tolerances: dq/dk/dv of O(1) agree to 1e-4 absolute (fp32 on both sides;
blocked sums in another order); the port's autograd Function against
autograd through the plain forward, both PyTorch fp32, to 1e-5; the
dispatcher's gradients at SD 1.5's head dims to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.ops import attention as jax_attn
from onetrainer_tpu.ops import flash_folded as jax_ff
from onetrainer_tpu_torch.ops import attention as pt_attn
from onetrainer_tpu_torch.ops import flash_folded as pt_ff

ATOL = 1e-4
FN_ATOL = 1e-5


def _inputs(seed, b, sq, skv, inner):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, inner), dtype=np.float32)
               for s in (sq, skv, skv))
    do = rng.standard_normal((b, sq, inner), dtype=np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, nh, sm, keep):
    def f(q, k, v):
        return jax_ff.flash_attention_folded(
            q, k, v, nh, sm_scale=sm,
            kv_keep=None if keep is None else jnp.asarray(keep),
            block_q=128, block_k=128)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, nh, sm, keep):
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tkeep = None if keep is None else torch.from_numpy(keep)
    o, lse = pt_ff.flash_attention_folded_fwd(*t[:3], nh, sm_scale=sm, kv_keep=tkeep)
    args = (*t[:3], o, lse, t[3], nh)
    dq = pt_ff.flash_attention_folded_dq(*args, sm_scale=sm, kv_keep=tkeep)
    dk, dv = pt_ff.flash_attention_folded_dkv(*args, sm_scale=sm, kv_keep=tkeep)
    return [x.numpy() for x in (dq, dk, dv)]


def _keep(case, b, skv):
    if case == "none":
        return None
    keep = np.ones((b, skv), bool)
    if case == "tail":
        keep[:, skv - 70:] = False      # text-padding style tail
        keep[0, 40:56] = False          # a hole
    else:                               # "first_tile": a fully masked kv tile
        keep[:, :128] = False
    return keep


CASES = [
    # dp, heads, sq, skv, kv mask
    (64, 2, 256, 256, "none"),
    (64, 2, 256, 384, "tail"),          # Sq != Skv
    (64, 4, 128, 384, "first_tile"),
    (128, 1, 256, 128, "none"),
    (128, 2, 128, 256, "tail"),
    (128, 1, 128, 384, "first_tile"),
]


@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("dp,nh,sq,skv,mask", CASES)
def test_plain_backward_matches_jax_vjp(monkeypatch, stream, dp, nh, sq, skv, mask):
    if stream:
        # the JAX dk/dv takes its q-streaming kernel above this many tokens
        monkeypatch.setattr(jax_ff, "_DKV_RESIDENT_MAX_SEQ", 64)
    b = 2
    q, k, v, do = _inputs(dp + sq + skv, b, sq, skv, nh * dp)
    keep = _keep(mask, b, skv)
    sm = 1.0 / np.sqrt(dp)
    for port, ref in zip(_port_grads(q, k, v, do, nh, sm, keep),
                         _jax_grads(q, k, v, do, nh, sm, keep)):
        np.testing.assert_allclose(port, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("with_keep", [False, True])
def test_autograd_function_matches_autograd_through_plain_forward(with_keep):
    b, sq, skv, nh, d = 2, 96, 80, 3, 24
    q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3)
                   for i, a in enumerate(_inputs(21, b, sq, skv, nh * d)))
    keep = torch.from_numpy(_keep("tail", b, skv)) if with_keep else None
    sm = d ** -0.5
    out = pt_ff.flash_attention_folded(q, k, v, nh, sm_scale=sm, kv_keep=keep)
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref_out = pt_ff.flash_attention_folded_reference(
        q, k, v, nh, sm_scale=sm, kv_keep=keep)[0]
    ref_grads = torch.autograd.grad(ref_out, (q, k, v), do)
    torch.testing.assert_close(out, ref_out, atol=FN_ATOL, rtol=0)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, atol=FN_ATOL, rtol=0)


def test_cpu_backward_counts_no_launch():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 64, 64, 2 * 64))
    q.requires_grad_()
    before = (pt_ff.flash_attention_folded_dq.launches,
              pt_ff.flash_attention_folded_dkv.launches,
              pt_ff.flash_attention_folded_delta.launches)
    out = pt_ff.flash_attention_folded(q, k, v, 2, sm_scale=0.125)
    torch.autograd.grad(out, q, do)
    assert (pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == before


@pytest.mark.parametrize("d", [40, 64, 128])
def test_delta_reference_matches_jax_formula(d):
    """K3's pre-pass computes the delta that the JAX `_dkv_kernel` and
    `_dkv_stream_kernel` compute per head slice:
    jnp.sum(do.astype(f32) * o.astype(f32), axis=1). Inputs are bf16 (the
    kernels' operand type); both sides sum fp32 products, in another order:
    1e-5 relative, 1e-5 absolute."""
    b, sq, nh = 2, 77, 3
    rng = np.random.default_rng(d)
    o, do = (rng.standard_normal((b, sq, nh * d), dtype=np.float32) for _ in range(2))
    jo, jdo = jnp.asarray(o, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16)
    ref = np.stack([np.stack([np.asarray(
        jnp.sum(jdo[i, :, j * d:(j + 1) * d].astype(jnp.float32)
                * jo[i, :, j * d:(j + 1) * d].astype(jnp.float32), axis=1))
        for j in range(nh)]) for i in range(b)])                     # [B, H, Sq]
    to, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (o, do))
    before = pt_ff.flash_attention_folded_delta.launches
    got = pt_ff.flash_attention_folded_delta(to, tdo, nh)
    assert pt_ff.flash_attention_folded_delta.launches == before   # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, nh, sq)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), pt_ff.flash_attention_folded_delta_reference(to, tdo, nh).numpy())


def _set_jax_force_flash(monkeypatch, d):
    monkeypatch.setenv("OT_FORCE_FLASH", "1")
    if d > 64:
        monkeypatch.setenv("OT_FLASH_FOLDED", "1")   # the reference's 128-slot opt-in


@pytest.mark.parametrize("d,with_mask", [(40, False), (40, True), (80, False),
                                         (80, True)])
def test_dispatcher_grads_match_jax(monkeypatch, d, with_mask):
    """SD 1.5's off-slot head dims: the JAX dispatcher pads into its slot
    and differentiates through K1-K3; the port's library path and its
    folded entry point (plain versions here) give the same gradients."""
    b, sq, nh = 2, 300, 4
    q, k, v, do = _inputs(31, b, sq, sq, nh * d)
    mask = None
    if with_mask:
        keep = np.ones((b, sq), bool)
        keep[:, 280:] = False
        mask = keep[:, None, None, :]
    _set_jax_force_flash(monkeypatch, d)
    before = jax_attn.STATS["folded"]

    def f(q, k, v):
        return jax_attn.attention(q, k, v, nh,
                                  mask=None if mask is None else jnp.asarray(mask))
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    assert jax_attn.STATS["folded"] > before   # the reference took K1-K3

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    tdo = torch.from_numpy(do)
    out = pt_attn.attention(tq, tk, tv, nh, mask=tmask)
    for g, r in zip(torch.autograd.grad(out, (tq, tk, tv), tdo), ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0)
    folded = pt_attn._attention_folded(
        tq, tk, tv, nh, None if tmask is None else tmask[:, 0, 0, :],
        sm_scale=1.0 / d ** 0.5)
    for g, r in zip(torch.autograd.grad(folded, (tq, tk, tv), tdo), ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0)
