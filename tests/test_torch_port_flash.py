"""Parity of the torch port's folded flash attention and attention dispatch
(onetrainer_tpu_torch/ops) with the JAX reference (onetrainer_tpu/ops).

On the CPU the JAX side runs its Pallas kernel (K1, `_fwd_kernel`) in
interpret mode, as tests/test_flash_folded.py does, and the port's wrapper
runs its plain PyTorch version. Inputs are made with numpy from a seed and
fed to both sides in fp32.

Tolerance: fp32 on both sides; the online (blocked) softmax and the
one-pass softmax differ only by rounding, so o and lse agree to 1e-5
absolute (values are O(1)); the dispatcher comparison goes through XLA's
and PyTorch's own attention code and agrees to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.ops import attention as jax_attn
from onetrainer_tpu.ops import flash_folded as jax_ff
from onetrainer_tpu_torch.ops import attention as pt_attn
from onetrainer_tpu_torch.ops import flash_folded as pt_ff


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-5
DISPATCH_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(seed, b, sq, skv, inner):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, inner), dtype=np.float32)
            for s in (sq, skv, skv)]


def _jax_k1(q, k, v, num_heads, sm_scale, keep=None, block=128):
    """The reference's K1 (`_fwd`) in interpret mode -> (o, lse)."""
    bias = None
    if keep is not None:
        bias = jnp.where(jnp.asarray(keep), 0.0, -1e30).astype(jnp.float32)[:, None, :]
    o, lse = jax_ff._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
                         num_heads, sm_scale, block, block)
    return np.asarray(o), np.asarray(lse)


def _port(q, k, v, num_heads, sm_scale, keep=None):
    o, lse = pt_ff.flash_attention_folded_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        num_heads, sm_scale=sm_scale,
        kv_keep=None if keep is None else torch.from_numpy(keep))
    return o.numpy(), lse.numpy()


def _assert_same(port, ref):
    np.testing.assert_allclose(port[0], ref[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(port[1], ref[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("dp,num_heads", [(64, 2), (64, 4), (128, 2), (128, 4)])
def test_forward_matches_jax_kernel(dp, num_heads):
    q, k, v = _qkv(0, 2, 256, 384, num_heads * dp)
    sm = 1.0 / np.sqrt(dp)
    _assert_same(_port(q, k, v, num_heads, sm), _jax_k1(q, k, v, num_heads, sm))


def test_forward_with_kv_keep():
    q, k, v = _qkv(1, 2, 128, 256, 4 * 64)
    keep = np.ones((2, 256), bool)
    keep[:, 200:] = False     # text-padding style tail
    keep[0, 64:80] = False    # a hole
    sm = 1.0 / 8.0
    _assert_same(_port(q, k, v, 4, sm, keep), _jax_k1(q, k, v, 4, sm, keep))


def test_fully_masked_first_chunk():
    """A whole leading kv chunk masked: the -1e30 transient is wiped once
    real kv arrives, on both sides."""
    q, k, v = _qkv(5, 1, 128, 384, 2 * 64)
    keep = np.ones((1, 384), bool)
    keep[:, :128] = False
    sm = 1.0 / 8.0
    _assert_same(_port(q, k, v, 2, sm, keep), _jax_k1(q, k, v, 2, sm, keep))


def test_zero_padded_q_rows():
    """Zero q rows (the reference's sequence padding) see a uniform
    softmax and stay finite on both sides."""
    q, k, v = _qkv(4, 1, 128, 128, 2 * 64)
    q[:, 96:] = 0.0
    sm = 1.0 / 8.0
    port = _port(q, k, v, 2, sm)
    _assert_same(port, _jax_k1(q, k, v, 2, sm))
    np.testing.assert_allclose(port[0][:, 96:], np.broadcast_to(
        v.mean(axis=1, keepdims=True), port[0][:, 96:].shape), atol=ATOL)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 64, 64, 2 * 64))
    before = pt_ff.flash_attention_folded_fwd.launches
    o = pt_ff.flash_attention_folded(q, k, v, 2, sm_scale=0.125)
    ref, _ = pt_ff.flash_attention_folded_reference(q, k, v, 2, sm_scale=0.125)
    assert torch.equal(o, ref)
    assert pt_ff.flash_attention_folded_fwd.launches == before


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 64, 32, 2 * 64))
    with pytest.raises(ValueError):
        pt_ff.flash_attention_folded(q, k[:, :, :64], v, 2, sm_scale=0.125)
    with pytest.raises(ValueError):
        pt_ff.flash_attention_folded(q, k, v, 2, sm_scale=0.125,
                                     kv_keep=torch.ones(1, 32))   # not bool


def _set_jax_force_flash(monkeypatch, d):
    monkeypatch.setenv("OT_FORCE_FLASH", "1")
    if d > 64:
        monkeypatch.setenv("OT_FLASH_FOLDED", "1")   # the reference's 128-slot opt-in


@pytest.mark.parametrize("d,with_mask", [(40, False), (40, True), (80, False),
                                         (80, True)])
def test_attention_matches_jax_dispatcher(monkeypatch, d, with_mask):
    """SD 1.5's off-slot head dims: the JAX dispatcher pads them into its
    64/128 slot and runs K1; the port attends at the real head dim."""
    b, sq, nh = 2, 300, 8
    q, k, v = _qkv(11, b, sq, sq, nh * d)
    mask = None
    if with_mask:
        keep = np.ones((b, sq), bool)
        keep[:, 280:] = False
        mask = keep[:, None, None, :]
    _set_jax_force_flash(monkeypatch, d)
    before = jax_attn.STATS["folded"]
    ref = np.asarray(jax_attn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nh,
        mask=None if mask is None else jnp.asarray(mask)))
    assert jax_attn.STATS["folded"] > before   # the reference took K1
    tmask = None if mask is None else torch.from_numpy(mask)
    out = pt_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), nh, mask=tmask)
    np.testing.assert_allclose(out.numpy(), ref, atol=DISPATCH_ATOL, rtol=0)
    # the folded entry point the card takes, run here through the plain version
    folded = pt_attn._attention_folded(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), nh,
        None if mask is None else tmask[:, 0, 0, :], sm_scale=1.0 / d ** 0.5)
    np.testing.assert_allclose(folded.numpy(), ref, atol=DISPATCH_ATOL, rtol=0)


@pytest.mark.parametrize("sq,skv,d,expected", [
    (4096, 4096, 64, True),    # SDXL 64x64 level self-attention (H=10)
    (1024, 1024, 64, True),    # SDXL 32x32 level self-attention (H=20)
    (4096, 77, 64, False),     # cross-attention over 77 text tokens
    (1024, 77, 64, False),
    (4096, 4096, 40, True),    # SD 1.5 d=40 in the 64 slot
    (1024, 1024, 80, False),   # d=80 in the 128 slot: off, as in the reference
    (4096, 4096, 128, True),
    (4096, 4096, 160, False),  # no slot
    (16384 + 64, 16384 + 64, 64, False),
    (128, 128, 64, False),
])
def test_routing_rule(sq, skv, d, expected):
    slot = pt_attn._folded_pad_dim(d)
    bf16 = torch.bfloat16
    assert pt_attn._use_folded(sq, skv, d, slot, is_cuda=True, dtype=bf16) is expected
    assert not pt_attn._use_folded(sq, skv, d, slot, is_cuda=False, dtype=bf16)


@pytest.mark.parametrize("sq,d", [(4096, 40), (4096, 64), (9216, 64), (1024, 128)])
def test_routing_rule_takes_bf16_only(sq, d):
    """K1-K3 take bf16 operands only: fp32 and fp16 self-attention on the
    card takes the library path (an fp32 or fp16 UNet), bf16 the kernel."""
    slot = pt_attn._folded_pad_dim(d)
    assert pt_attn._use_folded(sq, sq, d, slot, is_cuda=True, dtype=torch.bfloat16)
    for dtype in (torch.float32, torch.float16):
        assert not pt_attn._use_folded(sq, sq, d, slot, is_cuda=True, dtype=dtype)
        assert not pt_attn._use_folded(sq, sq, d, is_cuda=True, dtype=dtype)


def test_cpu_attention_takes_library_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 256, 256, 2 * 64))
    before = dict(pt_attn.STATS)
    pt_attn.attention(q, k, v, 2)
    assert pt_attn.STATS["folded"] == before["folded"]
    assert pt_attn.STATS["fallback"] == before["fallback"] + 1


def _ragged_joint_case(s, pad, nh, d, seed):
    """The port's plain K1 (o, lse) and K2/K3 (dq, dk, dv, through its
    autograd function) on a ragged length `s` against the reference's
    K1-K3 in interpret mode on the sequence padded to `pad`, the padded kv
    masked through `kv_keep` as the reference's dispatcher does
    (onetrainer_tpu/ops/attention.py:273-311); fp32, o and lse 1e-5, the
    gradients 1e-4 absolute, as tests/test_torch_port_flash_bwd.py."""
    import jax

    q, k, v = _qkv(seed, 1, s, s, nh * d)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape, dtype=np.float32)
    sm = 1.0 / np.sqrt(d)
    keep = np.zeros((1, pad), bool)
    keep[:, :s] = True

    def padded(x):
        return jnp.pad(x, ((0, 0), (0, pad - s), (0, 0)))

    o_ref, lse_ref = _jax_k1(*(np.asarray(padded(jnp.asarray(x))) for x in (q, k, v)),
                             nh, sm, keep)
    _assert_same(_port(q, k, v, nh, sm), (o_ref[:, :s], lse_ref[..., :s]))

    def f(q, k, v):
        o = jax_ff.flash_attention_folded(padded(q), padded(k), padded(v), nh, sm_scale=sm,
                                          kv_keep=jnp.asarray(keep), block_q=128,
                                          block_k=128)
        return o[:, :s]
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = pt_ff.flash_attention_folded(tq, tk, tv, nh, sm_scale=sm)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_ragged_joint_sequence_matches_the_padded_jax_kernels():
    """SD3's joint attention at a small size: 154 text + 256 image = 410
    tokens, B1 H2 d64, a length no tile size divides. The reference pads
    the sequence to its block and masks the pad; the port's K1-K3 take the
    ragged length as it is (`_ragged_joint_case`)."""
    _ragged_joint_case(154 + 256, 512, 2, 64, seed=8)


def test_flux_ragged_joint_sequence_at_d128_matches_the_padded_jax_kernels():
    """FLUX's joint attention at a small size in the 128 slot: 77 text (T5's
    padded prompt) + 256 image = 333 tokens, B1 H2 d128; the reference
    pads it to 384 (`_ragged_joint_case`)."""
    _ragged_joint_case(77 + 256, 384, 2, 128, seed=10)
