"""The port's CUDA kernels (K1 forward, K2 dq, K3 dk/dv and its delta
pre-pass, K4 NF4 dequant, K5 stochastic-rounding update) against their plain
PyTorch versions, on the card. The attention cases include tile edges of K1
and K3 (128-row blocks, 64- or 128-row streamed tiles): sequences shorter
than one tile, lengths that are no multiple of 128, and head dims 40 and 80,
whose slot lanes past d would read the neighbouring head's (random) values
if the copies did not zero them.

Needs a CUDA device and nvcc; every test here skips without one. This file
imports no JAX, so it runs on a machine that has only torch; --noconftest
skips tests/conftest.py, which sets up JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from onetrainer_tpu_torch.ops import flash_folded as pt_ff
from onetrainer_tpu_torch.ops import nf4 as pt_nf4
from onetrainer_tpu_torch.ops.quant import dequantize_nf4, quantize_nf4
from onetrainer_tpu_torch.ops.sr_update import sr_update
from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,with_keep", [
    (2, 4096, 4096, 10, 64, False),
    (2, 1024, 1024, 20, 64, False),
    (2, 1000, 777, 4, 40, True),
    (1, 512, 300, 4, 128, True),
    (1, 50, 77, 3, 40, True),       # both below one tile
    (1, 77, 50, 3, 80, False),
    (2, 200, 130, 2, 80, True),
    (2, 129, 300, 2, 128, True),
])
def test_kernel_matches_plain_version_on_card(cuda_device, b, sq, skv, h, d,
                                              with_keep):
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(s):
        return torch.randn((b, s, h * d), generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
    q, k, v = rand(sq), rand(skv), rand(skv)
    keep = None
    if with_keep:
        keep = torch.ones((b, skv), dtype=torch.bool, device=cuda_device)
        keep[:, 250:] = False
        keep[0, :64] = False
    before = pt_ff.flash_attention_folded_fwd.launches
    o, lse = pt_ff.flash_attention_folded_fwd(q, k, v, h, sm_scale=d ** -0.5,
                                              kv_keep=keep)
    o_ref, lse_ref = pt_ff.flash_attention_folded_reference(
        q, k, v, h, sm_scale=d ** -0.5, kv_keep=keep)
    torch.cuda.synchronize()
    assert pt_ff.flash_attention_folded_fwd.launches == before + 1
    # bf16 o on both sides, K1 rounds P to bf16 before P.V: 2e-2 absolute
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d,with_keep", [
    (2, 4096, 4096, 10, 64, False),
    (2, 1024, 1024, 20, 64, False),
    (2, 1000, 777, 4, 40, True),
    (1, 512, 300, 4, 80, True),
    (1, 8192, 8192, 2, 128, False),   # the TPU's q-streaming dk/dv domain
    (1, 50, 77, 3, 40, True),         # both below one tile
    (1, 77, 50, 3, 80, False),
    (2, 200, 130, 2, 80, True),
    (2, 129, 300, 2, 128, True),
])
def test_backward_kernels_match_plain_versions_on_card(cuda_device, b, sq, skv, h, d,
                                                       with_keep):
    gen = torch.Generator(device=cuda_device).manual_seed(1)

    def rand(s):
        return torch.randn((b, s, h * d), generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
    q, k, v, do = rand(sq), rand(skv), rand(skv), rand(sq)
    keep = None
    if with_keep:
        keep = torch.ones((b, skv), dtype=torch.bool, device=cuda_device)
        keep[:, 250:] = False
        keep[0, :64] = False
    kw = dict(sm_scale=d ** -0.5, kv_keep=keep)
    o, lse = pt_ff.flash_attention_folded_fwd(q, k, v, h, **kw)
    args = (q, k, v, o, lse, do, h)
    before = (pt_ff.flash_attention_folded_dq.launches,
              pt_ff.flash_attention_folded_dkv.launches)
    dq = pt_ff.flash_attention_folded_dq(*args, **kw)
    dk, dv = pt_ff.flash_attention_folded_dkv(*args, **kw)
    refs = (pt_ff.flash_attention_folded_dq_reference(*args, **kw),
            *pt_ff.flash_attention_folded_dkv_reference(*args, **kw))
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches) == (before[0] + 1, before[1] + 1)
    # bf16 outputs on both sides, dS and P rounded to bf16 before their
    # products, sums in another order. The gradients are small (max ~0.3 at
    # 4096 tokens), so each is held to its own scale: max error 2% of
    # max|ref| (one bf16 step is ~0.3% of it), relative L2 2e-3 (most
    # elements round alike on both sides: <= 2.9e-4 measured by
    # chip_smoke.py)
    for got, ref in zip((dq, dk, dv), refs):
        diff, ref = got.float() - ref.float(), ref.float()
        assert diff.abs().max().item() <= 2e-2 * ref.abs().max().item()
        assert (diff.norm() / ref.norm()).item() <= 2e-3


@pytest.mark.cuda
def test_autograd_function_launches_k1_to_k3_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((2, 512, 4 * 64), generator=gen, device=cuda_device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    pt_ff.reset_launch_counts()
    out = pt_ff.flash_attention_folded(q, k, v, 4, sm_scale=0.125)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_fwd.launches,
            pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == (1, 1, 1, 1)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
               for g in grads)


def _bwd_inputs(device, seed, b, sq, skv, h, d):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(s):
        return torch.randn((b, s, h * d), generator=gen, device=device).to(torch.bfloat16)
    q, k, v, do = rand(sq), rand(skv), rand(skv), rand(sq)
    o, lse = pt_ff.flash_attention_folded_reference(q, k, v, h, sm_scale=d ** -0.5)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,d", [(2, 4096, 10, 64), (1, 50, 3, 40),
                                      (2, 300, 2, 80), (1, 129, 4, 128)])
def test_delta_prepass_matches_plain_version_on_card(cuda_device, b, sq, h, d):
    _, _, _, o, _, do = _bwd_inputs(cuda_device, 6, b, sq, sq, h, d)
    before = pt_ff.flash_attention_folded_delta.launches
    delta = pt_ff.flash_attention_folded_delta(o, do, h)
    ref = pt_ff.flash_attention_folded_delta_reference(o, do, h)
    torch.cuda.synchronize()
    assert pt_ff.flash_attention_folded_delta.launches == before + 1
    assert delta.dtype == torch.float32 and delta.shape == (b, h, sq)
    # fp32 sums of the same bf16 products, at most 128 terms in another order
    assert (delta - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 1024, 1024, 4, 64), (1, 300, 77, 2, 40),
                                          (1, 1000, 777, 2, 128)])
def test_dkv_is_bitwise_deterministic_on_card(cuda_device, b, sq, skv, h, d):
    """K3 sums over q tiles in a fixed order, with no atomics: two runs on
    the same inputs give the same bits."""
    args = (*_bwd_inputs(cuda_device, 7, b, sq, skv, h, d), h)
    dk, dv = pt_ff.flash_attention_folded_dkv(*args, sm_scale=d ** -0.5)
    dk2, dv2 = pt_ff.flash_attention_folded_dkv(*args, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(dk.view(torch.int16), dk2.view(torch.int16))
    assert torch.equal(dv.view(torch.int16), dv2.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1280, 10240), (3, 3, 320, 640), (1000, 777)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nf4_dequant_is_bitwise_equal_on_card(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = quantize_nf4(torch.randn(shape, generator=gen, device=cuda_device) * 0.02)
    before = pt_nf4.nf4_dequant_flat.launches
    out = pt_nf4.nf4_dequant_flat(q.q, q.scales, dtype)
    ref = pt_nf4.nf4_dequant_reference(q.q, q.scales, dtype)
    torch.cuda.synchronize()
    assert pt_nf4.nf4_dequant_flat.launches == before + 1
    # the same fp32 multiply and one round-to-nearest cast on both sides
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(view), ref.view(view))
    assert dequantize_nf4(q, dtype).shape == shape


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 3, 1_000_003, 16 * 2560 * 3 * 3, 5])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_sr_update_matches_the_plain_rounding_on_card(cuda_device, n, u_dtype):
    """K5 bit for bit against the plain rounding on the Philox bits of the
    same seed (both 32-bit halves and the sign bit set: the key layout)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    p = torch.randn(n, generator=gen, device=cuda_device).to(torch.bfloat16)
    u = (torch.randn(n, generator=gen, device=cuda_device) * 1e-3).to(u_dtype)
    seed = torch.tensor([-0x123456789ABCDEF], dtype=torch.int64, device=cuda_device)
    out = sr_update(p, u, seed)
    ref = stochastic_round_to_bf16(p.float() + u.float(), philox_bits(seed, n))
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 20) + 3, 1_000_003, 5])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_sr_update_keeps_the_properties_on_card(cuda_device, n, u_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    p = torch.randn(n, generator=gen, device=cuda_device).to(torch.bfloat16)
    u = (torch.randn(n, generator=gen, device=cuda_device) * 1e-3).to(u_dtype)
    u[: n // 4] = 0
    seed = torch.tensor([77], dtype=torch.int64, device=cuda_device)
    before = sr_update.launches
    out = sr_update(p, u, seed)
    torch.cuda.synchronize()
    assert sr_update.launches == before + 1
    s = p.float() + u.float()
    low = s.view(torch.int32) & ~0xFFFF
    got = out.float().view(torch.int32)
    # one of the two bf16 neighbours; exact where representable; seeded
    assert bool(((got == low) | (got == low + 0x10000)).all())
    assert torch.equal(out[: n // 4], p[: n // 4])
    assert torch.equal(sr_update(p, u, seed), out)
    if n > 1000:
        assert not torch.equal(sr_update(p, u, seed + 1), out)
        r = sr_update(torch.ones(n, dtype=torch.bfloat16, device=cuda_device),
                      torch.full((n,), 2.0 ** -9, device=cuda_device), seed).float()
        # p = 1, u = 2^-9 rounds up (by 2^-7) with probability 1/4
        up = (r > 1).float().mean().item()
        assert abs(up - 0.25) <= 5 * (0.25 * 0.75 / n) ** 0.5
        err = (r - (1 + 2.0 ** -9)).mean().item()
        assert abs(err) <= 5 * 3 ** 0.5 * 2.0 ** -9 / n ** 0.5
    in_place = p.clone()
    sr_update(in_place, u, seed, out=in_place)
    assert torch.equal(in_place, out)
