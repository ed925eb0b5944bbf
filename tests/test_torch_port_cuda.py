"""The port's CUDA kernels (K1 forward, K2 dq and K3 dk/dv on the delta of
their shared pre-pass, K4 NF4 dequant, K5 stochastic-rounding update, one
launch over a list of leaves) against their plain PyTorch versions, on the
card, FLUX's blocks on them (the 128 slot at 4173 tokens), and
HunyuanVideo's keep mask over its text padding and its blocks. The
attention cases include tile edges of K1
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
from onetrainer_tpu_torch.models.unet import (
    UNet2DCondition, sd15_unet_config, sdxl_unet_config,
)
from onetrainer_tpu_torch.ops.quant import dequantize_nf4, quantize_nf4
from onetrainer_tpu_torch.peft.lora import PeftConfig, adapter_shapes
from onetrainer_tpu_torch.ops import sr_update as pt_sr
from onetrainer_tpu_torch.ops.sr_update import sr_update, sr_update_leaves
from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16
from onetrainer_tpu_torch.util.enums import PeftType


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
    (4, 4096, 4096, 8, 40, False),  # SD 1.5 @512 batch 4: d=40 in the 64 slot
    (2, 9216, 9216, 5, 64, False),  # SD 2.1 @768 batch 2: the longest model sequence
    (2, 4250, 4250, 24, 64, False),  # SD3 @1024 batch 2: 154 text + 4096 image rows
    (2, 4173, 4173, 24, 128, False),  # FLUX @1024 batch 2: 77 text + 4096, d=128
    (4, 576, 658, 32, 64, False),   # Stable Cascade's prior @1024 batch 4: 576 over 658 keys
    (4, 576, 653, 24, 64, False),   # Würstchen v2's prior @1024 batch 4: 576 over 653 keys
    (1, 4096, 4173, 10, 64, False),  # DiffNeXt @1024: its 64x64 level over 77 more keys
    (1, 256, 333, 20, 64, False),   # DiffNeXt's 16x16 level: one q tile, ragged keys
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
    (4, 4096, 4096, 8, 40, False),    # SD 1.5 @512 batch 4
    (2, 9216, 9216, 5, 64, False),    # SD 2.1 @768 batch 2: K3 over 144 q tiles
    (2, 4250, 4250, 24, 64, False),   # SD3 @1024: ragged last q and kv tiles
    (2, 4173, 4173, 24, 128, False),  # FLUX @1024: ragged tiles in the 128 slot
    (4, 576, 658, 32, 64, False),     # Stable Cascade's prior: more keys than queries
    (4, 576, 653, 24, 64, False),     # Würstchen v2's prior
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
    delta = pt_ff.flash_attention_folded_delta(o, do, h)
    before = (pt_ff.flash_attention_folded_dq.launches,
              pt_ff.flash_attention_folded_dkv.launches,
              pt_ff.flash_attention_folded_delta.launches)
    # K2 and K3 on the pre-pass's delta, as the autograd backward runs them
    dq = pt_ff.flash_attention_folded_dq(*args, **kw, delta=delta)
    dk, dv = pt_ff.flash_attention_folded_dkv(*args, **kw, delta=delta)
    dq_again = pt_ff.flash_attention_folded_dq(*args, **kw, delta=delta)
    dq_own_delta = pt_ff.flash_attention_folded_dq(*args, **kw)
    refs = (pt_ff.flash_attention_folded_dq_reference(*args, **kw),
            *pt_ff.flash_attention_folded_dkv_reference(*args, **kw))
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) \
        == (before[0] + 3, before[1] + 1, before[2] + 1)
    # K2 sums over kv tiles in a fixed order with no atomics: the same bits
    # on every run, and the pre-pass it runs itself is the one handed to it
    assert torch.equal(dq.view(torch.int16), dq_again.view(torch.int16))
    assert torch.equal(dq.view(torch.int16), dq_own_delta.view(torch.int16))
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
def test_fp32_unet_forward_takes_the_library_path_on_card(cuda_device):
    """An fp32 UNet at SD 1.5 widths (320 and 640 channels, 8 heads: d=40
    self-attention over 64x64 = 4096 tokens, cut to one down block level
    and one layer per block) runs on the card: its self-attention takes
    scaled_dot_product_attention (K1-K3 take bf16 only), and its output
    matches the same UNet's forward on the CPU within fp32 tolerance (TF32
    off; 1e-3 of the output's scale for convolutions and matmuls summed in
    another order)."""
    from onetrainer_tpu_torch.ops import attention as pt_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = sd15_unet_config(block_out_channels=(320, 640), cross_attn_blocks=(True, False),
                           layers_per_block=1, num_heads=(8, 8), dtype=torch.float32)
    torch.manual_seed(0)
    unet = UNet2DCondition(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    sample = torch.randn((1, 64, 64, 4), generator=gen)
    context = torch.randn((1, 77, 768), generator=gen)
    ts = torch.tensor([500], dtype=torch.int32)
    with torch.no_grad():
        plain = unet(sample, ts, context)
        before = dict(pt_attn.STATS)
        launches = pt_ff.flash_attention_folded_fwd.launches
        out = unet.to(cuda_device)(sample.to(cuda_device), ts.to(cuda_device),
                                   context.to(cuda_device)).cpu()
    assert pt_ff.flash_attention_folded_fwd.launches == launches
    assert pt_attn.STATS["folded"] == before["folded"]
    assert pt_attn.STATS["fallback"] > before["fallback"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - plain).abs().max().item() <= 1e-3 * plain.abs().max().item()


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
                                          (1, 1000, 777, 2, 128), (2, 4250, 4250, 24, 64)])
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
@pytest.mark.parametrize("shape", [
    (1280, 10240), (3, 3, 320, 640), (1000, 777),
    (3072, 18432),   # FLUX's largest kernel, norm1.linear (56.6M elements)
    (15360, 3072),   # FLUX's single-block proj_out
    (384, 3072),     # FLUX.1-fill's x_embedder (its 384 packed input channels)
])
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
    before = sr_update_leaves.launches
    out = sr_update(p, u, seed)
    torch.cuda.synchronize()
    assert sr_update_leaves.launches == before + 1
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


# the SDXL adapter sets at rank 16: QLoRA's 1588 tensors, DoRA's 2382
# (dora_scale beside each pair), LoHa's 3176
_ADAPTER_SETS = {"qlora_adapters": (dict(), 1588),
                 "dora_adapters": (dict(decompose=True), 2382),
                 "loha_adapters": (dict(peft_type=PeftType.LOHA), 3176)}


def _leaf_shapes(name):
    if name == "odd_sizes":
        return [(1,), (3,), (5,), (4,), ((1 << 20) + 3,), (7, 9), (2,), (16, 2560, 3, 3)]
    with torch.device("meta"):
        unet = UNet2DCondition(sdxl_unet_config())
    fields, _ = _ADAPTER_SETS[name]
    return [s for e in adapter_shapes(unet, PeftConfig(rank=16, **fields)).values()
            for s in e.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("alias", [False, True], ids=["new_out", "out_is_p"])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaves", ["qlora_adapters", "odd_sizes", "dora_adapters",
                                    "loha_adapters"])
def test_sr_update_leaves_matches_the_plain_rounding_on_card(cuda_device, leaves, u_dtype,
                                                             alias):
    """One K5 launch over a list of leaves, bit for bit against the plain
    rounding on each leaf's own Philox bits (seeds[seed_index[i]])."""
    shapes = _leaf_shapes(leaves)
    if leaves in _ADAPTER_SETS:
        assert len(shapes) == _ADAPTER_SETS[leaves][1]
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    ps = [torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16)
          for s in shapes]
    us = [(torch.randn(s, generator=gen, device=cuda_device) * 1e-3).to(u_dtype)
          for s in shapes]
    seeds = torch.empty(len(shapes) + 3, dtype=torch.int64, device=cuda_device)
    seeds.random_(generator=gen)
    seed_index = [(3 * i + 2) % len(seeds) for i in range(len(shapes))]
    want = [stochastic_round_to_bf16(p.float() + u.float(),
                                     philox_bits(seeds[j], p.numel()).view(p.shape))
            for p, u, j in zip(ps, us, seed_index)]
    outs = [p.clone() for p in ps] if alias else None
    before = sr_update_leaves.launches
    got = sr_update_leaves(outs or ps, us, seeds, seed_index=seed_index, outs=outs)
    torch.cuda.synchronize()
    assert sr_update_leaves.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.cuda
def test_sr_update_leaves_splits_long_lists_on_card(cuda_device, monkeypatch):
    """A list longer than one launch's leaf table takes one launch per
    MAX_LEAVES leaves and per u dtype, with the same bits."""
    monkeypatch.setattr(pt_sr, "MAX_LEAVES", 3)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    sizes = (1, 5, 4099, 3, 8, 2, 77)
    ps = [torch.randn(n, generator=gen, device=cuda_device).to(torch.bfloat16) for n in sizes]
    us = [torch.randn(n, generator=gen, device=cuda_device).to(dt) * 1e-3
          for n, dt in zip(sizes, [torch.float32, torch.bfloat16] * 4)]
    seeds = torch.arange(len(sizes), dtype=torch.int64, device=cuda_device) * 977 - 5
    before = sr_update_leaves.launches
    got = sr_update_leaves(ps, us, seeds)
    torch.cuda.synchronize()
    # fp32 u: 4 leaves in two launches; bf16 u: 3 leaves in one
    assert sr_update_leaves.launches == before + 3
    for i, (p, u, g) in enumerate(zip(ps, us, got)):
        want = stochastic_round_to_bf16(p.float() + u.float(), philox_bits(seeds[i], p.numel()))
        assert torch.equal(g.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "full", "dots_nb_attn"])
def test_sd3_joint_attention_takes_k1_to_k3_on_card(cuda_device, policy):
    """A two-block SD3 transformer at SD3-medium's width (24 heads of d=64)
    on a 128x128 latent and a 154-row context, bf16 compute: each block's
    joint attention over 4250 tokens launches K1 once in the forward, and
    K2, K3 and the pre-pass once each in the backward; "full"
    checkpointing runs K1 again in the backward, "dots_nb_attn" keeps the
    attention's residuals and does not. The LoRA-free parameter gradients
    of every policy are finite."""
    from onetrainer_tpu_torch.models.sd3 import SD3Transformer2D, sd3_medium_config
    torch.manual_seed(0)
    ckpt = policy != "none"
    cfg = sd3_medium_config(num_layers=2, gradient_checkpointing=ckpt,
                            remat_policy=policy if ckpt else "full")
    model = SD3Transformer2D(cfg).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    latents = torch.randn((2, 128, 128, 16), generator=gen, device=cuda_device)
    context = torch.randn((2, 154, 4096), generator=gen, device=cuda_device)
    pooled = torch.randn((2, 2048), generator=gen, device=cuda_device)
    ts = torch.tensor([250.0, 750.0], device=cuda_device)
    pt_ff.reset_launch_counts()
    out = model(latents, ts, pooled, context)
    assert pt_ff.flash_attention_folded_fwd.launches == 2
    grads = torch.autograd.grad(out.square().mean(),
                                [p for p in model.parameters() if p.requires_grad])
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_fwd.launches,
            pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == (
        4 if policy == "full" else 2, 2, 2, 2)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("checkpointing", [False, True])
def test_cascade_prior_attention_takes_k1_to_k3_on_card(cuda_device, checkpointing):
    """A Stable Cascade prior of one triple per level at stage C's head
    width (d=64) on a 24x24 latent with 77 text rows, bf16 compute: each of
    its four attention blocks attends 576 latent rows over 576 + 82 keys,
    launching K1 once in the forward (twice under checkpointing) and K2, K3
    and the pre-pass once each in the backward; the output and the
    gradients agree with plain attention."""
    from onetrainer_tpu_torch.models.cascade import CascadePriorConfig, StableCascadePrior
    torch.manual_seed(0)
    cfg = CascadePriorConfig(c_hidden=(256, 256), nhead=(4, 4), blocks=(1, 1), c_cond=256,
                             gradient_checkpointing=checkpointing)
    model = StableCascadePrior(cfg).to(cuda_device)
    # the eps head (x_in - a) / (|1 - b| + 1e-5) divides by ~1e-5 where a
    # random head puts b near 1: a tenth of its weights keeps b near 0
    with torch.no_grad():
        model.clf[1].weight.mul_(0.1)
        model.clf[1].bias.zero_()
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 24, 24, 16), generator=gen, device=cuda_device)
    text = torch.randn((2, 77, 1280), generator=gen, device=cuda_device)
    pooled = torch.randn((2, 1280), generator=gen, device=cuda_device)
    r = torch.tensor([0.25, 0.75], device=cuda_device)
    params = [p for p in model.parameters() if p.requires_grad]
    pt_ff.reset_launch_counts()
    out = model(x, r, text, pooled)
    assert pt_ff.flash_attention_folded_fwd.launches == 4
    grads = torch.autograd.grad(out.square().mean(), params)
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_fwd.launches,
            pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == (8 if checkpointing else 4, 4, 4, 4)
    kernel = pt_ff.flash_attention_folded
    pt_ff.flash_attention_folded = lambda q, k, v, h, sm_scale, kv_keep=None: \
        pt_ff.flash_attention_folded_reference(q, k, v, h, sm_scale=sm_scale,
                                               kv_keep=kv_keep)[0]
    try:
        out_plain = model(x, r, text, pooled)
        grads_plain = torch.autograd.grad(out_plain.square().mean(), params)
    finally:
        pt_ff.flash_attention_folded = kernel
    assert ((out - out_plain).norm() / out_plain.norm()).item() <= 5e-2
    flat = torch.cat([g.float().flatten() for g in grads])
    flat_plain = torch.cat([g.float().flatten() for g in grads_plain])
    assert torch.isfinite(flat).all()
    assert ((flat - flat_plain).norm() / flat_plain.norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "full", "dots_nb_attn"])
def test_flux_joint_attention_takes_k1_to_k3_on_card(cuda_device, policy):
    """A FLUX.1-dev transformer cut to one double and one single block at
    full width (24 heads of d=128, RoPE) on a 128x128 latent (4096 packed
    rows) and T5's 77 rows, bf16 compute: each block's attention over 4173
    tokens launches K1 once in the forward, and K2, K3 and the pre-pass
    once each in the backward; "full" checkpointing runs K1 again in the
    backward, "dots_nb_attn" keeps the attention's residuals and does not.
    The parameter gradients of every policy are finite."""
    from onetrainer_tpu_torch.models.flux import (
        FluxTransformer2D, flux_dev_config, pack_latents, prepare_latent_image_ids,
    )
    torch.manual_seed(0)
    ckpt = policy != "none"
    cfg = flux_dev_config(num_layers=1, num_single_layers=1, gradient_checkpointing=ckpt,
                          remat_policy=policy if ckpt else "full")
    model = FluxTransformer2D(cfg).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    packed = pack_latents(torch.randn((2, 128, 128, 16), generator=gen, device=cuda_device))
    t5 = torch.randn((2, 77, 4096), generator=gen, device=cuda_device)
    pooled = torch.randn((2, 768), generator=gen, device=cuda_device)
    ts = torch.tensor([0.25, 0.75], device=cuda_device)
    guidance = torch.full((2,), 3.5, device=cuda_device)
    img_ids = prepare_latent_image_ids(128, 128, cuda_device)
    pt_ff.reset_launch_counts()
    out = model(packed, ts, pooled, t5, img_ids, None, guidance)
    assert out.shape == (2, 4096, 64)
    assert pt_ff.flash_attention_folded_fwd.launches == 2
    grads = torch.autograd.grad(out.square().mean(),
                                [p for p in model.parameters() if p.requires_grad])
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_fwd.launches,
            pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == (
        4 if policy == "full" else 2, 2, 2, 2)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
def test_flux_fill_forward_with_k1_matches_plain_attention_on_card(cuda_device, monkeypatch):
    """A FLUX.1-fill transformer (384 packed input channels) cut to one
    double and one single block at full width, bf16 compute, on a 128x128
    latent with its conditioning latent and 8x8-shuffled mask (4096 packed
    rows) and T5's 77 rows: K1 once per block, and the output within 5e-2
    relative L2 of the same forward on the plain attention (bf16 roundings
    of two attentions carried through a network of random weights, as
    chip_smoke.py's transformer phases bound it)."""
    from onetrainer_tpu_torch.models.flux import (
        FluxTransformer2D, flux_fill_config, pack_latents, prepare_latent_image_ids,
    )
    torch.manual_seed(0)
    model = FluxTransformer2D(flux_fill_config(num_layers=1, num_single_layers=1)).to(
        cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    mask = (torch.rand((2, 128, 128, 64), generator=gen, device=cuda_device) > 0.5).float()
    packed = torch.cat([pack_latents(torch.randn((2, 128, 128, 16), generator=gen,
                                                 device=cuda_device)),
                        pack_latents(torch.randn((2, 128, 128, 16), generator=gen,
                                                 device=cuda_device)),
                        pack_latents(mask)], dim=-1)
    assert packed.shape == (2, 4096, 384)
    args = (packed, torch.tensor([0.25, 0.75], device=cuda_device),
            torch.randn((2, 768), generator=gen, device=cuda_device),
            torch.randn((2, 77, 4096), generator=gen, device=cuda_device),
            prepare_latent_image_ids(128, 128, cuda_device), None,
            torch.full((2,), 30.0, device=cuda_device))
    pt_ff.reset_launch_counts()
    with torch.no_grad():
        out = model(*args)
        torch.cuda.synchronize()
        assert pt_ff.flash_attention_folded_fwd.launches == 2

        def plain(q, k, v, num_heads, *, sm_scale, kv_keep=None):
            return pt_ff.flash_attention_folded_reference(
                q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)[0]
        monkeypatch.setattr(pt_ff, "flash_attention_folded", plain)
        want = model(*args)
    assert out.shape == want.shape == (2, 4096, 64)
    assert torch.isfinite(out).all()
    rel = ((out.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= 5e-2, rel


def _hunyuan_keep(b: int, s_img: int, real_text: int, device) -> torch.Tensor:
    """HunyuanVideo's kv keep mask: every image row, then 77 text rows of
    which the first `real_text` are kept and the padding dropped."""
    keep = torch.ones((b, s_img + 77), dtype=torch.bool, device=device)
    keep[:, s_img + real_text:] = False
    return keep


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_img,h,real_text", [
    (1, 2304, 4, 29),   # 9 latent frames of 16x16 patches: 2381 = 18 x 128 + 77
    (2, 512, 2, 3),     # 589 rows; sample 1 keeps more text than sample 0
])
def test_hunyuan_keep_mask_attention_matches_plain_versions_on_card(cuda_device, b, s_img,
                                                                    h, real_text):
    """HunyuanVideo's joint attention scaled down: image rows first, the 77
    text rows last, their padding dropped by the -1e30 kv bias, so whole
    key columns of the ragged last tile are dropped for every query tile,
    and the padded text queries still attend the kept keys. K1, K2, K3 and
    the pre-pass against their plain versions at the bounds above."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    s, d = s_img + 77, 128

    def rand():
        return torch.randn((b, s, h * d), generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
    q, k, v, do = rand(), rand(), rand(), rand()
    keep = _hunyuan_keep(b, s_img, real_text, cuda_device)
    keep[-1, s_img + real_text:s_img + real_text + 5] = True
    kw = dict(sm_scale=d ** -0.5, kv_keep=keep)
    o, lse = pt_ff.flash_attention_folded_fwd(q, k, v, h, **kw)
    o_ref, lse_ref = pt_ff.flash_attention_folded_reference(q, k, v, h, **kw)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    args = (q, k, v, o, lse, do, h)
    delta = pt_ff.flash_attention_folded_delta(o, do, h)
    dq = pt_ff.flash_attention_folded_dq(*args, **kw, delta=delta)
    dk, dv = pt_ff.flash_attention_folded_dkv(*args, **kw, delta=delta)
    refs = (pt_ff.flash_attention_folded_dq_reference(*args, **kw),
            *pt_ff.flash_attention_folded_dkv_reference(*args, **kw))
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), refs):
        diff, ref = got.float() - ref.float(), ref.float()
        assert diff.abs().max().item() <= 2e-2 * ref.abs().max().item()
        assert (diff.norm() / ref.norm()).item() <= 2e-3
    # a dropped key gets no gradient
    dropped = ~keep
    assert not dk.float().reshape(b, s, -1)[dropped].any()
    assert not dv.float().reshape(b, s, -1)[dropped].any()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "full"])
def test_hunyuan_joint_attention_takes_k1_to_k3_on_card(cuda_device, policy):
    """A HunyuanVideo transformer cut to one double and one single block at
    full width (24 heads of d=128, 3D RoPE on the image rows) on 3 latent
    frames of 32x32 (768 packed rows) and 77 Llama rows with 29 kept, bf16
    compute: each block's attention over 845 tokens launches K1 once in the
    forward with the keep mask, and K2, K3 and the pre-pass once each in
    the backward; "full" checkpointing runs K1 again in the backward. The
    refiner's 77-token attention stays on PyTorch's attention. The
    parameter gradients are finite."""
    from onetrainer_tpu_torch.models.hunyuan_video import (
        HunyuanVideoTransformer3D, hunyuan_video_config,
    )
    torch.manual_seed(0)
    cfg = hunyuan_video_config(num_layers=1, num_single_layers=1,
                               gradient_checkpointing=policy == "full")
    model = HunyuanVideoTransformer3D(cfg).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    latents = torch.randn((1, 3, 32, 32, 16), generator=gen, device=cuda_device)
    states = torch.randn((1, 77, 4096), generator=gen, device=cuda_device)
    mask = _hunyuan_keep(1, 0, 29, cuda_device).int()
    pooled = torch.randn((1, 768), generator=gen, device=cuda_device)
    pt_ff.reset_launch_counts()
    out = model(latents, torch.tensor([500.0], device=cuda_device), states, mask, pooled,
                torch.tensor([6000.0], device=cuda_device))
    assert out.shape == (1, 3, 32, 32, 16)
    assert pt_ff.flash_attention_folded_fwd.launches == 2
    grads = torch.autograd.grad(out.square().mean(),
                                [p for p in model.parameters() if p.requires_grad])
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_fwd.launches,
            pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == (
        4 if policy == "full" else 2, 2, 2, 2)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("output_axis", [False, True])
def test_dora_over_nf4_decodes_through_k4_on_card(cuda_device, monkeypatch, output_axis):
    """DoRA on an NF4 linear layer and a 3x3 conv (SDXL widths), bf16
    compute: the magnitude at init, each forward and the merge decode each
    layer once through K4, never through the plain decode; the outputs,
    the adapter gradients and the merged bf16 weights equal the plain
    decode's bit for bit (K4 is its plain version's bit for bit)."""
    from onetrainer_tpu_torch.models.layers import conv, linear
    from onetrainer_tpu_torch.ops import quant
    from onetrainer_tpu_torch.ops.quant import quantize_module
    from onetrainer_tpu_torch.peft import lora as pt_lora

    class Layers(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(1280, 1280)
            self.conv = torch.nn.Conv2d(640, 640, 3, padding=1)

    torch.manual_seed(0)
    layers = quantize_module(Layers().to(cuda_device), "nf4")
    cfg = PeftConfig(rank=16, alpha=16.0, decompose=True, decompose_output_axis=output_axis,
                     weight_dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((2, 77, 1280), generator=gen, device=cuda_device)
    img = torch.randn((1, 640, 32, 32), generator=gen, device=cuda_device)

    def run():
        before = pt_nf4.nf4_dequant_flat.launches
        adapters = pt_lora.init_peft_params(torch.Generator(device=cuda_device).manual_seed(2),
                                            layers, cfg)
        for entry in adapters.values():
            entry["lora_up"].normal_(0.0, 0.01, generator=gen.manual_seed(4))
            for t in entry.values():
                t.requires_grad_()
        pt_lora.attach_peft(layers, adapters, cfg)
        y = linear(layers.lin, x, torch.bfloat16)
        c = conv(layers.conv, img, torch.bfloat16)
        flat = [t for e in adapters.values() for t in e.values()]
        grads = torch.autograd.grad(y.float().square().mean() + c.float().square().mean(), flat)
        merged = pt_lora.apply_peft(layers, {k: {n: t.detach() for n, t in e.items()}
                                             for k, e in adapters.items()}, cfg)
        pt_lora.attach_peft(layers, None, None)
        torch.cuda.synchronize()
        return (y, c, grads, merged["lin.weight"], merged["conv.weight"],
                pt_nf4.nf4_dequant_flat.launches - before)

    y, c, grads, w_lin, w_conv, launches = run()
    assert launches == 2 * 3          # init, forward, merge: each layer once
    assert w_lin.dtype == w_conv.dtype == torch.bfloat16
    monkeypatch.setattr(quant, "nf4_dequant_flat", pt_nf4.nf4_dequant_reference)
    py, pc, pgrads, pw_lin, pw_conv, plain_launches = run()
    assert plain_launches == 0
    assert torch.equal(y, py) and torch.equal(c, pc)
    assert torch.equal(w_lin, pw_lin) and torch.equal(w_conv, pw_conv)
    assert all(torch.equal(g, h) for g, h in zip(grads, pgrads))



@pytest.mark.cuda
def test_fp8_lora_weights_train_on_card(cuda_device):
    """fp8 LoRA adapters (`lora_weight_dtype` FLOAT_8) on a linear layer
    and a 3x3 conv at SDXL widths, one step of the train step on the card
    (the factors scaled in fp32, AdamW in fp32, each update added in fp32
    and rounded once to fp8): the loss equals that of the same step with
    fp32 adapters holding the same values, the adapters stay fp8 and
    finite, and every element that moved equals the fp32 step's result
    rounded to fp8 or lies one fp8 step from it."""
    from types import SimpleNamespace

    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.models.layers import conv, linear
    from onetrainer_tpu_torch.peft import lora as pt_lora
    from onetrainer_tpu_torch.train.optimizers import create_group_optimizer
    from onetrainer_tpu_torch.train.sd_train_step import SDStepConfig, make_train_step
    from onetrainer_tpu_torch.train.train_state import create_train_state

    class Layers(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(1280, 1280)
            self.conv = torch.nn.Conv2d(640, 640, 3, padding=1)

    torch.manual_seed(0)
    layers = Layers().to(cuda_device).requires_grad_(False)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((2, 77, 1280), generator=gen, device=cuda_device)
    img = torch.randn((1, 640, 32, 32), generator=gen, device=cuda_device)
    cfg = PeftConfig(rank=16, alpha=32.0, weight_dtype=torch.float8_e4m3fn)
    fp8 = pt_lora.init_peft_params(torch.Generator(device=cuda_device).manual_seed(2),
                                   layers, cfg)
    for entry in fp8.values():
        entry["lora_up"] = (0.1 * torch.randn(entry["lora_up"].shape, generator=gen,
                                              device=cuda_device)).to(torch.float8_e4m3fn)
    start = {k: {n: t.float() for n, t in e.items()} for k, e in fp8.items()}
    config = TrainConfig.default_values()

    def step(adapters, peft_cfg):
        tx = create_group_optimizer({"g": 0.05}, config.optimizer.optimizer, config.optimizer,
                                    1.0)
        state = create_train_state({"g": adapters}, tx)

        def predict(model, batch, generator, cfg, coefficients):
            return (linear(layers.lin, x, torch.float32).square().mean()
                    + conv(layers.conv, img, torch.float32).square().mean()).reshape(1)
        train_step = make_train_step(SimpleNamespace(modules=lambda: {"layers": layers}),
                                     SDStepConfig.from_train_config(config), tx, predict,
                                     losses=lambda batch, data: data)
        pt_lora.attach_peft(layers, adapters, peft_cfg)
        try:
            out = train_step(state, {}, torch.Generator(device=cuda_device).manual_seed(0))
        finally:
            pt_lora.attach_peft(layers, None, None)
        return float(out["loss"]), state.params["g"]

    loss, after = step(fp8, cfg)
    ref_loss, ref = step({k: {n: t.clone() for n, t in e.items()} for k, e in start.items()},
                         PeftConfig(rank=16, alpha=32.0))
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    moved = 0
    for key, entry in after.items():
        for name, t in entry.items():
            assert t.dtype == torch.float8_e4m3fn
            got = t.detach().float()
            want = ref[key][name].detach().to(torch.float8_e4m3fn)
            assert torch.isfinite(got).all()
            changed = got != start[key][name]
            # one fp8 step: adjacent codes of the same sign
            apart = (t.detach().view(torch.uint8).int() - want.view(torch.uint8).int()).abs()
            assert bool((apart[changed] <= 1).all()), (key, name)
            moved += int(changed.sum())
    assert moved > 0


def _sd15_on_card(cuda_device):
    """A seeded SD 1.5 at its published widths on the card (bf16 compute,
    fp32 weights), as chip_smoke.py builds it."""
    from onetrainer_tpu_torch.io.weights import init_sd_weights
    from onetrainer_tpu_torch.models.sd import create_sd_model
    from onetrainer_tpu_torch.util.enums import ModelType
    model = create_sd_model(ModelType.STABLE_DIFFUSION_15, dtype=torch.bfloat16, device="meta")
    init_sd_weights(model, seed=0, device=str(cuda_device))
    return model


def _sd15_setup(model, device, method, size: int, stochastic_rounding: bool = False):
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.setup.families import get_family
    config = TrainConfig.default_values()
    config.model_type = model.model_type
    config.training_method = method
    config.batch_size = 1
    config.learning_rate_warmup_steps = 0.0
    config.optimizer.stochastic_rounding = stochastic_rounding
    family = get_family(config.model_type)
    setup = family.create_setup(model, config, 10)
    encode_images, encode_text = family.make_encode_fns(setup)
    gen = torch.Generator(device=device).manual_seed(11)
    image = torch.rand((1, size, size, 3), generator=gen, device=device) * 2 - 1
    batch = dict(encode_images(image))
    batch.update({k: torch.as_tensor(v, device=device)[None]
                  for k, v in encode_text("a photograph of <embedding> riding a horse").items()})
    batch["image"] = image
    batch["loss_weight"] = torch.ones((1,), device=device)
    return setup, batch


@pytest.mark.cuda
def test_embedding_step_takes_k1_to_k3_on_card(cuda_device, monkeypatch):
    """Textual inversion of SD 1.5 at its published widths on the card
    (512x512, the text encoder run in the step, the UNet and the text
    encoder frozen): one loss's backward to the vectors launches K1 once
    for each of the 5 self-attentions over 4096 tokens, and K2, K3 and the
    pre-pass once for each of the 4 whose q, k and v depend on the text
    (the first comes before any cross-attention); the vectors' gradient
    matches the one through scaled_dot_product_attention within 1e-2
    relative L2 (chip_smoke.py's GRAD_REL_L2_BOUND) and no frozen
    parameter takes a gradient."""
    from onetrainer_tpu_torch.ops import attention as pt_attn
    from onetrainer_tpu_torch.util.enums import TrainingMethod
    model = _sd15_on_card(cuda_device)
    setup, batch = _sd15_setup(model, cuda_device, TrainingMethod.EMBEDDING, 512)
    vectors = setup.state.params["embeddings"].requires_grad_()
    draws = dict(timestep=torch.tensor([500], dtype=torch.int32, device=cuda_device),
                 noise=torch.randn((1, 64, 64, 4), device=cuda_device),
                 latent_noise=torch.zeros((1, 64, 64, 4), device=cuda_device))

    def grad():
        loss = setup.train_step.loss(batch, None, **draws)
        return torch.autograd.grad(loss, [vectors])[0]
    pt_ff.reset_launch_counts()
    kernels = grad()
    torch.cuda.synchronize()
    assert (pt_ff.flash_attention_folded_fwd.launches,
            pt_ff.flash_attention_folded_dq.launches,
            pt_ff.flash_attention_folded_dkv.launches,
            pt_ff.flash_attention_folded_delta.launches) == (5, 4, 4, 4)
    assert not any(p.grad is not None or p.requires_grad
                   for m in model.modules().values() for p in m.parameters())
    monkeypatch.setattr(pt_attn, "_use_folded", lambda *a, **k: False)
    plain = grad()
    assert torch.isfinite(kernels).all() and kernels.abs().max() > 0
    assert ((kernels - plain).norm() / plain.norm()).item() <= 1e-2


@pytest.mark.cuda
def test_vae_ft_update_takes_k5_on_card(cuda_device, monkeypatch):
    """The SD 1.5 VAE fine-tune on the card (the VAE in bf16, stochastic
    rounding, 256x256): one step rounds every VAE tensor in one K5 launch,
    each output equal bit for bit to the plain rounding of p + u on the
    same Philox bits, and moves no attention kernel."""
    from onetrainer_tpu_torch.ops import sr_update
    from onetrainer_tpu_torch.util.enums import TrainingMethod
    model = _sd15_on_card(cuda_device)
    model.vae.to(torch.bfloat16)
    setup, batch = _sd15_setup(model, cuda_device, TrainingMethod.FINE_TUNE_VAE, 256,
                               stochastic_rounding=True)
    calls = []
    real = sr_update.sr_update_leaves

    def captured(ps, us, seeds, *, seed_index=None, outs=None):
        calls.append(([p.clone() for p in ps], [u.clone() for u in us], seeds.clone(),
                      list(seed_index)))
        return real(ps, us, seeds, seed_index=seed_index, outs=outs)
    # the wrapper counts its launches under its module name, here `captured`
    captured.launches = 0
    monkeypatch.setattr(sr_update, "sr_update_leaves", captured)
    pt_ff.reset_launch_counts()
    params = list(setup.state.params["vae"].values())
    setup.train_step(setup.state, batch, torch.Generator(device=cuda_device).manual_seed(5))
    torch.cuda.synchronize()
    assert captured.launches == 1 and len(calls) == 1
    assert pt_ff.flash_attention_folded_fwd.launches == 0
    ps, us, seeds, index = calls[0]
    assert len(ps) == len(params) and all(p.dtype == torch.bfloat16 for p in params)
    for before, u, i, after in zip(ps, us, index, params):
        bits = philox_bits(seeds[i:i + 1], before.numel(), before.device).view(before.shape)
        want = stochastic_round_to_bf16(before.float() + u.float(), bits)
        assert torch.equal(after.view(torch.int16), want.view(torch.int16))
