"""The port's CUDA kernels (K1 forward, K2 dq, K3 dk/dv) against their plain
PyTorch versions, on the card.

Needs a CUDA device and nvcc; every test here skips without one. This file
imports no JAX, so it runs on a machine that has only torch; --noconftest
skips tests/conftest.py, which sets up JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from onetrainer_tpu_torch.ops import flash_folded as pt_ff


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
            pt_ff.flash_attention_folded_dkv.launches) == (1, 1, 1)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
               for g in grads)
