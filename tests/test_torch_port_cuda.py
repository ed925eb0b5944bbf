"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
