"""Folded-layout flash attention forward: q/k/v/o are packed [B, S, H*d].

Counterpart of onetrainer_tpu/ops/flash_folded.py (forward only: the
backward kernels come with training). On a CUDA tensor the wrapper launches
the hand-written sm_90a kernel in `csrc/flash_fwd.cu` or raises; on a CPU
tensor it runs `flash_attention_folded_reference`, the plain PyTorch
version of the same function.

Semantics (shared by kernel and reference): non-causal softmax attention
per head, fp32 softmax statistics, `sm_scale` from the caller (the REAL
head dim's scale), optional kv-drop mask `kv_keep` [B, Skv] turned into the
same finite -1e30 additive bias the TPU kernel uses. Rows must keep at
least one real kv. Any Sq/Skv >= 1 and any head dim d <= 128 with
d % 8 == 0 are accepted; nothing is padded by the caller.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30
_MAX_HEAD_DIM = 128


def _kv_bias(kv_keep: torch.Tensor) -> torch.Tensor:
    return torch.where(kv_keep, 0.0, _NEG_INF).to(torch.float32).contiguous()


def flash_attention_folded_reference(
        q: torch.Tensor,   # [B, Sq, H*d]
        k: torch.Tensor,   # [B, Skv, H*d]
        v: torch.Tensor,   # [B, Skv, H*d]
        num_heads: int,
        *,
        sm_scale: float,
        kv_keep: torch.Tensor | None = None,   # [B, Skv] bool keep mask
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 attention: returns (o in q's dtype, lse [B, H, Sq] fp32)."""
    b, sq, inner = q.shape
    skv = k.shape[1]
    d = inner // num_heads
    qf = q.float().reshape(b, sq, num_heads, d).transpose(1, 2)
    kf = k.float().reshape(b, skv, num_heads, d).transpose(1, 2)
    vf = v.float().reshape(b, skv, num_heads, d).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale   # [B, H, Sq, Skv]
    if kv_keep is not None:
        s = s + _kv_bias(kv_keep)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.transpose(1, 2).reshape(b, sq, inner).to(q.dtype), lse


def _check(q, k, v, num_heads, kv_keep):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be packed [B, S, H*d]")
    b, _, inner = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != inner:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if inner % num_heads:
        raise ValueError(f"inner dim {inner} not divisible by {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if kv_keep is not None and (kv_keep.shape != (b, k.shape[1])
                                or kv_keep.dtype != torch.bool):
        raise ValueError(f"kv_keep must be bool [B, Skv], got "
                         f"{kv_keep.dtype} {tuple(kv_keep.shape)}")


def _check_cuda(q, k, v, num_heads, kv_keep):
    d = q.shape[2] // num_heads
    if d > _MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} unsupported (need d <= 128, d % 8 == 0)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_keep is not None and kv_keep.device != q.device:
        raise ValueError("kv_keep must be on q's device")


def flash_attention_folded_fwd(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        num_heads: int,
        *,
        sm_scale: float,
        kv_keep: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over folded tensors -> (o [B, Sq, H*d], lse [B, H, Sq])."""
    _check(q, k, v, num_heads, kv_keep)
    if not q.is_cuda:
        return flash_attention_folded_reference(
            q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)
    _check_cuda(q, k, v, num_heads, kv_keep)
    from onetrainer_tpu_torch.ops._build import load_library

    b, sq, inner = q.shape
    skv = k.shape[1]
    if sq == 0 or skv == 0:
        raise ValueError("empty sequence: every q row needs at least one kv")
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    bias = _kv_bias(kv_keep) if kv_keep is not None else None
    rc = load_library().ot_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), lse.data_ptr(),
        b, sq, skv, num_heads, inner // num_heads, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    flash_attention_folded_fwd.launches += 1
    return o, lse


# kernel launches since the last reset (CUDA path only)
flash_attention_folded_fwd.launches = 0


def flash_attention_folded(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        num_heads: int,
        *,
        sm_scale: float,
        kv_keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention over folded [B, S, H*d] tensors -> o."""
    return flash_attention_folded_fwd(
        q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)[0]
