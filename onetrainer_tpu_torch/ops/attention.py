"""Attention dispatch: the folded flash kernel for long self-attention on
CUDA, PyTorch's `scaled_dot_product_attention` everywhere else.

Counterpart of onetrainer_tpu/ops/attention.py. Inputs are packed
[B, S, H*D]; the head split happens here so models stay layout-agnostic.
The dispatch rules are the reference's shape rules with the TPU-only parts
dropped:
- the kernel runs for tensors on a CUDA device (the reference gates on the
  TPU backend), mask-free or with a kv-only keep mask [B, 1, 1, Skv];
- both sequence lengths within [256, 16384];
- head dims that fit the 64/128 slot: exact 64/128, and off-slot dims
  <= 64 (SD 1.5's 40). Off-slot dims in the 128 slot (d=80) stay on the
  library path, as they are off by default in the reference;
- no num_heads rule (the reference's 128-lane head grouping is a TPU
  tiling constraint) and no sequence padding: the kernel masks ragged
  edges and zero-fills the slot itself.
A kernel failure raises; nothing falls back silently. Both paths are
differentiable: the folded one runs K2 and K3 in its backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from onetrainer_tpu_torch.ops import flash_folded

# dispatch counters (tests assert which path the SD hot shapes take)
STATS = {"folded": 0, "fallback": 0}

_MIN_FOLDED_SEQ = 256
_FOLDED_MAX_SEQ = 16384


def _folded_pad_dim(head_dim: int) -> int | None:
    """The 64/128 slot a head dim folds into, or None if none fits."""
    if head_dim in (64, 128):
        return head_dim
    if head_dim <= 64:
        return 64
    if head_dim <= 128:
        return 128
    return None


def _use_folded(sq: int, skv: int, head_dim: int,
                pad_dim: int | None = None, *, is_cuda: bool) -> bool:
    """Whether the folded kernel takes this attention call."""
    slot = pad_dim if pad_dim is not None else head_dim
    if slot not in (64, 128):
        return False
    if slot != head_dim and slot == 128:
        return False   # padded-to-128 (d=80): off, as in the reference
    if head_dim % 8:
        return False   # the kernel loads 16-byte chunks of each head
    if not is_cuda:
        return False
    return (_MIN_FOLDED_SEQ <= sq <= _FOLDED_MAX_SEQ
            and _MIN_FOLDED_SEQ <= skv <= _FOLDED_MAX_SEQ)


def _kv_keep_of(mask: torch.Tensor | None) -> torch.Tensor | None:
    """The [B, Skv] keep mask when `mask` is kv-only ([B, 1, 1, Skv])."""
    if mask is not None and mask.dim() == 4 and mask.shape[1] == 1 \
            and mask.shape[2] == 1:
        return mask[:, 0, 0, :].to(torch.bool)
    return None


def _attention_folded(q, k, v, num_heads, kv_keep, sm_scale=None):
    """Run the folded kernel on packed tensors. sm_scale defaults to
    1/sqrt(inner/num_heads)."""
    head_dim = q.shape[-1] // num_heads
    if kv_keep is not None and kv_keep.shape[0] != q.shape[0]:
        kv_keep = kv_keep.expand(q.shape[0], -1)
    out = flash_folded.flash_attention_folded(
        q.contiguous(), k.contiguous(), v.contiguous(), num_heads,
        sm_scale=(1.0 / head_dim ** 0.5) if sm_scale is None else sm_scale,
        kv_keep=kv_keep)
    STATS["folded"] += 1
    return out


def dot_product_attention(
        q: torch.Tensor,  # [B, Sq, H, D]
        k: torch.Tensor,  # [B, Skv, H, D]
        v: torch.Tensor,  # [B, Skv, H, D]
        mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-head attention over [B, S, H, D] tensors.

    mask: optional boolean mask, True = attend, broadcastable to
    [B, H, Sq, Skv]. A kv-only keep mask [B, 1, 1, Skv] rides the folded
    kernel; other masks go to scaled_dot_product_attention."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kv_keep = _kv_keep_of(mask)
    dpad = _folded_pad_dim(d)
    if (mask is None or kv_keep is not None) and dpad is not None \
            and _use_folded(sq, skv, d, dpad, is_cuda=q.is_cuda):
        out = _attention_folded(
            q.reshape(b, sq, h * d), k.reshape(b, skv, h * d),
            v.reshape(b, skv, h * d), h, kv_keep, sm_scale=1.0 / d ** 0.5)
        return out.reshape(b, sq, h, d)
    STATS["fallback"] += 1
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=None if mask is None else mask.to(torch.bool))
    return out.transpose(1, 2)


def attention(
        q: torch.Tensor,  # [B, Sq, H*D]
        k: torch.Tensor,  # [B, Skv, H*D]
        v: torch.Tensor,
        num_heads: int,
        mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Packed multi-head attention: split heads, attend, merge heads. When
    the folded kernel applies, the packed tensors feed it directly."""
    b, sq, inner = q.shape
    head_dim = inner // num_heads
    kv_keep = _kv_keep_of(mask)
    if (mask is None or kv_keep is not None) \
            and _use_folded(sq, k.shape[1], head_dim, is_cuda=q.is_cuda):
        return _attention_folded(q, k, v, num_heads, kv_keep)
    out = dot_product_attention(
        q.reshape(b, sq, num_heads, head_dim),
        k.reshape(b, k.shape[1], num_heads, head_dim),
        v.reshape(b, v.shape[1], num_heads, head_dim), mask=mask)
    return out.reshape(b, sq, inner)
