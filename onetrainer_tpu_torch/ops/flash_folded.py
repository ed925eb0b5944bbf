"""Folded-layout flash attention: q/k/v/o are packed [B, S, H*d].

Counterpart of onetrainer_tpu/ops/flash_folded.py, forward and backward.
On a CUDA tensor each wrapper launches its hand-written sm_90a kernel or
raises; on a CPU tensor it runs the plain PyTorch version of the same
function beside it:

- `flash_attention_folded_fwd` (K1, `csrc/flash_fwd.cu`) -> (o, lse);
  plain version `flash_attention_folded_reference`;
- `flash_attention_folded_delta` (the pre-pass, `csrc/flash_bwd.cu`) ->
  delta = rowsum(dO * O), [B, H, Sq] fp32, which K2 and K3 read; plain
  version `flash_attention_folded_delta_reference`;
- `flash_attention_folded_dq` (K2, `csrc/flash_bwd.cu`) -> dq; plain
  version `flash_attention_folded_dq_reference`;
- `flash_attention_folded_dkv` (K3, `csrc/flash_bwd.cu`) -> (dk, dv);
  plain version `flash_attention_folded_dkv_reference`.
K2 and K3 take delta as `delta=`; without it each computes its own (the
pre-pass on the card) first.

`flash_attention_folded` ties them into a `torch.autograd.Function`: its
forward runs K1 and saves (q, k, v, kv_keep, o, lse), its backward runs the
pre-pass once and hands its delta to K2 and K3. The kv mask gets no
gradient.

Semantics (shared by kernels and plain versions): non-causal softmax
attention per head, fp32 softmax statistics, `sm_scale` from the caller
(the REAL head dim's scale), optional kv-drop mask `kv_keep` [B, Skv]
turned into the same finite -1e30 additive bias the TPU kernel uses. Rows
must keep at least one real kv. Any Sq/Skv >= 1 and any head dim d <= 128
with d % 8 == 0 are accepted; nothing is padded by the caller. The
backward follows the TPU kernels' formulas: P = exp(S - lse),
delta = rowsum(dO * O), dS = P * (dO v^T - delta) * sm_scale, with P and
dS rounded to the operands' dtype before their products.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.ops._build import load_library, raw_stream

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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*d] -> fp32 [B, H, S, d]."""
    b, s, inner = x.shape
    return x.float().reshape(b, s, num_heads, inner // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 [B, H, S, d] -> [B, S, H*d] in `dtype`."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _bwd_scores(q, k, v, o, lse, do, num_heads, sm_scale, kv_keep, delta):
    """(P, dS) [B, H, Sq, Skv] fp32, dS rounded to k's dtype; delta
    [B, H, Sq] is computed from o and do when None."""
    qf, kf, vf = (_heads(t, num_heads) for t in (q, k, v))
    dof = _heads(do, num_heads)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if kv_keep is not None:
        s = s + _kv_bias(kv_keep)[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    if delta is None:
        delta = flash_attention_folded_delta_reference(o, do, num_heads)
    ds = (p * (dp - delta[..., None]) * sm_scale).to(k.dtype).float()
    return p, ds


def flash_attention_folded_delta_reference(o, do, num_heads: int) -> torch.Tensor:
    """Plain delta [B, H, Sq] fp32: sum over the head dim of dO * O (the TPU
    `_dkv_kernel`'s and `_dkv_stream_kernel`'s delta)."""
    return (_heads(do, num_heads) * _heads(o, num_heads)).sum(dim=-1)


def flash_attention_folded_dq_reference(
        q, k, v, o, lse, do, num_heads: int, *, sm_scale: float,
        kv_keep: torch.Tensor | None = None,
        delta: torch.Tensor | None = None) -> torch.Tensor:
    """Plain fp32 dq [B, Sq, H*d] in q's dtype (the TPU `_dq_kernel`)."""
    _, ds = _bwd_scores(q, k, v, o, lse, do, num_heads, sm_scale, kv_keep, delta)
    return _merge_heads(torch.matmul(ds, _heads(k, num_heads)), q.dtype)


def flash_attention_folded_dkv_reference(
        q, k, v, o, lse, do, num_heads: int, *, sm_scale: float,
        kv_keep: torch.Tensor | None = None,
        delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain fp32 (dk, dv) [B, Skv, H*d] in k's and v's dtype (the TPU
    `_dkv_kernel` / `_dkv_stream_kernel`)."""
    p, ds = _bwd_scores(q, k, v, o, lse, do, num_heads, sm_scale, kv_keep, delta)
    p = p.to(do.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, num_heads))
    dv = torch.matmul(p.transpose(-1, -2), _heads(do, num_heads))
    return _merge_heads(dk, k.dtype), _merge_heads(dv, v.dtype)


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


def _check_operands(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_cuda(q, k, v, num_heads, kv_keep):
    d = q.shape[2] // num_heads
    if d > _MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} unsupported (need d <= 128, d % 8 == 0)")
    _check_operands(q=q, k=k, v=v)
    if kv_keep is not None and kv_keep.device != q.device:
        raise ValueError("kv_keep must be on q's device")


def _check_stats(name, t, b, sq):
    if t.dtype != torch.float32 or t.dim() != 3 or t.shape[0] != b \
            or t.shape[2] != sq or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous fp32 [B, H, Sq], got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_bwd_cuda(q, o, lse, do, delta):
    b, sq, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(t.shape)}")
    _check_operands(o=o, do=do)
    _check_stats("lse", lse, b, sq)
    if delta is not None:
        _check_stats("delta", delta, b, sq)
        if delta.shape != lse.shape or delta.device != q.device:
            raise ValueError(f"delta must be lse's shape {tuple(lse.shape)} on q's "
                             f"device, got {tuple(delta.shape)} on {delta.device}")


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
        b, sq, skv, num_heads, inner // num_heads, float(sm_scale), raw_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    flash_attention_folded_fwd.launches += 1
    return o, lse


# kernel launches since the last reset (CUDA path only)
flash_attention_folded_fwd.launches = 0


def flash_attention_folded_dq(q, k, v, o, lse, do, num_heads: int, *,
                              sm_scale: float,
                              kv_keep: torch.Tensor | None = None,
                              delta: torch.Tensor | None = None) -> torch.Tensor:
    """dq [B, Sq, H*d] of flash attention over folded tensors. `delta`
    ([B, H, Sq] fp32, `flash_attention_folded_delta`) is computed from o
    and do when not given."""
    _check(q, k, v, num_heads, kv_keep)
    if not q.is_cuda:
        return flash_attention_folded_dq_reference(
            q, k, v, o, lse, do, num_heads, sm_scale=sm_scale, kv_keep=kv_keep,
            delta=delta)
    _check_cuda(q, k, v, num_heads, kv_keep)
    _check_bwd_cuda(q, o, lse, do, delta)
    if delta is None:
        delta = flash_attention_folded_delta(o, do, num_heads)
    b, sq, inner = q.shape
    dq = torch.empty_like(q)
    bias = _kv_bias(kv_keep) if kv_keep is not None else None
    rc = load_library().ot_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias.data_ptr() if bias is not None else None,
        dq.data_ptr(), b, sq, k.shape[1], num_heads, inner // num_heads,
        float(sm_scale), raw_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError {rc}")
    flash_attention_folded_dq.launches += 1
    return dq


flash_attention_folded_dq.launches = 0


def flash_attention_folded_delta(o, do, num_heads: int) -> torch.Tensor:
    """delta [B, H, Sq] fp32 = rowsum(dO * O) per head, the pre-pass of K2
    and K3."""
    if not o.is_cuda:
        return flash_attention_folded_delta_reference(o, do, num_heads)
    if do.shape != o.shape or o.dim() != 3 or o.shape[2] % num_heads:
        raise ValueError(f"o and do must be one packed [B, Sq, H*d] shape, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    d = o.shape[2] // num_heads
    if d > _MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} unsupported (need d <= 128, d % 8 == 0)")
    _check_operands(o=o, do=do)
    b, sq, _ = o.shape
    delta = torch.empty((b, num_heads, sq), dtype=torch.float32, device=o.device)
    rc = load_library().ot_flash_bwd_delta(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, sq, num_heads, d, raw_stream(o))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_delta kernel launch failed: cudaError {rc}")
    flash_attention_folded_delta.launches += 1
    return delta


flash_attention_folded_delta.launches = 0


def flash_attention_folded_dkv(
        q, k, v, o, lse, do, num_heads: int, *, sm_scale: float,
        kv_keep: torch.Tensor | None = None,
        delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Skv, H*d] of flash attention over folded tensors.
    `delta` ([B, H, Sq] fp32, `flash_attention_folded_delta`) is computed
    from o and do when not given."""
    _check(q, k, v, num_heads, kv_keep)
    if not q.is_cuda:
        return flash_attention_folded_dkv_reference(
            q, k, v, o, lse, do, num_heads, sm_scale=sm_scale, kv_keep=kv_keep,
            delta=delta)
    _check_cuda(q, k, v, num_heads, kv_keep)
    _check_bwd_cuda(q, o, lse, do, delta)
    b, sq, inner = q.shape
    if delta is None:
        delta = flash_attention_folded_delta(o, do, num_heads)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bias = _kv_bias(kv_keep) if kv_keep is not None else None
    rc = load_library().ot_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), bias.data_ptr() if bias is not None else None,
        dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], num_heads,
        inner // num_heads, float(sm_scale), raw_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError {rc}")
    flash_attention_folded_dkv.launches += 1
    return dk, dv


flash_attention_folded_dkv.launches = 0


def reset_launch_counts() -> None:
    """Zero the launch counters of K1, K2, K3 and K3's pre-pass."""
    for fn in (flash_attention_folded_fwd, flash_attention_folded_dq,
               flash_attention_folded_dkv, flash_attention_folded_delta):
        fn.launches = 0


class _FlashFolded(torch.autograd.Function):
    """K1 forward; backward: the delta pre-pass once, then K2 and K3 on its
    delta. kv_keep gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_keep, num_heads, sm_scale):
        o, lse = flash_attention_folded_fwd(
            q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)
        ctx.save_for_backward(q, k, v, kv_keep, o, lse)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_keep, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_attention_folded_delta(o, do, ctx.num_heads)
        kwargs = dict(sm_scale=ctx.sm_scale, kv_keep=kv_keep, delta=delta)
        dq = flash_attention_folded_dq(q, k, v, o, lse, do, ctx.num_heads, **kwargs)
        dk, dv = flash_attention_folded_dkv(q, k, v, o, lse, do, ctx.num_heads,
                                            **kwargs)
        return dq, dk, dv, None, None, None


def flash_attention_folded(
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        num_heads: int,
        *,
        sm_scale: float,
        kv_keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """Flash attention over folded [B, S, H*d] tensors -> o, differentiable
    in q, k and v (the delta pre-pass, K2 and K3 in the backward)."""
    return _FlashFolded.apply(q, k, v, kv_keep, num_heads, sm_scale)
