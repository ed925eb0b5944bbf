#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`onetrainer_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100/H200) and nvcc; fails without them, and
never falls back to the CPU. Phases, each of which must pass:
  1. build the kernels from onetrainer_tpu_torch/csrc with nvcc, one
     process per source, into one library: K1 (flash-attention forward),
     K2 (dq), K3 (dk, dv) and its delta pre-pass, K4 (NF4 dequant), K5
     (stochastic-rounding update); the build's wall time and ptxas's
     registers and spills per kernel;
  2. K1 against its plain PyTorch version in bf16: the two SDXL shapes,
     head dims 40/80/128, ragged Sq/Skv with a kv keep mask, zero q rows;
     max |do| and |dlse| against stated bounds, median times of both and
     of PyTorch's flash SDPA forward at the SDXL shapes, K1's share of its
     bound and its ratio to SDPA;
  3. K2 and K3 against their plain versions in bf16: the two SDXL shapes,
     head dims 40/80/128, ragged Sq/Skv with the kv keep mask, and 8192
     tokens at d=128 (the TPU's streaming dk/dv domain); max |ddq|,
     |ddk|, |ddv| and relative L2 against stated bounds, K3's delta
     pre-pass against its plain version, K3 bitwise equal across two runs,
     median times of the kernels, the plain versions and PyTorch's flash
     SDPA backward, K3's share of its bound and its ratio to SDPA;
  4. one full-width SDXL UNet forward (128x128 latent, CFG batch 2) with
     K1 and with plain attention: relative L2 difference of the outputs;
  5. full-width SDXL text-to-image through the family registry
     (1024x1024, DDIM, 4 steps, CFG 7, seeded random weights): K1 must be
     launched exactly 70 times per step; the image must be uint8
     1024x1024x3 and not constant;
  6. full-width SDXL LoRA training through the family registry (rank 16,
     alpha 16, batch 2 at 1024x1024 from a seeded image and prompt through
     the port's latent and text-embedding caches, tx_only gradient
     checkpointing, AdamW, clip 1.0): one warm-up step, then timed steps
     with exact launch counts per step (K1 140, K2 70, K3 70, K3's
     pre-pass 70); finite loss
     and grad norm, lora_up non-zero after the first step, one step's
     LoRA gradients with K1-K3 against plain attention (relative L2), and
     a torch.profiler split of one more step's device time by kernel class;
  7. K4 against its plain version, bitwise, at a feed-forward projection
     (1280x10240), the largest conv weight (1280x2560x3x3) and a size that
     needs padding; times of the first two against the byte bound;
  8. K5 bit for bit against its plain version on the same Philox bits
     (fp32 and bf16 u) at 2^20 + 3, 1,000,003 and the step's largest
     adapter (368,640) elements; then the properties of stochastic
     rounding at the first two sizes: every output one of the two bf16
     neighbours of p + u, exact where p + u is representable, mean error
     within 5 sigma of 0 and up-rounding rate within 5 sigma of 1/4 for
     p = 1, u = 2^-9, one seed one output and another seed another;
     median times;
  9. QLoRA: the training step of phase 6 on a UNet loaded in bf16 and
     quantized to NF4, with bf16 adapters and stochastic rounding: one
     warm-up and three timed steps with exact K1-K5 (and pre-pass)
     launch counts per step, the LoRA gradients with K4 against the plain dequant, and a
     torch.profiler split of one more step;
 10. the same step on an fp8 (e4m3) base with fp32 adapters at batch 4
     (the reference's bench.py headline stage): three timed steps, finite.
The last stdout line is one JSON object, {"ok": true, "device": {...}};
the line before it carries the kernel table as JSON.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# bounds, bf16 operands on both sides (the plain versions compute in fp32
# from the same bf16 inputs):
# - o: both round o to bf16 (relative 2^-9) and K1 rounds P to bf16 before
#   P.V; 2e-2 absolute is the reference package's own flash-test bound
# - lse: fp32 on both sides, only summation order and exp differ
O_BOUND = 2e-2
LSE_BOUND = 1e-3
# dq, dk, dv, each against its own scale: at the SDXL shapes max|dq|,
# |dk|, |dv| are only 0.2-0.3 (a typical element ~0.03), so an absolute
# bound would not catch a wrong kernel. Both sides round dS and P to bf16
# before their products and the results to bf16 (relative 2^-9); the
# kernels sum S, dP and the products in another order (mma.sync fp32
# fragments vs one fp32 matmul), so an element can round across one bf16
# step: up to 0.34% of max|ref| measured. Most elements round alike on
# both sides, so the relative L2 difference is small: 1.2e-4 to 2.9e-4
# measured over these cases on an H100. Bounds: max error 2% of max|ref|,
# relative L2 2e-3 over the tensor
DGRAD_MAX_REL = 2e-2
DGRAD_REL_L2 = 2e-3
# K3's delta pre-pass: fp32 sums of the same bf16 products on both sides,
# only the order of at most 128 terms differs
DELTA_MAX_REL = 1e-4
# UNet output, K1 vs plain attention: 70 attention outputs that differ by
# bf16 roundings, carried through a bf16 network of random weights
UNET_REL_L2_BOUND = 5e-2
# LoRA gradients of one training step, K1-K3 vs plain attention: the same
# bf16 attention roundings as DGRAD_REL_L2, through the forward and the
# backward of the network (2.1e-3 measured at full width)
GRAD_REL_L2_BOUND = 1e-2
# LoRA gradients of one QLoRA step, K4 vs the plain dequant: K4 is
# bitwise equal to it (phase k4), so only the step's own run-to-run noise
# remains (cuDNN and cuBLAS pick their algorithms per call)
QLORA_GRAD_REL_L2_BOUND = 1e-3
SELF_ATTN_PER_UNET_PASS = 70   # SDXL at a 128x128 latent: 10 at 4096, 60 at 1024 tokens
TRAIN_STEPS = 3                # timed steps after one warm-up step
# K4 cases: name, logical shape (the reference's kernel layout)
K4_CASES = [
    ("ff_1280x10240", (1280, 10240)),           # GEGLU projection of a 1280 block
    ("conv_3x3x2560x1280", (3, 3, 2560, 1280)),  # largest conv weight (29.5M)
    ("padded_1000x777", (1000, 777)),            # 777,000: both halves padded
]
K4_TIMED = ("ff_1280x10240", "conv_3x3x2560x1280")   # the UNet's shapes
K5_SIZES = ((1 << 20) + 3, 1_000_003)
# the step's largest bf16 adapter tensor: lora_down of a 2560->1280 3x3 conv
K5_LARGEST_ADAPTER_SHAPE = (16, 2560, 3, 3)
K5_LARGEST_ADAPTER = 16 * 2560 * 3 * 3

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# name, batch, sq, skv, heads, head dim, keep mask, first zero q row
K1_CASES = [
    ("sdxl_b2_s4096_h10_d64", 2, 4096, 4096, 10, 64, False, None),
    ("sdxl_b2_s1024_h20_d64", 2, 1024, 1024, 20, 64, False, None),
    ("d40_b2_s1024_h8", 2, 1024, 1024, 8, 40, False, None),
    ("d80_b2_s1024_h8", 2, 1024, 1024, 8, 80, False, None),
    ("d128_b1_s2048_h8", 1, 2048, 2048, 8, 128, False, None),
    ("ragged_keep_b2_sq1000_skv777_h4_d64", 2, 1000, 777, 4, 64, True, None),
    ("zero_q_rows_b2_s300_h4_d64", 2, 300, 300, 4, 64, False, 250),
]
# name, batch, sq, skv, heads, head dim, keep mask
K23_CASES = [
    ("sdxl_b2_s4096_h10_d64", 2, 4096, 4096, 10, 64, False),
    ("sdxl_b2_s1024_h20_d64", 2, 1024, 1024, 20, 64, False),
    ("d40_b2_s1024_h8", 2, 1024, 1024, 8, 40, False),
    ("d80_b2_s1024_h8", 2, 1024, 1024, 8, 80, False),
    ("d128_b1_s2048_h8", 1, 2048, 2048, 8, 128, False),
    ("ragged_keep_b2_sq1000_skv777_h4_d64", 2, 1000, 777, 4, 64, True),
    ("stream_b1_s8192_h8_d128", 1, 8192, 8192, 8, 128, False),
]
SDXL_SHAPES = ("sdxl_b2_s4096_h10_d64", "sdxl_b2_s1024_h20_d64")
# K2/K3 cases timed against SDPA's backward: the SDXL shapes and the
# streaming domain of the TPU's K3b
SDPA_BWD_CASES = SDXL_SHAPES + ("stream_b1_s8192_h8_d128",)


def _median_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, kernel: str, reps: int = 20) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    `kernel`, from torch.profiler over `reps` calls of `fn`, each after a
    write of 64 MB that evicts the 50 MB L2 cache (the step finds a
    layer's codes cold). Left out: the wrapper's host time, which an event
    pair around one short call would count. The profiler has returned no
    events for a session of 2.5 us kernels on an H100 now and then, so a
    session that sees another count than `reps` is run again, up to three
    times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and kernel in evt.key:
                total += getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
                count += evt.count
        if count == reps:
            return total / count / 1e3
        print(f"[profile] session {attempt + 1} saw {count} launches of {kernel}, "
              f"expected {reps}")
    raise AssertionError(f"profiler saw {count} launches of {kernel}, expected {reps}")


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: FLOPs at the bf16 tensor-core
    peak or bytes at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _attn_bounds(b, sq, skv, h, d) -> dict:
    """bound_ms of K1, K2, K3 at one shape: FLOPs 4/6/8 * B*H*Sq*Skv*d
    (the TPU kernels' cost estimates); bytes: each bf16 [B, S, H*d] input
    read once and output written once, lse fp32 [B, H, Sq]. K3's pre-pass
    reads o and dO and writes delta [B, H, Sq] fp32 (2 FLOPs per lane)."""
    q_bytes, kv_bytes, lse_bytes = 2 * b * sq * h * d, 2 * b * skv * h * d, 4 * b * h * sq
    work = b * h * sq * skv * d
    return {
        "K1": _bound_ms(4 * work, 2 * q_bytes + 2 * kv_bytes + lse_bytes),
        "K2": _bound_ms(6 * work, 4 * q_bytes + 2 * kv_bytes + lse_bytes),
        "K3": _bound_ms(8 * work, 3 * q_bytes + 4 * kv_bytes + lse_bytes),
        "delta": _bound_ms(2 * b * sq * h * d, 2 * q_bytes + lse_bytes),
    }


def _heads4(t, h):
    """[B, S, H*d] -> a [B, H, S, d] view (what SDPA takes)."""
    b, s, inner = t.shape
    return t.view(b, s, h, inner // h).transpose(1, 2)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_build():
    from onetrainer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] K1-K5 library {os.path.relpath(path, REPO)} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                print(f"[build] {line.strip()}")


def _rand_case(torch, gen, b, sq, skv, h, d, with_keep):
    def rand(s):
        return torch.randn((b, s, h * d), generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
    q, k, v = rand(sq), rand(skv), rand(skv)
    keep = None
    if with_keep:
        keep = torch.ones((b, skv), dtype=torch.bool, device="cuda")
        keep[:, 700:] = False      # text-padding style tail
        keep[0, :64] = False       # a fully masked leading kv tile
        keep[1, 300:340] = False   # a hole
    return q, k, v, keep


def phase_k1_cases(torch) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    from onetrainer_tpu_torch.ops import flash_folded as ff
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for name, b, sq, skv, h, d, with_keep, zero_from in K1_CASES:
        q, k, v, keep = _rand_case(torch, gen, b, sq, skv, h, d, with_keep)
        if zero_from is not None:
            q[:, zero_from:] = 0
        scale = 1.0 / d ** 0.5
        o, lse = ff.flash_attention_folded_fwd(q, k, v, h, sm_scale=scale, kv_keep=keep)
        o_ref, lse_ref = ff.flash_attention_folded_reference(
            q, k, v, h, sm_scale=scale, kv_keep=keep)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        ms = _median_ms(torch, lambda: ff.flash_attention_folded_fwd(
            q, k, v, h, sm_scale=scale, kv_keep=keep))
        plain_ms = _median_ms(torch, lambda: ff.flash_attention_folded_reference(
            q, k, v, h, sm_scale=scale, kv_keep=keep))
        library_ms = None
        if name in SDXL_SHAPES:
            q4, k4, v4 = (_heads4(t, h) for t in (q, k, v))

            def sdpa():
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            library_ms = _median_ms(torch, sdpa)
        ok = finite and err_o <= O_BOUND and err_lse <= LSE_BOUND
        bound_ms, bound_by = _attn_bounds(b, sq, skv, h, d)["K1"]
        results[name] = dict(err_o=err_o, err_lse=err_lse, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms)
        lib = "" if library_ms is None else \
            f" SDPA flash fwd {library_ms:.4f} ms (K1 / SDPA {ms / library_ms:.3f})"
        print(f"[k1] {name}: max|do|={err_o:.3e} (bound {O_BOUND:g}) "
              f"max|dlse|={err_lse:.3e} (bound {LSE_BOUND:g}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib} "
              f"(least time {bound_ms:.4f} ms, {bound_by}; {100 * bound_ms / ms:.1f}% "
              f"of it) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 case {name} disagrees with the plain version")
    return results


def phase_k23_cases(torch) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    import torch.nn.functional as F

    from onetrainer_tpu_torch.ops import flash_folded as ff
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for name, b, sq, skv, h, d, with_keep in K23_CASES:
        q, k, v, keep = _rand_case(torch, gen, b, sq, skv, h, d, with_keep)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1.0 / d ** 0.5
        o, lse = ff.flash_attention_folded_fwd(q, k, v, h, sm_scale=scale, kv_keep=keep)
        args = (q, k, v, o, lse, do, h)
        kw = dict(sm_scale=scale, kv_keep=keep)
        dq = ff.flash_attention_folded_dq(*args, **kw)
        dk, dv = ff.flash_attention_folded_dkv(*args, **kw)
        dk2, dv2 = ff.flash_attention_folded_dkv(*args, **kw)
        delta = ff.flash_attention_folded_delta(o, do, h)
        dq_ref = ff.flash_attention_folded_dq_reference(*args, **kw)
        dk_ref, dv_ref = ff.flash_attention_folded_dkv_reference(*args, **kw)
        delta_ref = ff.flash_attention_folded_delta_reference(o, do, h)
        torch.cuda.synchronize()
        deterministic = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
        err_delta = (delta - delta_ref).abs().max().item()
        delta_scale = delta_ref.abs().max().item()
        del dk2, dv2
        errs, scales, rels = {}, {}, {}
        for n, a, r in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            diff = a.float() - r.float()
            errs[n] = diff.abs().max().item()
            scales[n] = r.float().abs().max().item()
            rels[n] = (diff.norm() / r.float().norm()).item()
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
        del dq_ref, dk_ref, dv_ref
        k2_ms = _median_ms(torch, lambda: ff.flash_attention_folded_dq(*args, **kw))
        k3_ms = _median_ms(torch, lambda: ff.flash_attention_folded_dkv(*args, **kw))
        delta_ms = _median_ms(torch, lambda: ff.flash_attention_folded_delta(o, do, h))
        plain_delta_ms = _median_ms(
            torch, lambda: ff.flash_attention_folded_delta_reference(o, do, h), reps=5)
        plain_dq_ms = _median_ms(torch, lambda: ff.flash_attention_folded_dq_reference(
            *args, **kw), reps=5)
        plain_dkv_ms = _median_ms(torch, lambda: ff.flash_attention_folded_dkv_reference(
            *args, **kw), reps=5)
        library_ms = None
        if name in SDPA_BWD_CASES:
            q4, k4, v4 = (_heads4(t, h).detach().requires_grad_() for t in (q, k, v))
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            do4 = _heads4(do, h)
            library_ms = _median_ms(torch, lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True))
        ok = finite and all(errs[n] <= DGRAD_MAX_REL * scales[n]
                            and rels[n] <= DGRAD_REL_L2 for n in errs)
        ok = ok and deterministic and err_delta <= DELTA_MAX_REL * delta_scale
        results[name] = dict(errs=errs, k2_ms=k2_ms, k3_ms=k3_ms,
                             plain_dq_ms=plain_dq_ms, plain_dkv_ms=plain_dkv_ms,
                             library_ms=library_ms, err_delta=err_delta,
                             delta_ms=delta_ms, plain_delta_ms=plain_delta_ms)
        lib = "" if library_ms is None else \
            f" SDPA flash bwd (dq+dk+dv) {library_ms:.4f} ms (K3 / SDPA " \
            f"{k3_ms / library_ms:.3f})"
        bounds = _attn_bounds(b, sq, skv, h, d)
        print(f"[k23] {name}: " + " ".join(
                  f"max|d{n}|={errs[n]:.3e} (bound {DGRAD_MAX_REL:g} x max|{n}| "
                  f"{scales[n]:.3e}) rel L2 {rels[n]:.3e} (bound {DGRAD_REL_L2:g})"
                  for n in errs) + " "
              f"K2 {k2_ms:.4f} ms (plain {plain_dq_ms:.4f} ms, least time "
              f"{bounds['K2'][0]:.4f} ms, {bounds['K2'][1]}) "
              f"K3 {k3_ms:.4f} ms with its pre-pass (plain {plain_dkv_ms:.4f} ms, "
              f"least time {bounds['K3'][0]:.4f} ms, {bounds['K3'][1]}; "
              f"{100 * bounds['K3'][0] / k3_ms:.1f}% of it){lib}; "
              f"pre-pass max|ddelta|={err_delta:.3e} (bound {DELTA_MAX_REL:g} x "
              f"max|delta| {delta_scale:.3e}) {delta_ms:.4f} ms (plain "
              f"{plain_delta_ms:.4f} ms, least time {bounds['delta'][0]:.4f} ms, "
              f"{bounds['delta'][1]}); K3 bitwise equal across two runs "
              f"{deterministic} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2/K3 case {name} disagrees with the plain versions")
    return results


def _k4_bound(n_half: int, out_bytes: int) -> tuple[float, str]:
    """K4 moves n_half code bytes, n_half / 32 fp32 scales and 2 * n_half
    outputs; one multiply per output."""
    return _bound_ms(0.0, n_half + 4 * (n_half // 32) + out_bytes * 2 * n_half)


def phase_k4(torch) -> dict:
    from onetrainer_tpu_torch.ops import nf4
    from onetrainer_tpu_torch.ops.quant import quantize_nf4
    gen = torch.Generator(device="cuda").manual_seed(44)
    results = {}
    for name, shape in K4_CASES:
        w = torch.randn(shape, generator=gen, device="cuda") * 0.02
        q = quantize_nf4(w)
        n_half = q.q.numel()
        ok, err = True, 0.0
        for dtype in (torch.bfloat16, torch.float32):
            out = nf4.nf4_dequant_flat(q.q, q.scales, dtype)
            ref = nf4.nf4_dequant_reference(q.q, q.scales, dtype)
            torch.cuda.synchronize()
            int_view = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = bool(torch.equal(out.view(int_view), ref.view(int_view)))
            ok = ok and same
            err = max(err, (out.float() - ref.float()).abs().max().item())
            print(f"[k4] {name} {tuple(shape)} -> {dtype}: bitwise equal {same}")
        if not ok:
            raise AssertionError(f"K4 case {name} differs from the plain version")
        if name not in K4_TIMED:
            results[name] = dict(n=w.numel(), max_abs_err=err)
            continue
        ms = _device_ms(torch, lambda: nf4.nf4_dequant_flat(q.q, q.scales, torch.bfloat16),
                        "nf4_dequant_kernel")
        call_ms = _median_ms(torch, lambda: nf4.nf4_dequant_flat(q.q, q.scales, torch.bfloat16))
        plain_ms = _median_ms(torch, lambda: nf4.nf4_dequant_reference(
            q.q, q.scales, torch.bfloat16), reps=5)
        bound_ms, bound_by = _k4_bound(n_half, 2)
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, n=w.numel(), max_abs_err=err)
        print(f"[k4] {name}: {w.numel()} elements, kernel {ms:.4f} ms of device time "
              f"({call_ms:.4f} ms per call with the wrapper, events), plain "
              f"{plain_ms:.4f} ms, least time {bound_ms:.4f} ms ({bound_by}, "
              f"{n_half * 2.5625 / 1e6:.1f} MB), no single PyTorch call ok")
    return results


def _bf16_neighbours(torch, s):
    """(lower, upper) bf16 neighbours of fp32 s by magnitude, as int32 bit
    patterns of fp32: s truncated to bf16, and one bf16 step beyond."""
    bits = s.view(torch.int32)
    low = bits & ~0xFFFF
    return low, low + 0x10000


def phase_k5(torch) -> dict:
    from onetrainer_tpu_torch.ops.sr_update import sr_update
    from onetrainer_tpu_torch.ops.stochastic import philox_bits, stochastic_round_to_bf16
    gen = torch.Generator(device="cuda").manual_seed(55)
    # a seed with both 32-bit halves set and the sign bit: the key layout
    seed_a = torch.tensor([-0x123456789ABCDEF], dtype=torch.int64, device="cuda")
    seed_b = torch.tensor([1235], dtype=torch.int64, device="cuda")

    def plain(p, u, seed):
        return stochastic_round_to_bf16(
            p.float() + u.float(), philox_bits(seed, p.numel(), p.device).view(p.shape))

    ok, max_err = True, 0.0
    # bit for bit against the plain rounding on the kernel's Philox bits,
    # fp32 and bf16 u, at the stated sizes and the step's largest adapter
    for n in K5_SIZES + (K5_LARGEST_ADAPTER,):
        p = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
        u32 = torch.randn(n, generator=gen, device="cuda") * 1e-3
        for u in (u32, u32.to(torch.bfloat16)):
            out, ref = sr_update(p, u, seed_a), plain(p, u, seed_a)
            torch.cuda.synchronize()
            same = bool(torch.equal(out.view(torch.int16), ref.view(torch.int16)))
            max_err = max(max_err, (out.float() - ref.float()).abs().max().item())
            ok = ok and same
            print(f"[k5] n={n}, {u.dtype} u: bitwise equal to the plain rounding on "
                  f"Philox bits {same}")
    for n in K5_SIZES:
        p = (torch.randn(n, generator=gen, device="cuda")).to(torch.bfloat16)
        u = torch.randn(n, generator=gen, device="cuda") * 1e-3
        u[: n // 4] = 0.0          # p + u representable: exact
        s = p.float() + u
        out = sr_update(p, u, seed_a)
        low, high = _bf16_neighbours(torch, s)
        got = out.float().view(torch.int32)
        neighbour = bool(((got == low) | (got == high)).all())
        exact = bool(torch.equal(out[: n // 4], p[: n // 4]))
        same = bool(torch.equal(sr_update(p, u, seed_a), out))
        other = not bool(torch.equal(sr_update(p, u, seed_b), out))
        # p = 1, u = 2^-9: one bf16 step is 2^-7, so up with probability 1/4
        ones = torch.ones(n, dtype=torch.bfloat16, device="cuda")
        quarter = torch.full((n,), 2.0 ** -9, device="cuda")
        r = sr_update(ones, quarter, seed_a).float()
        err = r - (1.0 + 2.0 ** -9)
        mean, sigma = err.mean().item(), (3.0 ** 0.5) * 2.0 ** -9 / n ** 0.5
        up = (r > 1.0).float().mean().item()
        up_sigma = (0.25 * 0.75 / n) ** 0.5
        unbiased = abs(mean) <= 5 * sigma and abs(up - 0.25) <= 5 * up_sigma
        torch.cuda.synchronize()
        case_ok = neighbour and exact and same and other and unbiased
        ok = ok and case_ok
        print(f"[k5] n={n}: neighbours {neighbour}, exact where representable "
              f"{exact}, same seed same output {same}, other seed other output "
              f"{other}; p=1 u=2^-9: mean error {mean:.3e} (5 sigma {5 * sigma:.3e}), "
              f"up rate {up:.5f} (1/4 +- {5 * up_sigma:.5f}) {'ok' if case_ok else 'FAIL'}")
    n = K5_SIZES[0]
    p = torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
    u32 = torch.randn(n, generator=gen, device="cuda") * 1e-3
    ms_fp32_u = _device_ms(torch, lambda: sr_update(p, u32, seed_a), "sr_update_kernel")
    bound_fp32_u = _bound_ms(0.0, 8 * n)
    plain_fp32_u = _median_ms(torch, lambda: plain(p, u32, 1234), reps=5)
    print(f"[k5] n={n}, fp32 u: kernel {ms_fp32_u:.4f} ms of device time, plain "
          f"{plain_fp32_u:.4f} ms, "
          f"least time {bound_fp32_u[0]:.4f} ms (bytes, 8 per element)")
    shape = K5_LARGEST_ADAPTER_SHAPE
    p = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    u = (torch.randn(shape, generator=gen, device="cuda") * 1e-4).to(torch.bfloat16)
    ms = _device_ms(torch, lambda: sr_update(p, u, seed_a, out=p), "sr_update_kernel")
    call_ms = _median_ms(torch, lambda: sr_update(p, u, seed_a, out=p))
    plain_ms = _median_ms(torch, lambda: p.copy_(plain(p, u, 1234)), reps=5)
    bound_ms, bound_by = _bound_ms(0.0, 6 * p.numel())
    print(f"[k5] step's largest adapter {shape} ({p.numel()} elements), bf16 u: "
          f"kernel {ms:.4f} ms of device time ({call_ms:.4f} ms per call with the "
          f"wrapper, events), plain {plain_ms:.4f} ms, least time {bound_ms:.4f} ms "
          f"({bound_by}, 6 bytes per element), no single PyTorch call "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K5 differs from the plain rounding or fails a property "
                             "of stochastic rounding")
    print(f"[k5] max |K5 - plain| {max_err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max_err, shape=shape, ms_fp32_u=ms_fp32_u, plain_fp32_u=plain_fp32_u,
                bound_fp32_u=bound_fp32_u[0])


def _plain_attention(ff):
    def plain(q, k, v, num_heads, *, sm_scale, kv_keep=None):
        return ff.flash_attention_folded_reference(
            q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)[0]
    return plain


def build_model(torch, unet_weight_dtype=None):
    from onetrainer_tpu_torch.io.weights import init_sdxl_weights
    from onetrainer_tpu_torch.models.sdxl import create_sdxl_model
    from onetrainer_tpu_torch.util.enums import ModelType
    unet_weight_dtype = unet_weight_dtype or torch.float32
    t0 = time.perf_counter()
    # checkpointing acts only where autograd records: the inference phases
    # run the plain forward, the training phase recomputes per tx_only
    model = create_sdxl_model(ModelType.STABLE_DIFFUSION_XL_10_BASE,
                              dtype=torch.bfloat16, gradient_checkpointing=True,
                              remat_policy="tx_only", device="meta",
                              unet_weight_dtype=unet_weight_dtype)
    init_sdxl_weights(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for m in model.modules().values() for p in m.parameters())
    print(f"[model] SDXL base, {n} params (UNet {unet_weight_dtype}, the rest "
          f"fp32, compute bf16), seeded weights on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return model


def phase_unet(torch, model):
    from onetrainer_tpu_torch.ops import flash_folded as ff
    gen = torch.Generator(device="cuda").manual_seed(7)
    sample = torch.randn((2, 128, 128, 4), generator=gen, device="cuda")
    context = torch.randn((2, 77, 2048), generator=gen, device="cuda")
    pooled = torch.randn((2, 1280), generator=gen, device="cuda")
    ts = torch.full((2,), 500, dtype=torch.int32, device="cuda")
    time_ids = torch.tensor([[1024, 1024, 0, 0, 1024, 1024]] * 2,
                            dtype=torch.float32, device="cuda")

    def forward():
        with torch.inference_mode():
            out = model.unet(sample, ts, context, pooled, time_ids)
        torch.cuda.synchronize()
        return out

    forward()   # warm-up (cuDNN/cuBLAS handles, allocator)
    before = ff.flash_attention_folded_fwd.launches
    t0 = time.perf_counter()
    out_k1 = forward()
    k1_s = time.perf_counter() - t0
    launches = ff.flash_attention_folded_fwd.launches - before
    kernel_fn = ff.flash_attention_folded
    ff.flash_attention_folded = _plain_attention(ff)
    try:
        forward()
        t0 = time.perf_counter()
        out_plain = forward()
        plain_s = time.perf_counter() - t0
    finally:
        ff.flash_attention_folded = kernel_fn
    rel = ((out_k1 - out_plain).norm() / out_plain.norm()).item()
    finite = bool(torch.isfinite(out_k1).all() and torch.isfinite(out_plain).all())
    ok = (finite and rel <= UNET_REL_L2_BOUND
          and launches == SELF_ATTN_PER_UNET_PASS
          and tuple(out_k1.shape) == (2, 128, 128, 4))
    print(f"[unet] full-width SDXL UNet forward, latent 2x128x128x4: "
          f"K1 {k1_s * 1e3:.2f} ms ({launches} K1 launches), plain attention "
          f"{plain_s * 1e3:.2f} ms, rel L2 {rel:.3e} (bound {UNET_REL_L2_BOUND:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("UNet with K1 disagrees with plain attention")


def _kernel_wrappers() -> dict:
    from onetrainer_tpu_torch.ops import flash_folded as ff
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_flat
    from onetrainer_tpu_torch.ops.sr_update import sr_update
    return {"K1": ff.flash_attention_folded_fwd, "K2": ff.flash_attention_folded_dq,
            "K3": ff.flash_attention_folded_dkv, "K3pre": ff.flash_attention_folded_delta,
            "K4": nf4_dequant_flat, "K5": sr_update}


def _reset_launch_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _launch_counts() -> dict:
    return {tag: fn.launches for tag, fn in _kernel_wrappers().items()}


def phase_sample(torch, model) -> dict:
    from onetrainer_tpu_torch.config.sample_config import SampleConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.ops import flash_folded as ff
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import ModelType, NoiseScheduler, TrainingMethod

    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = TrainingMethod.FINE_TUNE
    family = get_family(config.model_type)
    setup = family.create_setup(model, config, 1)

    sc = SampleConfig.default_values()
    sc.prompt = "a photograph of an astronaut riding a horse"
    sc.negative_prompt = ""
    sc.height = sc.width = 1024
    sc.diffusion_steps = 4
    sc.cfg_scale = 7.0
    sc.seed = 42
    sc.noise_scheduler = NoiseScheduler.DDIM

    stamps = []

    def on_progress(step, total):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    out = family.sample(setup, sc, on_progress)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    expected = SELF_ATTN_PER_UNET_PASS * sc.diffusion_steps
    image = out.image
    # NaN latents would decode to a constant image, so it must vary
    ok = (launches == {"K1": expected, "K2": 0, "K3": 0, "K3pre": 0, "K4": 0, "K5": 0}
          and image.dtype.name == "uint8"
          and image.shape == (1024, 1024, 3) and image.std() > 0)
    print(f"[sample] SDXL 1024x1024 DDIM {sc.diffusion_steps} steps CFG "
          f"{sc.cfg_scale:g}: total {total_s:.3f} s, UNet step median "
          f"{statistics.median(step_ms):.2f} ms (steps 2..{sc.diffusion_steps}: "
          f"{', '.join(f'{t:.2f}' for t in step_ms)} ms), peak "
          f"max_memory_allocated {peak_gib:.2f} GiB, K1 launches {launches['K1']} "
          f"(expected {expected}), image {image.shape} {image.dtype} "
          f"mean {image.mean():.2f} std {image.std():.2f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("text-to-image run failed its checks")
    return launches


def _train_batch(torch, family, setup, batch_size: int) -> dict:
    """A 1024x1024 batch through the port's caches: a seeded image through
    the VAE encoder and a prompt through both text encoders, tiled."""
    encode_images, encode_text = family.make_encode_fns(setup)
    gen = torch.Generator(device="cuda").manual_seed(11)
    image = torch.rand((1, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    latents = encode_images(image)
    text = encode_text("a photograph of an astronaut riding a horse")

    def tile(t):
        return t.expand(batch_size, *t.shape[1:]).contiguous()
    return {
        "latent_image": tile(latents["latent_image"]),
        "latent_logvar": tile(latents["latent_logvar"]),
        "text_encoder_hidden_state": tile(text["text_encoder_hidden_state"][None]),
        "text_encoder_2_hidden_state": tile(text["text_encoder_2_hidden_state"][None]),
        "text_encoder_2_pooled_state": tile(text["text_encoder_2_pooled_state"][None]),
        "original_resolution": torch.full((batch_size, 2), 1024, device="cuda"),
        "crop_offset": torch.zeros((batch_size, 2), device="cuda"),
        "crop_resolution": torch.full((batch_size, 2), 1024, device="cuda"),
        "loss_weight": torch.ones((batch_size,), device="cuda"),
    }


def _lora_grads(torch, setup, batch, timestep, noise, latent_noise):
    """The LoRA gradients of one step's loss at fixed randomness, without
    the update (the step's own forward and backward)."""
    from onetrainer_tpu_torch.math.losses import diffusion_losses
    from onetrainer_tpu_torch.train.sdxl_train_step import (
        _coefficients_on, sdxl_predict,
    )
    from onetrainer_tpu_torch.train.train_state import param_groups
    coefficients = _coefficients_on(setup.model, torch.device("cuda"))
    flat = [t for g in param_groups(setup.state.params).values() for t in g]
    data = sdxl_predict(setup.model, batch, None, setup.step_cfg, coefficients,
                        timestep=timestep, noise=noise, latent_noise=latent_noise)
    loss = diffusion_losses(batch, data, setup.step_cfg.loss, coefficients).mean()
    return torch.cat([g.flatten() for g in torch.autograd.grad(loss, flat)])


def _lora_config(batch_size: int):
    """bench.py's SDXL stage as a training config: LoRA r16 a16 on the
    UNet, AdamW lr 1e-4, clip 1.0, text encoders frozen (cached text)."""
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.util.enums import ModelType, TrainingMethod
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = TrainingMethod.LORA
    config.lora_rank = 16
    config.lora_alpha = 16.0
    config.batch_size = batch_size
    config.learning_rate = 1e-4
    config.learning_rate_warmup_steps = 0.0
    config.clip_grad_norm = 1.0
    config.text_encoder.train = False
    config.text_encoder_2.train = False
    return config


def _finite(values) -> bool:
    return all(x == x and abs(x) != float("inf") for x in values)


def _setup_and_steps(torch, model, config, tag: str) -> dict:
    """Setup through the family registry, the cached batch, one warm-up
    step, then TRAIN_STEPS timed steps with every launch count zeroed just
    before them and read just after."""
    from onetrainer_tpu_torch.setup.families import get_family
    family = get_family(config.model_type)
    t0 = time.perf_counter()
    setup = family.create_setup(model, config, 100)
    batch = _train_batch(torch, family, setup, config.batch_size)
    torch.cuda.synchronize()
    adapters = setup.state.params["unet_lora"]
    n_lora = sum(t.numel() for e in adapters.values() for t in e.values())
    dtype = next(iter(adapters.values()))["lora_up"].dtype
    print(f"[{tag}] LoRA r{config.lora_rank} a{config.lora_alpha:g} ({dtype}) on "
          f"{len(adapters)} UNet layers ({n_lora} params), batch {config.batch_size} "
          f"at 1024x1024 cached through the VAE encoder and both text encoders, "
          f"set up in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    metrics = setup.train_step(setup.state, batch, gen)
    first = [metrics["loss"].item(), metrics["grad_norm"].item()]
    warm_s = time.perf_counter() - t0
    up_max = max(e["lora_up"].abs().max().item() for e in adapters.values())
    print(f"[{tag}] warm-up step {warm_s:.3f} s: loss {first[0]:.6f} grad_norm "
          f"{first[1]:.6f}, max |lora_up| after it {up_max:.3e}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    step_s, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = setup.train_step(setup.state, batch, gen)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        step_s.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(step_s)
    print(f"[{tag}] {TRAIN_STEPS} timed steps: sec/step median {med:.4f} "
          f"(min {min(step_s):.4f}, max {max(step_s):.4f}; "
          f"{', '.join(f'{x:.4f}' for x in step_s)}), images/s "
          f"{config.batch_size / med:.3f}, peak max_memory_allocated {peak_gib:.2f} GiB, "
          f"losses {', '.join(f'{x:.6f}' for x in losses)}, grad_norms "
          f"{', '.join(f'{x:.6f}' for x in norms)}, launches {launches}")
    return dict(setup=setup, batch=batch, gen=gen, launches=launches, sec_per_step=med,
                peak_gib=peak_gib, finite=_finite(first + losses + norms), up_max=up_max)


def _fixed_draws(torch, batch):
    gen = torch.Generator(device="cuda").manual_seed(9)
    b = batch["latent_image"].shape[0]
    timestep = torch.tensor([250, 750] * (b // 2), dtype=torch.int32, device="cuda")
    noise = torch.randn(batch["latent_image"].shape, generator=gen, device="cuda")
    latent_noise = torch.randn(batch["latent_image"].shape, generator=gen, device="cuda")
    return timestep, noise, latent_noise


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_train(torch, model) -> dict:
    from onetrainer_tpu_torch.ops import flash_folded as ff
    run = _setup_and_steps(torch, model, _lora_config(2), "train")
    n = TRAIN_STEPS * SELF_ATTN_PER_UNET_PASS
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n, "K4": 0, "K5": 0}

    # one step's gradients with K1-K3 against plain attention, at fixed
    # timesteps and noise
    setup, batch = run["setup"], run["batch"]
    draws = _fixed_draws(torch, batch)
    g_kernel = _lora_grads(torch, setup, batch, *draws)
    kernel_fn = ff.flash_attention_folded
    ff.flash_attention_folded = _plain_attention(ff)
    try:
        g_plain = _lora_grads(torch, setup, batch, *draws)
    finally:
        ff.flash_attention_folded = kernel_fn
    rel = _rel_l2(g_kernel, g_plain)
    grads_finite = bool(torch.isfinite(g_kernel).all() and torch.isfinite(g_plain).all())
    print(f"[train] LoRA gradients, K1-K3 vs plain attention: rel L2 {rel:.3e} "
          f"(bound {GRAD_REL_L2_BOUND:g}) over {g_kernel.numel()} values")
    ok = (run["finite"] and grads_finite and run["up_max"] > 0
          and run["launches"] == expected and rel <= GRAD_REL_L2_BOUND)
    print(f"[train] launches {run['launches']} (expected {expected}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("LoRA training run failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "train")
    return {"launches": run["launches"], "steps": TRAIN_STEPS,
            "sec_per_step": run["sec_per_step"]}


def _quantized_layers(torch, unet) -> tuple[int, int]:
    """(quantized layers of the UNet, those inside a transformer block,
    which tx_only checkpointing runs a second time in the backward)."""
    from onetrainer_tpu_torch.models.unet import BasicTransformerBlock
    from onetrainer_tpu_torch.ops.quant import is_quantized

    def count(module):
        return sum(is_quantized(getattr(m, "weight", None)) for m in module.modules())
    in_blocks = sum(count(m) for m in unet.modules() if isinstance(m, BasicTransformerBlock))
    return count(unet), in_blocks


def phase_qlora(torch) -> dict:
    from onetrainer_tpu_torch.ops import quant
    from onetrainer_tpu_torch.ops.nf4 import nf4_dequant_reference
    from onetrainer_tpu_torch.util.enums import DataType
    config = _lora_config(2)
    config.unet.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    model = build_model(torch, config.weight_dtypes().unet.to_load_dtype())
    run = _setup_and_steps(torch, model, config, "qlora")
    setup, batch = run["setup"], run["batch"]
    n_quant, n_in_blocks = _quantized_layers(torch, model.unet)
    n_tensors = sum(len(e) for e in setup.state.params["unet_lora"].values())
    nf4_bytes = sum(w.q.numel() + 4 * w.scales.numel() for m in model.unet.modules()
                    if quant.is_quantized(w := getattr(m, "weight", None)))
    n = TRAIN_STEPS * SELF_ATTN_PER_UNET_PASS
    expected = {"K1": 2 * n, "K2": n, "K3": n, "K3pre": n,
                "K4": TRAIN_STEPS * (n_quant + n_in_blocks), "K5": TRAIN_STEPS * n_tensors}
    print(f"[qlora] UNet NF4: {n_quant} quantized layers ({n_in_blocks} inside "
          f"transformer blocks), {nf4_bytes / 2 ** 30:.3f} GiB of codes and scales; "
          f"{n_tensors} bf16 adapter tensors; per step K1 {2 * SELF_ATTN_PER_UNET_PASS}, "
          f"K2 {SELF_ATTN_PER_UNET_PASS}, K3 {SELF_ATTN_PER_UNET_PASS}, "
          f"K3's pre-pass {SELF_ATTN_PER_UNET_PASS}, "
          f"K4 {n_quant + n_in_blocks}, K5 {n_tensors} launches expected")

    # one step's LoRA gradients with K4 against the plain dequant
    draws = _fixed_draws(torch, batch)
    g_kernel = _lora_grads(torch, setup, batch, *draws)
    g_again = _lora_grads(torch, setup, batch, *draws)
    kernel_fn = quant.nf4_dequant_flat
    quant.nf4_dequant_flat = nf4_dequant_reference
    try:
        g_plain = _lora_grads(torch, setup, batch, *draws)
    finally:
        quant.nf4_dequant_flat = kernel_fn
    rel, noise = _rel_l2(g_kernel, g_plain), _rel_l2(g_again, g_kernel)
    grads_finite = bool(torch.isfinite(g_kernel.float()).all())
    print(f"[qlora] LoRA gradients, K4 vs plain dequant: rel L2 {rel:.3e} (bound "
          f"{QLORA_GRAD_REL_L2_BOUND:g}; K4 against itself {noise:.3e}) over "
          f"{g_kernel.numel()} values")
    ok = (run["finite"] and grads_finite and run["up_max"] > 0
          and run["launches"] == expected and rel <= QLORA_GRAD_REL_L2_BOUND)
    print(f"[qlora] launches {run['launches']} (expected {expected}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("QLoRA training run failed its checks")
    profile_train_step(torch, setup, batch, run["gen"], "qlora")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


def phase_fp8(torch) -> dict:
    from onetrainer_tpu_torch.util.enums import DataType
    config = _lora_config(4)
    config.unet.weight_dtype = DataType.FLOAT_8
    model = build_model(torch, config.weight_dtypes().unet.to_load_dtype())
    run = _setup_and_steps(torch, model, config, "fp8")
    ok = run["finite"] and run["up_max"] > 0 and run["launches"]["K4"] == 0
    print(f"[fp8] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fp8-base training run failed its checks")
    return {"launches": run["launches"], "sec_per_step": run["sec_per_step"],
            "peak_gib": run["peak_gib"]}


_PROFILE_CLASSES = (
    ("K1 flash_fwd", ("flash_fwd_kernel",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K3 flash_bwd_dkv pre-pass (delta)", ("flash_bwd_delta_kernel",)),
    ("K4 nf4_dequant", ("nf4_dequant_kernel",)),
    ("K5 sr_update", ("sr_update_kernel",)),
    ("cuBLAS GEMMs", ("gemm", "Gemm", "nvjet", "sm90_xmma", "cutlass", "ampere_",
                      "sm80_")),
    ("cuDNN convolutions", ("conv", "Conv", "cudnn", "nchwToNhwc", "nhwcToNchw",
                            "implicit_", "dgrad", "wgrad")),
    ("norms", ("norm", "Norm", "welford", "Welford")),
    # "copy" only: "cast" would also match gpu_kernel_impl_nocast, the
    # launcher of every plain elementwise kernel
    ("dtype copies/casts", ("copy", "Copy")),
    ("optimizer (foreach)", ("multi_tensor", "foreach", "Foreach")),
    ("reductions", ("reduce", "Reduce")),
)


def _classify(name: str) -> str:
    for label, keys in _PROFILE_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other elementwise"


def profile_train_step(torch, setup, batch, gen, tag: str):
    """torch.profiler over one training step (after the timed ones): the
    device time per kernel class and the device's busy share of the step's
    host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        setup.train_step(setup.state, batch, gen)["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sums: dict = {}
    counts: dict = {}
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue   # kernels only: an op's row repeats its kernels' time
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if not dev_us:
            continue
        label = _classify(evt.key)
        sums[label] = sums.get(label, 0.0) + dev_us / 1e3
        counts[label] = counts.get(label, 0) + evt.count
        kernels.append((dev_us / 1e3, evt.count, label, evt.key))
    total = sum(sums.values())
    print(f"[profile] one {tag} step under torch.profiler: host {wall_ms:.3f} ms, "
          f"device time {total:.3f} ms in {sum(counts.values())} launches "
          f"({100 * total / wall_ms:.1f}% busy)")
    for label, ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: {ms:.3f} ms in {counts[label]} launches "
              f"({100 * ms / total:.1f}%)")
    for ms, count, label, key in sorted(kernels, reverse=True)[:15]:
        print(f"[profile] kernel {ms:.3f} ms in {count} launches [{label}]: {key[:110]}")
    if total == 0:
        raise AssertionError("the profiler saw no device time")


def _kernel_table(k1, k23, k4, k5, launches: dict) -> dict:
    """One row per kernel: `launches` from the path that runs it (K1-K3
    the fp32-base LoRA step, K4-K5 the QLoRA step), the time at that
    path's shape, and the counts of every path."""
    head = "sdxl_b2_s4096_h10_d64"
    bounds = _attn_bounds(2, 4096, 4096, 10, 64)
    ff = K4_CASES[0][0]
    rows = [
        ("flash_attention_folded_fwd (K1)", "K1", "flash_fwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:93", "train",
         max(c["err_o"] for c in k1.values()), k1[head]["ms"], k1[head]["plain_ms"],
         *bounds["K1"], k1[head]["library_ms"], head),
        ("flash_attention_folded_dq (K2)", "K2", "flash_bwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:196", "train",
         max(c["errs"]["dq"] for c in k23.values()), k23[head]["k2_ms"],
         k23[head]["plain_dq_ms"], *bounds["K2"], k23[head]["library_ms"], head),
        ("flash_attention_folded_dkv (K3, its pre-pass included)", "K3", "flash_bwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:248", "train",
         max(max(c["errs"]["dk"], c["errs"]["dv"]) for c in k23.values()),
         k23[head]["k3_ms"], k23[head]["plain_dkv_ms"], *bounds["K3"],
         k23[head]["library_ms"], head),
        ("flash_attention_folded_delta (K3's pre-pass)", "K3pre", "flash_bwd.cu",
         "onetrainer_tpu/ops/flash_folded.py:276", "train",
         max(c["err_delta"] for c in k23.values()), k23[head]["delta_ms"],
         k23[head]["plain_delta_ms"], *bounds["delta"], None, head),
        ("nf4_dequant_flat (K4)", "K4", "nf4_dequant.cu",
         "onetrainer_tpu/ops/nf4_pallas.py:41", "qlora",
         max(c["max_abs_err"] for c in k4.values()), k4[ff]["ms"],
         k4[ff]["plain_ms"], k4[ff]["bound_ms"], k4[ff]["bound_by"], None, ff),
        ("sr_update (K5)", "K5", "sr_update.cu",
         "onetrainer_tpu/ops/pallas_sr.py:26", "qlora", k5["max_abs_err"], k5["ms"],
         k5["plain_ms"], k5["bound_ms"], k5["bound_by"], None,
         "x".join(map(str, k5["shape"]))),
    ]
    kernels = []
    for (name, tag, source, replaces, path, err, ms, plain_ms, bound_ms, bound_by,
         library_ms, shape) in rows:
        kernels.append({
            "name": name, "route": "cuda", "source": f"onetrainer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[path][tag], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": shape,
            "launches_by_path": {p: counts[tag] for p, counts in launches.items()},
        })
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import onetrainer_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    failures = []
    results: dict = {}

    def run(name, fn, *args):
        try:
            results[name] = fn(*args)
            return results[name]
        except Exception:
            failures.append(name)
            print(f"[{name}] FAILED\n{traceback.format_exc()}", file=sys.stderr)
            return None

    gpu = run("nvidia-smi", gpu_line)
    if gpu is not None:
        print(gpu)
    run("build", phase_build)
    run("k1", phase_k1_cases, torch)
    run("k23", phase_k23_cases, torch)
    run("k4", phase_k4, torch)
    run("k5", phase_k5, torch)
    model = run("model", build_model, torch)
    if model is not None:
        run("unet", phase_unet, torch, model)
        run("sample", phase_sample, torch, model)
        run("train", phase_train, torch, model)
    # the fp32 model must not stay alive into the later phases' peak memory
    del model
    results.pop("model", None)
    for name, fn in (("qlora", phase_qlora), ("fp8", phase_fp8)):
        gc.collect()
        torch.cuda.empty_cache()
        run(name, fn, torch)

    if failures:
        print(f"chip_smoke: failed phases: {', '.join(failures)}", file=sys.stderr)
        return 1
    launches = {"sample": results["sample"],
                **{p: results[p]["launches"] for p in ("train", "qlora", "fp8")}}
    print(json.dumps(_kernel_table(results["k1"], results["k23"], results["k4"],
                                   results["k5"], launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
