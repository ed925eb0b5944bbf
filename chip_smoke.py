#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`onetrainer_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA GPU (sm_90a: H100/H200) and nvcc; fails without them, and
never falls back to the CPU. Phases, each of which must pass:
  1. build the folded flash-attention forward kernel (K1) from
     onetrainer_tpu_torch/csrc with nvcc;
  2. K1 against its plain PyTorch version in bf16: the two SDXL shapes,
     head dims 40/80/128, ragged Sq/Skv with a kv keep mask, zero q rows;
     max |do| and |dlse| against stated bounds, median times of both;
  3. one full-width SDXL UNet forward (128x128 latent, CFG batch 2) with
     K1 and with plain attention: relative L2 difference of the outputs;
  4. full-width SDXL text-to-image through the family registry
     (1024x1024, DDIM, 4 steps, CFG 7, seeded random weights): K1 must be
     launched exactly 70 times per step; the image must be uint8
     1024x1024x3 and not constant.
The last stdout line is one JSON object, {"ok": true, "device": {...}};
the line before it carries the kernel table as JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# bounds, bf16 operands on both sides (the plain version computes in fp32
# from the same bf16 inputs):
# - o: both round o to bf16 (relative 2^-9) and K1 rounds P to bf16 before
#   P.V; 2e-2 absolute is the reference package's own flash-test bound
# - lse: fp32 on both sides, only summation order and exp differ
O_BOUND = 2e-2
LSE_BOUND = 1e-3
# UNet output, K1 vs plain attention: 70 attention outputs that differ by
# bf16 roundings, carried through a bf16 network of random weights
UNET_REL_L2_BOUND = 5e-2
SELF_ATTN_PER_UNET_PASS = 70   # SDXL at a 128x128 latent: 10 at 4096, 60 at 1024 tokens

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
    print(f"[build] K1 library {os.path.relpath(path, REPO)} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}")


def phase_k1_cases(torch) -> dict:
    from onetrainer_tpu_torch.ops import flash_folded as ff
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for name, b, sq, skv, h, d, with_keep, zero_from in K1_CASES:
        def rand(s):
            return torch.randn((b, s, h * d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        q, k, v = rand(sq), rand(skv), rand(skv)
        if zero_from is not None:
            q[:, zero_from:] = 0
        keep = None
        if with_keep:
            keep = torch.ones((b, skv), dtype=torch.bool, device="cuda")
            keep[:, 700:] = False      # text-padding style tail
            keep[0, :64] = False       # a fully masked leading kv tile
            keep[1, 300:340] = False   # a hole
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
        ok = finite and err_o <= O_BOUND and err_lse <= LSE_BOUND
        results[name] = dict(err_o=err_o, err_lse=err_lse, ms=ms, plain_ms=plain_ms)
        print(f"[k1] {name}: max|do|={err_o:.3e} (bound {O_BOUND:g}) "
              f"max|dlse|={err_lse:.3e} (bound {LSE_BOUND:g}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 case {name} disagrees with the plain version")
    return results


def _plain_attention(ff):
    def plain(q, k, v, num_heads, *, sm_scale, kv_keep=None):
        return ff.flash_attention_folded_reference(
            q, k, v, num_heads, sm_scale=sm_scale, kv_keep=kv_keep)[0]
    return plain


def build_model(torch):
    from onetrainer_tpu_torch.io.weights import init_sdxl_weights
    from onetrainer_tpu_torch.models.sdxl import create_sdxl_model
    from onetrainer_tpu_torch.util.enums import ModelType
    t0 = time.perf_counter()
    model = create_sdxl_model(ModelType.STABLE_DIFFUSION_XL_10_BASE,
                              dtype=torch.bfloat16, device="meta")
    init_sdxl_weights(model, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for m in model.modules().values() for p in m.parameters())
    print(f"[model] SDXL base, {n} params (fp32, compute bf16), seeded "
          f"weights on the card in {time.perf_counter() - t0:.2f} s")
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


def phase_sample(torch, model) -> int:
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
    ff.flash_attention_folded_fwd.launches = 0
    t0 = time.perf_counter()
    out = family.sample(setup, sc, on_progress)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = ff.flash_attention_folded_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    expected = SELF_ATTN_PER_UNET_PASS * sc.diffusion_steps
    image = out.image
    # NaN latents would decode to a constant image, so it must vary
    ok = (launches == expected and image.dtype.name == "uint8"
          and image.shape == (1024, 1024, 3) and image.std() > 0)
    print(f"[sample] SDXL 1024x1024 DDIM {sc.diffusion_steps} steps CFG "
          f"{sc.cfg_scale:g}: total {total_s:.3f} s, UNet step median "
          f"{statistics.median(step_ms):.2f} ms (steps 2..{sc.diffusion_steps}: "
          f"{', '.join(f'{t:.2f}' for t in step_ms)} ms), peak "
          f"max_memory_allocated {peak_gib:.2f} GiB, K1 launches {launches} "
          f"(expected {expected}), image {image.shape} {image.dtype} "
          f"mean {image.mean():.2f} std {image.std():.2f} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("text-to-image run failed its checks")
    return launches


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

    def run(name, fn, *args):
        try:
            return fn(*args)
        except Exception:
            failures.append(name)
            print(f"[{name}] FAILED\n{traceback.format_exc()}", file=sys.stderr)
            return None

    gpu = run("nvidia-smi", gpu_line)
    if gpu is not None:
        print(gpu)
    run("build", phase_build)
    cases = run("k1", phase_k1_cases, torch) or {}
    model = run("model", build_model, torch)
    launches = 0
    if model is not None:
        run("unet", phase_unet, torch, model)
        launches = run("sample", phase_sample, torch, model) or 0

    if failures:
        print(f"chip_smoke: failed phases: {', '.join(failures)}", file=sys.stderr)
        return 1
    head = cases["sdxl_b2_s4096_h10_d64"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_folded_fwd (K1)",
        "route": "cuda",
        "source": "onetrainer_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "onetrainer_tpu/ops/flash_folded.py:93",
        "launches": launches,
        "max_abs_err": max(c["err_o"] for c in cases.values()),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
