"""HunyuanVideo sampler: flow-matching Euler over the 3D DiT and the causal
VAE's decode to a frame stack.

Counterpart of onetrainer_tpu/sampling/hunyuan_sampler.py (reference:
modules/modelSampler/HunyuanVideoSampler.py:85-199): frames quantized to
4k + 1, the prompt through Llama (layer -3, cropped past the template,
with its keep mask) and CLIP-L (pooled), the latents [1, T', h, w, 16]
through one transformer pass per step over linspace(1, 0) with the
guidance cfg_scale x 1000 (the distilled guidance: no negative pass, no
CFG batch), then the VAE decode of latents / scaling. The first frame is
the output's `image`, the stack its `video`. The reference's params
become the port's modules; the sampler runs on the transformer's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from onetrainer_tpu_torch.models.hunyuan_video import PROMPT_TEMPLATE_CROP_START
from onetrainer_tpu_torch.models.llama import encode_llama_text
from onetrainer_tpu_torch.sampling.sd_sampler import (
    SamplerOutput, _initial_latents, sample_rng_for,
)


@dataclass
class VideoSamplerOutput(SamplerOutput):
    video: np.ndarray | None = None       # [T, H, W, 3] uint8


@torch.inference_mode()
def sample_hunyuan_video(
        model, transformer, text_encoder, text_encoder_2, vae,
        tokenize, tokenize_2,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
) -> VideoSamplerOutput:
    device = next(transformer.parameters()).device
    steps = sample_config.diffusion_steps
    height, width = sample_config.height, sample_config.width
    frames = max(int(sample_config.frames or 1), 1)
    frames = ((frames - 1) // 4) * 4 + 1
    if generator is None:
        generator = sample_rng_for(sample_config, device)

    # trained embedding rows: (Llama's, CLIP-L's), or Llama's alone
    extra_1, extra_2 = extra_embeddings if isinstance(extra_embeddings, tuple) \
        else (extra_embeddings, None)
    tokens = tokenize(sample_config.prompt)
    t1 = torch.as_tensor(tokens, dtype=torch.int32, device=device)[None]
    mask = torch.as_tensor(tokenize.mask(tokens), dtype=torch.int32, device=device)[None]
    states = encode_llama_text(text_encoder(t1, mask, extra_1), 0,
                               default_layer=-3, crop_start=PROMPT_TEMPLATE_CROP_START)
    mask = mask[:, PROMPT_TEMPLATE_CROP_START:]
    t2 = torch.as_tensor(tokenize_2(sample_config.prompt), dtype=torch.int32,
                         device=device)[None]
    pooled = text_encoder_2(t2, None, extra_2)["pooled_output"]

    vc = model.vae_config
    scale = vc.spatial_scale
    t_latent = (frames - 1) // vc.temporal_compression + 1
    latents = _initial_latents((1, t_latent, height // scale, width // scale,
                                vc.latent_channels), generator, device)
    guidance = torch.tensor([sample_config.cfg_scale * 1000.0], dtype=torch.float32,
                            device=device)
    sigmas = np.linspace(1.0, 0.0, steps + 1)
    for i in range(steps):
        t = torch.full((1,), sigmas[i] * 1000.0, dtype=torch.float32, device=device)
        v = transformer(latents, t, states, mask, pooled, guidance)
        latents = latents - float(sigmas[i] - sigmas[i + 1]) * v
        if on_update_progress:
            on_update_progress(i + 1, steps)

    video = vae.decode(latents / vc.scaling_factor)
    video = torch.clamp(video[0] * 0.5 + 0.5, 0, 1).cpu().numpy()
    frames_u8 = (video * 255).astype(np.uint8)        # [T, H, W, 3]
    return VideoSamplerOutput(image=frames_u8[0], video=frames_u8)


def write_video(path: str, frames: np.ndarray, fps: float = 24.0) -> None:
    """[T, H, W, 3] uint8 -> an mp4 (reference: BaseModelSampler.save's
    video path); needs OpenCV."""
    import cv2
    _, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
