"""SD3 sampler: Euler steps on the flow's velocity with classifier-free
guidance over the MMDiT.

Counterpart of onetrainer_tpu/sampling/sd3_sampler.py (reference:
modules/modelSampler/StableDiffusion3Sampler.py): SD3's static shift-3
sigma schedule, the prompt and the negative prompt through the three text
encoders, cond and uncond in one batched transformer pass per step, then
the VAE decode of latents / scaling + shift. The reference's params become
the port's modules; the sampler runs on the transformer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.models.sd3 import sd3_text_context
from onetrainer_tpu_torch.sampling.sd_sampler import (
    SamplerOutput, _initial_latents, sample_rng_for,
)


def sd3_sigmas(steps: int, shift: float = 3.0) -> np.ndarray:
    """[steps + 1] fp32: linspace(1, 1/steps) under the static shift, then 0."""
    sigmas = np.linspace(1.0, 1.0 / steps, steps)
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


@torch.inference_mode()
def sample_sd3(
        model, transformer, text_encoder, text_encoder_2, text_encoder_3, vae,
        tokenize, tokenize_2, tokenize_3,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
):
    device = next(transformer.parameters()).device
    steps = sample_config.diffusion_steps
    height, width = sample_config.height, sample_config.width
    if generator is None:
        generator = sample_rng_for(sample_config, device)
    sigmas = sd3_sigmas(steps)

    extra_1, extra_2, extra_3 = extra_embeddings if isinstance(extra_embeddings, tuple) \
        else (extra_embeddings, extra_embeddings, None)

    def encode(prompt: str):
        t1, t2, t3 = (torch.as_tensor(tok(prompt), dtype=torch.int32, device=device)[None]
                      for tok in (tokenize, tokenize_2, tokenize_3))
        out_l = text_encoder(t1, None, extra_1)
        out_g = text_encoder_2(t2, None, extra_2)
        t5 = text_encoder_3(t3, extra_3, layer_skip=sample_config.text_encoder_3_layer_skip)
        if getattr(sample_config, "prior_attention_mask", False):
            # the T5 output at pad ids (0) zeroed
            t5 = t5 * (t3 != 0)[..., None].to(t5.dtype)
        return sd3_text_context(
            encode_clip_text(out_l, sample_config.text_encoder_1_layer_skip),
            encode_clip_text(out_g, sample_config.text_encoder_2_layer_skip),
            t5, out_l["pooled_output"], out_g["pooled_output"])

    ctx_pos, pooled_pos = encode(sample_config.prompt)
    ctx_neg, pooled_neg = encode(sample_config.negative_prompt)
    context = torch.cat([ctx_pos, ctx_neg], dim=0)
    pooled = torch.cat([pooled_pos, pooled_neg], dim=0)
    cfg_scale = sample_config.cfg_scale

    vc = model.vae_config
    scale = vc.spatial_scale
    latents = _initial_latents((1, height // scale, width // scale, vc.latent_channels),
                               generator, device)
    for i in range(steps):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        ts = torch.full((2,), sigma * 1000.0, dtype=torch.float32, device=device)
        out = transformer(torch.cat([latents, latents], dim=0), ts, pooled, context)
        cond, uncond = out[0:1], out[1:2]
        latents = latents + (sigma_next - sigma) * (uncond + cfg_scale * (cond - uncond))
        if on_update_progress:
            on_update_progress(i + 1, steps)

    image = vae.decode(latents / vc.scaling_factor + vc.shift_factor)
    image = torch.clamp(image[0].float() * 0.5 + 0.5, 0, 1).cpu().numpy()
    return SamplerOutput(image=(image * 255).astype(np.uint8))
