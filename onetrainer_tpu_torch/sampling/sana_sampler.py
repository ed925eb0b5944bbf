"""Sana sampler: rectified-flow Euler over the linear-attention DiT with
classifier-free guidance, then the DC-AE decode.

Counterpart of onetrainer_tpu/sampling/sana_sampler.py (reference:
modules/modelSampler/SanaSampler.py): the prompt and the negative prompt
through Gemma-2 in one batch of 2 with their keep masks (the last,
post-norm state; any trained embedding rows), the unit-normal latents
[1, H/32, W/32, 32], each of the steps over linspace(1, 0) one
transformer pass on the cond and uncond copies at t = sigma * 1000 under
the keep masks, x <- x - (sigma_i - sigma_i+1) * (uncond + cfg * (cond -
uncond)), then the decode of latents / scaling. The reference's params
become the port's modules; the sampler runs on the transformer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.models.gemma import encode_gemma_text
from onetrainer_tpu_torch.sampling.sd_sampler import (
    SamplerOutput, _initial_latents, decode_image, sample_rng_for,
)


@torch.inference_mode()
def sample_sana(
        model, transformer, text_encoder, vae,
        tokenizer,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
) -> SamplerOutput:
    device = next(transformer.parameters()).device
    steps = sample_config.diffusion_steps
    cfg_scale = sample_config.cfg_scale
    height, width = sample_config.height, sample_config.width
    if generator is None:
        generator = sample_rng_for(sample_config, device)

    tokens = np.stack([tokenizer(sample_config.prompt),
                       tokenizer(sample_config.negative_prompt or "")])
    mask = np.stack([tokenizer.mask(tokens[0]), tokenizer.mask(tokens[1])])
    tokens, mask = (torch.as_tensor(a, device=device) for a in (tokens, mask))
    context = encode_gemma_text(text_encoder(tokens, mask, extra_embeddings), 0)

    vc = model.vae_config
    scale = vc.spatial_scale
    latents = _initial_latents((1, height // scale, width // scale, vc.latent_channels),
                               generator, device)
    sigmas = np.linspace(1.0, 0.0, steps + 1)
    for i in range(steps):
        t = torch.full((2,), sigmas[i] * 1000.0, dtype=torch.float32, device=device)
        flow = transformer(torch.cat([latents, latents], dim=0), t, context, mask)
        cond, uncond = flow[0:1], flow[1:2]
        latents = latents - float(sigmas[i] - sigmas[i + 1]) * (
            uncond + cfg_scale * (cond - uncond))
        if on_update_progress:
            on_update_progress(i + 1, steps)
    return SamplerOutput(image=decode_image(vae, vc, latents))
