"""PixArt sampler: the scheduler loop over the DiT with classifier-free
guidance, the learned-variance channels dropped.

Counterpart of onetrainer_tpu/sampling/pixart_sampler.py (reference:
modules/modelSampler/PixArtAlphaSampler.py): the prompt and the negative
prompt through T5 in one batch of 2 (at the sample config's layer skip,
with any trained embedding rows), the initial latents scaled by the
scheduler's initial sigma, each step one transformer pass on the cond and
uncond copies (the micro-conditions from the latent shape) whose first
4 channels (eps) the CFG combines, then the VAE decode of latents /
scaling. The reference's params become the port's modules; the sampler
runs on the transformer's device.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.sampling import schedulers as sched
from onetrainer_tpu_torch.sampling.sd_sampler import (
    SamplerOutput, _initial_latents, decode_image, denoise, sample_rng_for,
)


@torch.inference_mode()
def sample_pixart(
        model, transformer, text_encoder, vae,
        tokenize,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
) -> SamplerOutput:
    device = next(transformer.parameters()).device
    steps = sample_config.diffusion_steps
    height, width = sample_config.height, sample_config.width
    if generator is None:
        generator = sample_rng_for(sample_config, device)

    state = sched.create_scheduler(
        sample_config.noise_scheduler, model.betas, steps, prediction_type="epsilon",
        force_last_timestep=sample_config.force_last_timestep)

    tokens = torch.stack([
        torch.as_tensor(tokenize(sample_config.prompt), dtype=torch.int32),
        torch.as_tensor(tokenize(sample_config.negative_prompt), dtype=torch.int32),
    ]).to(device)
    context = text_encoder(tokens, extra_embeddings,
                           layer_skip=sample_config.text_encoder_1_layer_skip)

    vc = model.vae_config
    scale = vc.spatial_scale
    lh, lw = height // scale, width // scale
    latents = _initial_latents((1, lh, lw, vc.latent_channels), generator, device)
    latents = latents * state.init_noise_sigma
    resolution = torch.tensor([[lh * 8, lw * 8]] * 2, dtype=torch.float32, device=device)
    aspect_ratio = torch.full((2, 1), float(lh) / float(lw), dtype=torch.float32,
                              device=device)

    def eps(x, ts):
        out = transformer(x, ts, context, resolution, aspect_ratio)
        return out[..., :vc.latent_channels]

    latents = denoise(eps, state, latents, steps, sample_config.cfg_scale, generator,
                      on_update_progress)
    return SamplerOutput(image=decode_image(vae, vc, latents))
