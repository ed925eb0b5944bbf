"""SDXL sampler: dual text encoders, pooled conditioning, size/crop time
ids, CFG in one batched UNet pass.

Counterpart of onetrainer_tpu/sampling/sdxl_sampler.py (text-to-image).
The reference's params become the port's modules; the sampler runs on the
UNet's device. The 9-channel inpainting branch is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.sampling import schedulers as sched
from onetrainer_tpu_torch.sampling.sd_sampler import SamplerOutput, sample_rng_for


def _initial_latents(shape: tuple[int, ...], generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """The sampler's one noise draw: unit-normal fp32 latents."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


@torch.inference_mode()
def sample_stable_diffusion_xl(
        model, unet, text_encoder, text_encoder_2, vae,
        tokenize, tokenize_2,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
) -> SamplerOutput:
    if model.unet_config.in_channels == 9:
        raise NotImplementedError("SDXL inpainting sampling is not ported yet")
    device = next(unet.parameters()).device
    steps = sample_config.diffusion_steps
    height, width = sample_config.height, sample_config.width
    if generator is None:
        generator = sample_rng_for(sample_config, device)

    state = sched.create_scheduler(
        sample_config.noise_scheduler, model.betas, steps,
        prediction_type=model.prediction_type,
        force_last_timestep=sample_config.force_last_timestep)

    extra_1, extra_2 = extra_embeddings if isinstance(extra_embeddings, tuple) \
        else (extra_embeddings, extra_embeddings)

    def encode(prompt: str):
        t1 = torch.as_tensor(tokenize(prompt), dtype=torch.int32, device=device)[None]
        t2 = torch.as_tensor(tokenize_2(prompt), dtype=torch.int32, device=device)[None]
        out1 = text_encoder(t1, None, extra_1)
        out2 = text_encoder_2(t2, None, extra_2)
        skip = model.text_encoder_layer_skip
        ctx = torch.cat([
            encode_clip_text(out1, sample_config.text_encoder_1_layer_skip + skip),
            encode_clip_text(out2, sample_config.text_encoder_2_layer_skip + skip),
        ], dim=-1)
        return ctx, out2["pooled_output"]

    ctx_pos, pooled_pos = encode(sample_config.prompt)
    ctx_neg, pooled_neg = encode(sample_config.negative_prompt)
    context = torch.cat([ctx_pos, ctx_neg], dim=0)
    pooled = torch.cat([pooled_pos, pooled_neg], dim=0)
    time_ids = torch.tensor([[height, width, 0, 0, height, width]] * 2,
                            dtype=torch.float32, device=device)

    scale = model.vae_config.spatial_scale
    latent_shape = (1, height // scale, width // scale,
                    model.vae_config.latent_channels)
    latents = _initial_latents(latent_shape, generator, device)
    latents = latents * state.init_noise_sigma
    cfg_scale = sample_config.cfg_scale

    history: dict = {}
    for i in range(steps):
        t = int(state.timesteps[i])
        model_in = sched.scale_model_input(state, latents, i).float()
        ts = torch.full((2,), t, dtype=torch.int32, device=device)
        out = unet(torch.cat([model_in, model_in], dim=0), ts, context,
                   pooled, time_ids)
        cond, uncond = out[0:1], out[1:2]
        noise_pred = uncond + cfg_scale * (cond - uncond)
        latents = sched.step(state, noise_pred.float(), i, latents,
                             generator=generator, history=history)
        if on_update_progress:
            on_update_progress(i + 1, steps)

    image = vae.decode(latents / model.vae_config.scaling_factor)
    image = torch.clamp(image[0].float() * 0.5 + 0.5, 0, 1).cpu().numpy()
    return SamplerOutput(image=(image * 255).astype(np.uint8))
