"""SD 1.5/2.x sampler, and the sampler pieces the SD family shares: the
output record, the sampling generator, the initial latents, the CFG
denoising loop and the VAE decode.

Counterpart of onetrainer_tpu/sampling/sd_sampler.py (text-to-image): the
prompt and the negative prompt through the text encoder in one batch of 2,
the scheduler loop with cond and uncond in one batched UNet pass, then the
VAE decode. A 9-channel (inpainting) UNet takes the mask and the
conditioning image's latent, encoded once (sampling/inpaint.py), beside
the latents at every step. The reference's params become the port's
modules; the sampler runs on the UNet's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.sampling import schedulers as sched
from onetrainer_tpu_torch.sampling.inpaint import unet_inpainting_channels


@dataclass
class SamplerOutput:
    image: np.ndarray                     # HWC uint8


def sample_rng_for(sample_config, device: torch.device | str) -> torch.Generator:
    """Sampling generator on `device`: the configured seed, or OS entropy
    when sample_config.random_seed is set. Torch and JAX draw different
    numbers from one seed."""
    seed = sample_config.seed
    if getattr(sample_config, "random_seed", False):
        import secrets
        seed = secrets.randbits(31)
    return torch.Generator(device=device).manual_seed(seed)


def _initial_latents(shape: tuple[int, ...], generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """The sampler's one noise draw: unit-normal fp32 latents."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def with_channels(unet_call, extra: torch.Tensor | None):
    """`unet_call` with `extra` [1, h, w, c] concatenated after the input's
    channels, repeated over its batch (the CFG pair); `unet_call` itself
    without extra channels."""
    if extra is None:
        return unet_call
    return lambda x, ts: unet_call(
        torch.cat([x, extra.expand(x.shape[0], *extra.shape[1:])], dim=-1), ts)


def denoise(unet_call, state, latents: torch.Tensor, steps: int, cfg_scale: float,
            generator: torch.Generator, on_update_progress=None) -> torch.Tensor:
    """The scheduler loop with classifier-free guidance: each step runs
    `unet_call(model_in [2, ...], timesteps [2])` on the cond and uncond
    copies of the latents in one batch and combines its two outputs."""
    device = latents.device
    history: dict = {}
    for i in range(steps):
        t = int(state.timesteps[i])
        model_in = sched.scale_model_input(state, latents, i).float()
        ts = torch.full((2,), t, dtype=torch.int32, device=device)
        out = unet_call(torch.cat([model_in, model_in], dim=0), ts)
        cond, uncond = out[0:1], out[1:2]
        noise_pred = uncond + cfg_scale * (cond - uncond)
        latents = sched.step(state, noise_pred.float(), i, latents,
                             generator=generator, history=history)
        if on_update_progress:
            on_update_progress(i + 1, steps)
    return latents


def decode_image(vae, vae_config, latents: torch.Tensor) -> np.ndarray:
    """Decode the first latent to an HWC uint8 image."""
    image = vae.decode(latents / vae_config.scaling_factor)
    image = torch.clamp(image[0].float() * 0.5 + 0.5, 0, 1).cpu().numpy()
    return (image * 255).astype(np.uint8)


@torch.inference_mode()
def sample_stable_diffusion(
        model, unet, text_encoder, vae,
        tokenize,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
) -> SamplerOutput:
    device = next(unet.parameters()).device
    steps = sample_config.diffusion_steps
    height, width = sample_config.height, sample_config.width
    if generator is None:
        generator = sample_rng_for(sample_config, device)

    state = sched.create_scheduler(
        sample_config.noise_scheduler, model.betas, steps,
        prediction_type=model.prediction_type,
        force_last_timestep=sample_config.force_last_timestep)

    tokens = torch.stack([
        torch.as_tensor(tokenize(sample_config.prompt), dtype=torch.int32),
        torch.as_tensor(tokenize(sample_config.negative_prompt), dtype=torch.int32),
    ]).to(device)
    te_out = text_encoder(tokens, None, extra_embeddings)
    context = encode_clip_text(
        te_out, sample_config.text_encoder_1_layer_skip + model.text_encoder_layer_skip)

    scale = model.vae_config.spatial_scale
    latent_shape = (1, height // scale, width // scale,
                    model.vae_config.latent_channels)
    latents = _initial_latents(latent_shape, generator, device)
    latents = latents * state.init_noise_sigma
    extra = None
    if model.unet_config.in_channels == 9:
        extra = unet_inpainting_channels(vae, model.vae_config, sample_config,
                                         height, width, device)
    latents = denoise(with_channels(lambda x, ts: unet(x, ts, context), extra), state,
                      latents, steps, sample_config.cfg_scale, generator,
                      on_update_progress)
    return SamplerOutput(image=decode_image(vae, model.vae_config, latents))
