"""FLUX sampler: rectified-flow Euler steps with µ-shifted sigmas and the
guidance embedding (distilled guidance: no negative pass, no CFG batch).

Counterpart of onetrainer_tpu/sampling/flux_sampler.py (reference:
modules/modelSampler/FluxSampler.py:52-205): linspace(1, 1/steps) under
the latent size's µ shift, the prompt through CLIP-L (pooled) and T5 (with
the T5 output at pad ids zeroed under `prior_attention_mask`), the packed
latents through one transformer pass per step with guidance = cfg_scale,
then the VAE decode of latents / scaling + shift. FLUX.1-fill (384 input
channels) encodes the conditioning image once (shifted, then scaled) and
appends it and the 8x8-shuffled mask, packed (64 + 256 channels), to the
packed latents at every transformer call (sampling/inpaint.py). The
reference's params become the port's modules; the sampler runs on the
transformer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.math.timesteps import flux_mu_shift
from onetrainer_tpu_torch.models.flux import (
    pack_latents, prepare_latent_image_ids, unpack_latents,
)
from onetrainer_tpu_torch.sampling.inpaint import flux_fill_mask_channels, inpainting_latents
from onetrainer_tpu_torch.sampling.sd_sampler import (
    SamplerOutput, _initial_latents, sample_rng_for,
)


def fill_channels(vae, vae_config, sample_config, height: int, width: int,
                  device: torch.device) -> torch.Tensor:
    """FLUX.1-fill's packed channels after the noisy latent's 64, [1, S,
    64 + 256]: the conditioning latent, shifted then scaled, and the pixel
    mask's 8x8 patches as 64 channels per latent cell, each packed."""
    latent, mask = inpainting_latents(vae, sample_config, height, width, device)
    cond = (latent - vae_config.shift_factor) * vae_config.scaling_factor
    mask64 = torch.from_numpy(np.ascontiguousarray(flux_fill_mask_channels(mask)))[None]
    return torch.cat([pack_latents(cond), pack_latents(mask64.to(device))], dim=-1)


def flux_sigmas(steps: int, latent_width: int, latent_height: int) -> np.ndarray:
    """[steps + 1] fp32: linspace(1, 1/steps) under the µ shift of the
    latent size, then 0."""
    shift = flux_mu_shift(latent_width, latent_height)
    sigmas = np.linspace(1.0, 1.0 / steps, steps)
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


@torch.inference_mode()
def sample_flux(
        model, transformer, text_encoder, text_encoder_2, vae,
        tokenize, tokenize_2,
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
    vc = model.vae_config
    scale = vc.spatial_scale
    lh, lw = height // scale, width // scale
    sigmas = flux_sigmas(steps, lw, lh)

    extra_1, extra_2 = extra_embeddings if isinstance(extra_embeddings, tuple) \
        else (extra_embeddings, None)
    t1, t2 = (torch.as_tensor(tok(sample_config.prompt), dtype=torch.int32,
                              device=device)[None] for tok in (tokenize, tokenize_2))
    pooled = text_encoder(t1, None, extra_1)["pooled_output"]
    t5_states = text_encoder_2(t2, extra_2,
                               layer_skip=sample_config.text_encoder_2_layer_skip)
    if getattr(sample_config, "prior_attention_mask", False):
        # the T5 output at pad ids (0) zeroed
        t5_states = t5_states * (t2 != 0)[..., None].to(t5_states.dtype)

    latents = _initial_latents((1, lh, lw, vc.latent_channels), generator, device)
    img_ids = prepare_latent_image_ids(lh, lw, device)
    guidance = torch.tensor([sample_config.cfg_scale], dtype=torch.float32, device=device)
    extra_packed = None
    if model.transformer_config.in_channels > 64:
        extra_packed = fill_channels(vae, vc, sample_config, height, width, device)
    packed = pack_latents(latents)
    for i in range(steps):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        t = torch.full((1,), sigma, dtype=torch.float32, device=device)
        x = packed.float()
        if extra_packed is not None:
            x = torch.cat([x, extra_packed], dim=-1)
        v = transformer(x, t, pooled, t5_states, img_ids, None, guidance)
        packed = packed + (sigma_next - sigma) * v
        if on_update_progress:
            on_update_progress(i + 1, steps)

    latents = unpack_latents(packed, lh, lw)
    image = vae.decode(latents / vc.scaling_factor + vc.shift_factor)
    image = torch.clamp(image[0].float() * 0.5 + 0.5, 0, 1).cpu().numpy()
    return SamplerOutput(image=(image * 255).astype(np.uint8))
