"""Würstchen v2 / Stable Cascade sampler.

Counterpart of onetrainer_tpu/sampling/wuerstchen_sampler.py (reference:
modules/modelSampler/WuerstchenSampler.py). Stage C, the trained prior,
denoises the 16-channel effnet latent (0.75 / 32 of the image) over
`linspace(1, 0, steps + 1)` with classifier-free guidance (negative, then
positive prompt, one batch of two) and `cfg_rescale`, by the DDPM update
under the warped cosine alpha-bar the training step uses, adding noise on
every step but the last. Würstchen v2's latent then maps back by
x * 42 - 1. With a decoder stage loaded (v2 only), `decode_stage` runs
DiffNeXt over a 4-channel latent at a quarter of the image size for ten
steps without guidance, conditioned on that latent and the decoder CLIP's
states of the prompt, and the Paella VQGAN decodes `scale_factor *
latent`, clamped to [0, 1]. Otherwise, and for Stable Cascade (whose
stage B the reference does not implement either), a fixed linear
projection of the latent to RGB, normalized and resized nearest-neighbour
to the image size, stands in. Every draw (the initial latents, each
step's noise, the decoder's) comes from `_noise` on the sample's
generator, in that order.
"""

from __future__ import annotations

import numpy as np
import torch

from onetrainer_tpu_torch.models.resize import resize
from onetrainer_tpu_torch.sampling.sd_sampler import SamplerOutput, sample_rng_for
from onetrainer_tpu_torch.train.wuerstchen_train_step import (
    encode_wuerstchen_text, wuerstchen_alpha_cumprod,
)

DECODER_STEPS = 10   # the reference's decoder_noise_scheduler.set_timesteps(10)


def _noise(shape: tuple[int, ...], generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """One unit-normal fp32 draw of the sampler."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def _ddpm_step(latent, noise_pred, t: float, t_prev: float, last: bool, generator, device):
    """The DDPM-Würstchen update from t to t_prev under the warped cosine
    alpha-bar, with noise unless `last`."""
    ac = wuerstchen_alpha_cumprod(torch.tensor([t], device=device))
    ac_prev = wuerstchen_alpha_cumprod(torch.tensor([t_prev], device=device)) if t_prev > 0 \
        else torch.ones(1, device=device)
    alpha = ac / ac_prev
    mu = (1.0 / alpha.sqrt()) * (latent - (1 - alpha) * noise_pred / (1 - ac).sqrt())
    if not last:
        var = (1 - alpha) * (1 - ac_prev) / (1 - ac)
        mu = mu + var.sqrt() * _noise(tuple(mu.shape), generator, device)
    return mu


def _encode(model, text_encoder, tokenize, text, extra, layer_skip, device):
    tokens = torch.as_tensor(tokenize(text), dtype=torch.int32, device=device)[None]
    return encode_wuerstchen_text(model, text_encoder, tokens, None, extra, layer_skip)


@torch.no_grad()
def sample_wuerstchen(
        model, prior, text_encoder,
        tokenize,
        sample_config,
        extra_embeddings=None,
        generator: torch.Generator | None = None,
        on_update_progress=None,
) -> SamplerOutput:
    device = next(prior.parameters()).device
    steps = sample_config.diffusion_steps
    cfg_scale = sample_config.cfg_scale
    cfg_rescale = getattr(sample_config, "cfg_rescale", 0.0) or 0.0
    height, width = sample_config.height, sample_config.width
    if generator is None:
        generator = sample_rng_for(sample_config, device)
    layer_skip = getattr(sample_config, "text_encoder_1_layer_skip", 0) or 0
    cascade = model.model_type.is_stable_cascade()

    pos, pos_pooled = _encode(model, text_encoder, tokenize, sample_config.prompt,
                              extra_embeddings, layer_skip, device)
    neg, neg_pooled = _encode(model, text_encoder, tokenize,
                              sample_config.negative_prompt or "", extra_embeddings,
                              layer_skip, device)
    context = torch.cat([neg, pos], dim=0)
    pooled = torch.cat([neg_pooled, pos_pooled], dim=0) if cascade else None

    lh, lw = int((height * 0.75) / 32.0), int((width * 0.75) / 32.0)
    latent = _noise((1, lh, lw, 16), generator, device)

    def prior_call(x, t):
        if cascade:
            return prior(x, t, context, pooled, None)
        return prior(x, t, context)

    ts = np.linspace(1.0, 0.0, steps + 1)
    for i in range(steps):
        t = torch.full((2,), float(ts[i]), dtype=torch.float32, device=device)
        pred = prior_call(torch.cat([latent, latent], dim=0), t)
        pred_neg, pred_pos = pred.chunk(2, dim=0)
        noise_pred = pred_neg + cfg_scale * (pred_pos - pred_neg)
        if cfg_rescale > 0.0:
            dims = tuple(range(1, pred_pos.dim()))
            std_pos = pred_pos.std(dim=dims, keepdim=True, correction=0)
            std_pred = noise_pred.std(dim=dims, keepdim=True, correction=0)
            rescaled = noise_pred * (std_pos / std_pred.clamp(min=1e-8))
            noise_pred = cfg_rescale * rescaled + (1 - cfg_rescale) * noise_pred
        latent = _ddpm_step(latent, noise_pred, float(ts[i]), float(ts[i + 1]),
                            i + 1 == steps, generator, device)
        if on_update_progress:
            on_update_progress(i + 1, steps)

    if model.model_type.is_wuerstchen_v2():
        latent = latent * 42.0 - 1.0
        if model.decoder is not None and model.vqgan is not None:
            image = decode_stage(model, latent, text_encoder, tokenize, sample_config,
                                 extra_embeddings, generator, on_update_progress)
            return SamplerOutput(image=image)
    return SamplerOutput(image=standin_image(latent, height, width))


def standin_image(latent: torch.Tensor, height: int, width: int) -> np.ndarray:
    """The reference's stand-in decode: the 16-channel latent projected to
    RGB by a fixed unit-norm random matrix (numpy seed 0), normalized to
    [0, 1], resized nearest-neighbour to height x width, as uint8."""
    lat = latent[0].float().cpu().numpy()
    proj = np.random.default_rng(0).standard_normal((lat.shape[-1], 3)).astype(np.float32)
    proj /= np.linalg.norm(proj, axis=0, keepdims=True)
    img = lat @ proj
    img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
    img = resize(torch.from_numpy(img), (height, width), "nearest", dims=(0, 1)).numpy()
    return (img * 255).astype(np.uint8)


@torch.no_grad()
def decode_stage(model, image_embedding, prior_text_encoder, tokenize, sample_config,
                 extra_embeddings, generator, on_update_progress=None) -> np.ndarray:
    """Stages B and A: DiffNeXt denoises a 4-channel latent at a quarter of
    the image size over DECODER_STEPS steps (no guidance), conditioned on the
    prior's latent and the decoder CLIP's states of the prompt (the prior's
    text encoder when the decoder directory has none), then the VQGAN
    decodes `scale_factor * latent` to pixels in [0, 1] (reference:
    WuerstchenSampler.__sample_decoder:156-262, __sample_base:334-338)."""
    decoder = model.decoder
    device = next(decoder.parameters()).device
    height, width = sample_config.height, sample_config.width
    layer_skip = getattr(sample_config, "text_encoder_1_layer_skip", 0) or 0
    if model.decoder_text_encoder is not None:
        clip, _ = _encode(model, model.decoder_text_encoder,
                          model.decoder_tokenizer or tokenize, sample_config.prompt, None,
                          layer_skip, device)
    else:
        clip, _ = _encode(model, prior_text_encoder, tokenize, sample_config.prompt,
                          extra_embeddings, layer_skip, device)

    latent = _noise((1, height // 4, width // 4, 4), generator, device)
    effnet = image_embedding.float()
    ts = np.linspace(1.0, 0.0, DECODER_STEPS + 1)
    for i in range(DECODER_STEPS):
        t = torch.full((1,), float(ts[i]), dtype=torch.float32, device=device)
        noise_pred = decoder(latent, t, effnet, clip)
        latent = _ddpm_step(latent, noise_pred, float(ts[i]), float(ts[i + 1]),
                            i + 1 == DECODER_STEPS, generator, device)
        if on_update_progress:
            on_update_progress(i + 1, DECODER_STEPS)

    scale = getattr(model.vqgan_config, "scale_factor", 0.3764)
    image = model.vqgan(latent * scale)[0].clamp(0.0, 1.0)
    return torch.round(image.float() * 255).to(torch.uint8).cpu().numpy()
