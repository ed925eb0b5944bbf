"""The HunyuanVideo training step: discrete-timestep flow matching over 5-D
video latents, Llama (template-cropped, layer -3) and CLIP-pooled
conditioning, and the guidance scalar x1000.

Counterpart of onetrainer_tpu/train/hunyuan_train_step.py (reference:
modules/modelSetup/BaseHunyuanVideoSetup.py:220-290):
`hunyuan_text_conditioning` (the cached Llama states, their mask and the
pooled CLIP embedding, or Llama (with any LoRA adapters attached) and
CLIP-L run on the batch's tokens), `hunyuan_predict` (the cached latent
distribution sampled and scaled; image batches as 1-frame clips; integer
timesteps, sigma = (t + 1) / 1000, x_t = sigma * noise + (1 - sigma) * x_0
in fp32; per-encoder conditioning dropout that leaves the mask alone; the
guidance `config.prior.guidance_scale` x 1000; the target noise - x_0) and
`make_hunyuan_train_step`. The loss, backward, clip, update and EMA are the
SD family's shared step (train/sd_train_step.py:make_train_step) with the
flow-matching losses; output embeddings patch the cropped Llama states.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.math.losses import flow_matching_losses
from onetrainer_tpu_torch.math.noise import create_noise
from onetrainer_tpu_torch.math.timesteps import sample_timesteps_discrete
from onetrainer_tpu_torch.models.hunyuan_video import PROMPT_TEMPLATE_CROP_START
from onetrainer_tpu_torch.models.llama import encode_llama_text
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, dropout_masks, extra_rows, keep_samples, make_train_step,
    output_embedding_scatter,
)


def hunyuan_text_conditioning(model, batch: dict, cfg: SDStepConfig):
    """-> (Llama states [B, 77, 4096] past the template, their keep mask
    [B, 77] or None, CLIP pooled [B, 768]): the cached ones when the batch
    carries them, else Llama at layer -3 minus the layer skip and CLIP-L on
    the batch's tokens, each with its trained embedding rows, Llama's
    output embeddings patched into its cropped states (the reference's
    hunyuan_train_step.py:29-67)."""
    if "text_encoder_1_hidden_state" in batch:
        return (batch["text_encoder_1_hidden_state"], batch.get("tokens_mask_1"),
                batch["text_encoder_2_pooled_state"])
    mask = batch.get("tokens_mask_1")
    out = model.text_encoder(batch["tokens_1"], mask, extra_rows(batch, 0))
    states = encode_llama_text(out, cfg.text_encoder_layer_skip, default_layer=-3,
                               crop_start=PROMPT_TEMPLATE_CROP_START)
    states = output_embedding_scatter(states, batch, "tokens_1", "",
                                      cfg.output_embedding_base_id,
                                      crop=PROMPT_TEMPLATE_CROP_START)
    if mask is not None:
        mask = mask[:, PROMPT_TEMPLATE_CROP_START:]
    pooled = model.text_encoder_2(batch["tokens_2"], None, extra_rows(batch, 1))["pooled_output"]
    return states, mask, pooled


def hunyuan_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                    coefficients=None, *, guidance_scale: float = 1.0, timestep=None,
                    noise=None, latent_noise=None, dropout_keep=None) -> dict:
    """Sample the cached latent distribution, scale it, draw the integer
    timesteps and noise, interpolate to x_t and predict the flow.
    `timestep`, `noise`, `latent_noise` and `dropout_keep` (the Llama and
    CLIP keep masks) replace the generator's draws when given;
    `coefficients` is unused (flow matching has no noise schedule)."""
    latent = batch["latent_image"]            # [B, T, H, W, 16] or [B, H, W, 16]
    device = latent.device
    if "latent_logvar" in batch:
        std = torch.exp(0.5 * torch.clamp(batch["latent_logvar"], -30.0, 20.0))
        if latent_noise is None:
            latent_noise = torch.randn(latent.shape, generator=generator, device=device,
                                       dtype=latent.dtype)
        latent = latent + std * torch.as_tensor(latent_noise, device=device)
    scaled = latent * cfg.vae_scaling_factor
    if scaled.dim() == 4:   # image batches become 1-frame clips
        scaled = scaled[:, None]
    b = scaled.shape[0]

    if timestep is None:
        timestep = sample_timesteps_discrete(generator, b, cfg.timestep,
                                             num_train_timesteps=cfg.num_train_timesteps)
    timestep = torch.as_tensor(timestep, device=device).to(torch.int32)
    if noise is None:
        noise = create_noise(generator, tuple(scaled.shape), scaled.dtype,
                             cfg.offset_noise_weight, cfg.perturbation_noise_weight)
    noise = torch.as_tensor(noise, device=device).to(scaled.dtype)
    sigma = ((timestep.float() + 1.0) / cfg.num_train_timesteps).reshape(-1, 1, 1, 1, 1)
    noisy = (noise.float() * sigma + scaled.float() * (1.0 - sigma)).to(scaled.dtype)

    states, mask, pooled = hunyuan_text_conditioning(model, batch, cfg)
    # Llama sequence, CLIP pooled; the attention mask is not zeroed
    # (reference: HunyuanVideoModel.py:301-311)
    m_llama, m_clip = dropout_keep if dropout_keep is not None else \
        dropout_masks(cfg, generator, b, 2)
    states, pooled = keep_samples(states, m_llama), keep_samples(pooled, m_clip)

    guidance = torch.full((b,), guidance_scale * 1000.0, dtype=torch.float32, device=device)
    predicted = model.transformer(noisy, timestep, states, mask, pooled, guidance)
    return {
        "loss_type": "target",
        "predicted": predicted,
        "target": noise.float() - scaled.float(),
        "timestep": timestep,
        "scaled_latent_image": scaled,
        "noisy_latent_image": noisy,
    }


def make_hunyuan_train_step(model, cfg: SDStepConfig, tx, guidance_scale: float = 1.0,
                            rank_dropout=None, embeddings=None):
    """The HunyuanVideo LoRA, FINE_TUNE or EMBEDDING step (train/sd_train_step.py:
    make_train_step with the flow-matching losses and the guidance
    `guidance_scale`): LoRA adapters, or the transformer's own parameters,
    updated in chunks of at most UPDATE_CHUNK_ELEMENTS elements (K5 once
    per chunk for bf16 parameters under stochastic rounding)."""
    def predict(model, batch, generator, cfg, coefficients, **draws):
        return hunyuan_predict(model, batch, generator, cfg, coefficients,
                               guidance_scale=guidance_scale, **draws)

    return make_train_step(
        model, cfg, tx, predict,
        losses=lambda batch, data: flow_matching_losses(batch, data, cfg.loss,
                                                        cfg.num_train_timesteps),
        rank_dropout=rank_dropout, embeddings=embeddings)
