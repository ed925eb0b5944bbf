"""The SD3 training step: flow matching over 16-channel latents with three
text encoders.

Counterpart of onetrainer_tpu/train/sd3_train_step.py (reference:
modules/modelSetup/BaseStableDiffusion3Setup.py): `sd3_conditioning` (the
cached context and pooled embeddings, or CLIP-L, CLIP-G and T5 run on the
batch's tokens, with per-encoder conditioning dropout), `sd3_predict`
(sigma = (t + 1) / 1000, x_t = sigma * noise + (1 - sigma) * x_0, the
transformer fed sigma * 1000, target = noise - x_0) and
`make_sd3_train_step`. The loss, backward, clip, update and EMA are the SD
family's shared step (train/sd_train_step.py:make_train_step) with the
flow-matching losses.
"""

from __future__ import annotations

import torch

from onetrainer_tpu_torch.math.losses import flow_matching_losses
from onetrainer_tpu_torch.math.noise import create_noise
from onetrainer_tpu_torch.math.timesteps import sample_timesteps_discrete
from onetrainer_tpu_torch.models.clip import encode_clip_text
from onetrainer_tpu_torch.models.sd3 import sd3_text_context
from onetrainer_tpu_torch.train.sd_train_step import (
    SDStepConfig, dropout_masks, extra_rows, keep_samples, make_train_step,
    output_embedding_scatter,
)


def sd3_conditioning(model, batch: dict, layer_skip: int, cfg: SDStepConfig | None = None,
                     generator: torch.Generator | None = None, dropout_keep=None):
    """-> (context [B, S, 4096], pooled [B, 2048]): the cached embeddings
    when the batch carries both, else the three text encoders (with any
    LoRA adapters attached, and each encoder's trained embedding rows) on
    its tokens, each one's output embeddings patched in; then the dropout
    masks (`dropout_keep` replaces the generator's draws)."""
    def masks(b):
        # CLIP-L sequence and pooled, CLIP-G sequence and pooled, T5 sequence
        # (reference: StableDiffusion3Model.py:397-415)
        return dropout_keep if dropout_keep is not None else \
            dropout_masks(cfg, generator, b, 3)

    if "sd3_context" in batch and "sd3_pooled" in batch:
        context, pooled = batch["sd3_context"], batch["sd3_pooled"]
        m1, m2, m3 = masks(context.shape[0])
        if m1 is None and m2 is None and m3 is None:
            return context, pooled
        # cached layout (models/sd3.py:sd3_text_context): rows [:clip_len]
        # are the channels [clip_l | clip_g | 0-pad], rows [clip_len:] T5;
        # pooled = [clip_l | clip_g]
        clip_len = batch["tokens"].shape[1]
        l_dim, g_dim = model.te_config.hidden_size, model.te2_config.hidden_size
        clip, t5 = context[:, :clip_len], context[:, clip_len:]
        h_l, h_g = clip[..., :l_dim], clip[..., l_dim:l_dim + g_dim]
        pad = clip[..., l_dim + g_dim:]
        p_l, p_g = pooled[:, :l_dim], pooled[:, l_dim:]
        h_l, p_l = keep_samples(h_l, m1), keep_samples(p_l, m1)
        h_g, p_g = keep_samples(h_g, m2), keep_samples(p_g, m2)
        context = torch.cat([torch.cat([h_l, h_g, pad], dim=-1), keep_samples(t5, m3)], dim=1)
        return context, torch.cat([p_l, p_g], dim=-1)
    out_l = model.text_encoder(batch["tokens"], None, extra_rows(batch, 0))
    out_g = model.text_encoder_2(batch["tokens_2"], None, extra_rows(batch, 1))
    # per-encoder layer skips (reference: StableDiffusion3Model.py:245-247)
    t5 = model.text_encoder_3(batch["tokens_3"], extra_rows(batch, 2),
                              layer_skip=cfg.te3_layer_skip if cfg is not None else 0)
    h_l = encode_clip_text(out_l, layer_skip)
    h_g = encode_clip_text(out_g, cfg.te2_layer_skip if cfg is not None else layer_skip)
    if cfg is not None:
        h_l = output_embedding_scatter(h_l, batch, "tokens", "", cfg.output_embedding_base_id)
        h_g = output_embedding_scatter(h_g, batch, "tokens_2", "_2",
                                       cfg.output_embedding_base_id_2)
        t5 = output_embedding_scatter(t5, batch, "tokens_3", "_3",
                                      cfg.output_embedding_base_id_3)
    p_l, p_g = out_l["pooled_output"], out_g["pooled_output"]
    m1, m2, m3 = masks(h_l.shape[0])
    return sd3_text_context(keep_samples(h_l, m1), keep_samples(h_g, m2), keep_samples(t5, m3),
                            keep_samples(p_l, m1), keep_samples(p_g, m2))


def sd3_predict(model, batch: dict, generator: torch.Generator, cfg: SDStepConfig,
                coefficients=None, *, timestep=None, noise=None, latent_noise=None,
                dropout_keep=None) -> dict:
    """Sample the cached latent distribution, shift and scale it, draw
    timesteps and noise, interpolate to the flow's x_t and predict the
    velocity. `timestep`, `noise`, `latent_noise` and `dropout_keep` (the
    three encoders' keep masks) replace the generator's draws when given;
    `coefficients` is unused (flow matching has no noise schedule)."""
    latent = batch["latent_image"]
    device = latent.device
    if "latent_logvar" in batch:
        std = torch.exp(0.5 * torch.clamp(batch["latent_logvar"], -30.0, 20.0))
        if latent_noise is None:
            latent_noise = torch.randn(latent.shape, generator=generator, device=device,
                                       dtype=latent.dtype)
        latent = latent + std * torch.as_tensor(latent_noise, device=device)
    scaled = (latent - cfg.vae_shift_factor) * cfg.vae_scaling_factor

    if timestep is None:
        timestep = sample_timesteps_discrete(generator, scaled.shape[0], cfg.timestep,
                                             num_train_timesteps=cfg.num_train_timesteps)
    timestep = torch.as_tensor(timestep, device=device).to(torch.int32)
    sigma = (timestep.float() + 1.0) / cfg.num_train_timesteps
    if noise is None:
        noise = create_noise(generator, tuple(scaled.shape), scaled.dtype,
                             cfg.offset_noise_weight, cfg.perturbation_noise_weight)
    noise = torch.as_tensor(noise, device=device).to(scaled.dtype)
    s = sigma.reshape(-1, 1, 1, 1)
    noisy = (noise.float() * s + scaled.float() * (1.0 - s)).to(scaled.dtype)

    context, pooled = sd3_conditioning(model, batch, cfg.text_encoder_layer_skip, cfg,
                                       generator, dropout_keep)
    predicted = model.transformer(noisy, sigma * 1000.0, pooled, context)
    return {
        "loss_type": "target",
        "predicted": predicted,
        "target": noise.float() - scaled.float(),
        "timestep": timestep,
        "scaled_latent_image": scaled,
        "noisy_latent_image": noisy,
    }


def make_sd3_train_step(model, cfg: SDStepConfig, tx, rank_dropout=None, embeddings=None):
    """The SD3 LoRA, FINE_TUNE or EMBEDDING step
    (train/sd_train_step.py:make_train_step with the flow-matching losses):
    LoRA adapters, the transformer's and CLIP-L's own parameters, or
    embedding vectors of the three text encoders, which then run in the
    step on the batch's tokens."""
    return make_train_step(model, cfg, tx, sd3_predict,
                           losses=lambda batch, data: flow_matching_losses(batch, data, cfg.loss),
                           rank_dropout=rank_dropout, embeddings=embeddings)
