"""Single-file checkpoints of SD3 (the SAI layout), FLUX (the BFL layout),
HunyuanVideo, PixArt and Stable Cascade (the original repositories'
layouts; Stable Cascade's stage_c with the fused in_proj attention keys and
a text_encoder.safetensors beside it): load and save.

Counterpart of onetrainer_tpu/io/single_file.py (reference:
modules/util/convert/convert_sd3_diffusers_to_ckpt.py,
convert_flux_diffusers_to_ckpt.py,
convert_hunyuan_video_diffusers_to_ckpt.py and the families' single-file
loaders). The key maps are the reference's, on torch tensors: fused
q/k/v (and FLUX's and HunyuanVideo's single-block MLP) concatenated on
save and split on load, the final adaLN's shift and scale halves swapped;
tests/test_torch_port_copies.py holds them to the originals in both
directions. A split keeps views of the fused tensor, so a load holds each
weight once.

The loaders return what io/{sd3,flux,hunyuan}_checkpoints.py's diffusers
loaders return: configs, and state dicts on `device` with floats in
`weight_dtype` in the port's module layout. The transformer's config is
read from its tensors' shapes (the reference's rules for the published
widths: 64-wide SD3 heads, 24 FLUX heads, HunyuanVideo's head width from
its q norm; FLUX's head width from its q norm too, and the rest of each
config from the shapes where the reference keeps a default). A bundled
VAE (`first_stage_model.*` or `vae.*`, LDM keys) and text encoders
(`text_encoders.<clip_l|clip_g|t5xxl>.transformer.*`, transformers' keys)
load when present, their configs read from their shapes; a missing one
prints the reference's "not in single-file checkpoint, continuing without
it" and comes back None.

The savers write what the reference's families write: SD3 the MMDiT under
`model.diffusion_model.`, the VAE and the text encoders; FLUX the BFL
transformer keys; HunyuanVideo the transformer under `model.model.`. The
port's FLUX and HunyuanVideo files also carry the VAE and the text
encoders (FLUX's under SD3's prefixes, which the reference's FLUX loader
reads; HunyuanVideo's under `vae.` and `text_encoders.<llama|clip_l>.
transformer.`, which the reference's loader skips), so a fine-tuned
output samples on its own. The reference writes and reads the SD3 and
FLUX VAE under a doubled `first_stage_model.first_stage_model.` prefix
(ROADMAP queue 3, F14); the port writes SAI's single prefix and reads
both.
"""

from __future__ import annotations

import math
import os

import torch

from onetrainer_tpu_torch.io import ldm
from onetrainer_tpu_torch.io.safetensors_io import save_safetensors
from onetrainer_tpu_torch.io.sd_checkpoints import (
    _cast, _meta, _read_single_file, clip_config_from_transformers,
)
from onetrainer_tpu_torch.models.clip import CLIPTextConfig
from onetrainer_tpu_torch.models.vae import VAEConfig


def _combine(left: str, right: str) -> str:
    if not left:
        return right
    if not right:
        return left
    return f"{left}.{right}"


def _swap_chunks(t: torch.Tensor) -> torch.Tensor:
    a, b = t.chunk(2, dim=0)
    return torch.cat([b, a], dim=0)


def _map_wb(out, ins, out_prefix, in_prefix):
    out[_combine(out_prefix, "weight")] = ins[_combine(in_prefix, "weight")]
    out[_combine(out_prefix, "bias")] = ins[_combine(in_prefix, "bias")]


def _unmap_wb(out, ins, out_prefix, in_prefix):
    out[_combine(out_prefix, "weight")] = ins[_combine(in_prefix, "weight")]
    out[_combine(out_prefix, "bias")] = ins[_combine(in_prefix, "bias")]


def _cat(ins, keys):
    return torch.cat([ins[k] for k in keys], dim=0)


def _split3(out, ins, key, out_keys):
    parts = ins[key].chunk(len(out_keys), dim=0)
    for name, part in zip(out_keys, parts):
        out[name] = part


def _split_single_linear1(fused: torch.Tensor, hidden: int) -> tuple:
    """A single block's fused [q | k | v | mlp] rows -> the four parts."""
    return fused.split([hidden, hidden, hidden, fused.shape[0] - 3 * hidden], dim=0)


# -- FLUX (BFL single-file layout) ---------------------------------------------------

def flux_transformer_to_bfl(sd: dict) -> dict:
    """diffusers FluxTransformer2DModel keys -> BFL keys
    (reference: convert_flux_diffusers_to_ckpt.py:11-118)."""
    out: dict = {}
    _map_wb(out, sd, "txt_in", "context_embedder")
    if "time_text_embed.guidance_embedder.linear_1.weight" in sd:
        _map_wb(out, sd, "guidance_in.in_layer",
                "time_text_embed.guidance_embedder.linear_1")
        _map_wb(out, sd, "guidance_in.out_layer",
                "time_text_embed.guidance_embedder.linear_2")
    _map_wb(out, sd, "vector_in.in_layer",
            "time_text_embed.text_embedder.linear_1")
    _map_wb(out, sd, "vector_in.out_layer",
            "time_text_embed.text_embedder.linear_2")
    _map_wb(out, sd, "time_in.in_layer",
            "time_text_embed.timestep_embedder.linear_1")
    _map_wb(out, sd, "time_in.out_layer",
            "time_text_embed.timestep_embedder.linear_2")
    out["final_layer.adaLN_modulation.1.weight"] = \
        _swap_chunks(sd["norm_out.linear.weight"])
    out["final_layer.adaLN_modulation.1.bias"] = \
        _swap_chunks(sd["norm_out.linear.bias"])
    _map_wb(out, sd, "final_layer.linear", "proj_out")
    _map_wb(out, sd, "img_in", "x_embedder")

    i = 0
    while f"transformer_blocks.{i}.attn.to_q.weight" in sd:
        ip, op = f"transformer_blocks.{i}", f"double_blocks.{i}"
        for wb in ("weight", "bias"):
            out[f"{op}.img_attn.qkv.{wb}"] = _cat(sd, [
                f"{ip}.attn.to_q.{wb}", f"{ip}.attn.to_k.{wb}",
                f"{ip}.attn.to_v.{wb}"])
            out[f"{op}.txt_attn.qkv.{wb}"] = _cat(sd, [
                f"{ip}.attn.add_q_proj.{wb}", f"{ip}.attn.add_k_proj.{wb}",
                f"{ip}.attn.add_v_proj.{wb}"])
        out[f"{op}.img_attn.norm.query_norm.scale"] = sd[f"{ip}.attn.norm_q.weight"]
        out[f"{op}.img_attn.norm.key_norm.scale"] = sd[f"{ip}.attn.norm_k.weight"]
        out[f"{op}.txt_attn.norm.query_norm.scale"] = sd[f"{ip}.attn.norm_added_q.weight"]
        out[f"{op}.txt_attn.norm.key_norm.scale"] = sd[f"{ip}.attn.norm_added_k.weight"]
        _map_wb(out, sd, f"{op}.img_attn.proj", f"{ip}.attn.to_out.0")
        _map_wb(out, sd, f"{op}.img_mlp.0", f"{ip}.ff.net.0.proj")
        _map_wb(out, sd, f"{op}.img_mlp.2", f"{ip}.ff.net.2")
        _map_wb(out, sd, f"{op}.img_mod.lin", f"{ip}.norm1.linear")
        _map_wb(out, sd, f"{op}.txt_attn.proj", f"{ip}.attn.to_add_out")
        _map_wb(out, sd, f"{op}.txt_mlp.0", f"{ip}.ff_context.net.0.proj")
        _map_wb(out, sd, f"{op}.txt_mlp.2", f"{ip}.ff_context.net.2")
        _map_wb(out, sd, f"{op}.txt_mod.lin", f"{ip}.norm1_context.linear")
        i += 1

    i = 0
    while f"single_transformer_blocks.{i}.attn.to_q.weight" in sd:
        ip, op = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        for wb in ("weight", "bias"):
            out[f"{op}.linear1.{wb}"] = _cat(sd, [
                f"{ip}.attn.to_q.{wb}", f"{ip}.attn.to_k.{wb}",
                f"{ip}.attn.to_v.{wb}", f"{ip}.proj_mlp.{wb}"])
        out[f"{op}.norm.query_norm.scale"] = sd[f"{ip}.attn.norm_q.weight"]
        out[f"{op}.norm.key_norm.scale"] = sd[f"{ip}.attn.norm_k.weight"]
        _map_wb(out, sd, f"{op}.linear2", f"{ip}.proj_out")
        _map_wb(out, sd, f"{op}.modulation.lin", f"{ip}.norm.linear")
        i += 1
    return out


def flux_bfl_to_transformer(sd: dict) -> dict:
    """Inverse of flux_transformer_to_bfl."""
    out: dict = {}
    _map_wb(out, sd, "context_embedder", "txt_in")
    if "guidance_in.in_layer.weight" in sd:
        _map_wb(out, sd, "time_text_embed.guidance_embedder.linear_1",
                "guidance_in.in_layer")
        _map_wb(out, sd, "time_text_embed.guidance_embedder.linear_2",
                "guidance_in.out_layer")
    _map_wb(out, sd, "time_text_embed.text_embedder.linear_1",
            "vector_in.in_layer")
    _map_wb(out, sd, "time_text_embed.text_embedder.linear_2",
            "vector_in.out_layer")
    _map_wb(out, sd, "time_text_embed.timestep_embedder.linear_1",
            "time_in.in_layer")
    _map_wb(out, sd, "time_text_embed.timestep_embedder.linear_2",
            "time_in.out_layer")
    out["norm_out.linear.weight"] = \
        _swap_chunks(sd["final_layer.adaLN_modulation.1.weight"])
    out["norm_out.linear.bias"] = \
        _swap_chunks(sd["final_layer.adaLN_modulation.1.bias"])
    _map_wb(out, sd, "proj_out", "final_layer.linear")
    _map_wb(out, sd, "x_embedder", "img_in")

    i = 0
    while f"double_blocks.{i}.img_attn.qkv.weight" in sd:
        ip, op = f"double_blocks.{i}", f"transformer_blocks.{i}"
        for wb in ("weight", "bias"):
            _split3(out, sd, f"{ip}.img_attn.qkv.{wb}",
                    [f"{op}.attn.to_q.{wb}", f"{op}.attn.to_k.{wb}",
                     f"{op}.attn.to_v.{wb}"])
            _split3(out, sd, f"{ip}.txt_attn.qkv.{wb}",
                    [f"{op}.attn.add_q_proj.{wb}", f"{op}.attn.add_k_proj.{wb}",
                     f"{op}.attn.add_v_proj.{wb}"])
        out[f"{op}.attn.norm_q.weight"] = sd[f"{ip}.img_attn.norm.query_norm.scale"]
        out[f"{op}.attn.norm_k.weight"] = sd[f"{ip}.img_attn.norm.key_norm.scale"]
        out[f"{op}.attn.norm_added_q.weight"] = sd[f"{ip}.txt_attn.norm.query_norm.scale"]
        out[f"{op}.attn.norm_added_k.weight"] = sd[f"{ip}.txt_attn.norm.key_norm.scale"]
        _map_wb(out, sd, f"{op}.attn.to_out.0", f"{ip}.img_attn.proj")
        _map_wb(out, sd, f"{op}.ff.net.0.proj", f"{ip}.img_mlp.0")
        _map_wb(out, sd, f"{op}.ff.net.2", f"{ip}.img_mlp.2")
        _map_wb(out, sd, f"{op}.norm1.linear", f"{ip}.img_mod.lin")
        _map_wb(out, sd, f"{op}.attn.to_add_out", f"{ip}.txt_attn.proj")
        _map_wb(out, sd, f"{op}.ff_context.net.0.proj", f"{ip}.txt_mlp.0")
        _map_wb(out, sd, f"{op}.ff_context.net.2", f"{ip}.txt_mlp.2")
        _map_wb(out, sd, f"{op}.norm1_context.linear", f"{ip}.txt_mod.lin")
        i += 1

    i = 0
    while f"single_blocks.{i}.linear1.weight" in sd:
        ip, op = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        for wb in ("weight", "bias"):
            hidden = sd[f"{ip}.linear2.weight"].shape[0]
            q, k, v, mlp = _split_single_linear1(sd[f"{ip}.linear1.{wb}"], hidden)
            out[f"{op}.attn.to_q.{wb}"] = q
            out[f"{op}.attn.to_k.{wb}"] = k
            out[f"{op}.attn.to_v.{wb}"] = v
            out[f"{op}.proj_mlp.{wb}"] = mlp
        out[f"{op}.attn.norm_q.weight"] = sd[f"{ip}.norm.query_norm.scale"]
        out[f"{op}.attn.norm_k.weight"] = sd[f"{ip}.norm.key_norm.scale"]
        _map_wb(out, sd, f"{op}.proj_out", f"{ip}.linear2")
        _map_wb(out, sd, f"{op}.norm.linear", f"{ip}.modulation.lin")
        i += 1
    return out


# -- SD3 (SAI single-file layout) ------------------------------------------------------

def sd3_transformer_to_sai(sd: dict) -> dict:
    """diffusers SD3Transformer2DModel -> sai 'model.diffusion_model.*'
    inner keys (reference: convert_sd3_diffusers_to_ckpt.py:11-107)."""
    out: dict = {}
    if "pos_embed.pos_embed" in sd:
        out["pos_embed"] = sd["pos_embed.pos_embed"]
    _map_wb(out, sd, "x_embedder.proj", "pos_embed.proj")
    _map_wb(out, sd, "context_embedder", "context_embedder")
    out["final_layer.adaLN_modulation.1.weight"] = \
        _swap_chunks(sd["norm_out.linear.weight"])
    out["final_layer.adaLN_modulation.1.bias"] = \
        _swap_chunks(sd["norm_out.linear.bias"])
    _map_wb(out, sd, "final_layer.linear", "proj_out")
    _map_wb(out, sd, "t_embedder.mlp.0",
            "time_text_embed.timestep_embedder.linear_1")
    _map_wb(out, sd, "t_embedder.mlp.2",
            "time_text_embed.timestep_embedder.linear_2")
    _map_wb(out, sd, "y_embedder.mlp.0",
            "time_text_embed.text_embedder.linear_1")
    _map_wb(out, sd, "y_embedder.mlp.2",
            "time_text_embed.text_embedder.linear_2")

    i = 0
    while f"transformer_blocks.{i}.attn.to_q.weight" in sd:
        ip, op = f"transformer_blocks.{i}", f"joint_blocks.{i}"
        is_last = f"transformer_blocks.{i + 1}.attn.to_q.weight" not in sd
        for wb in ("weight", "bias"):
            out[f"{op}.x_block.attn.qkv.{wb}"] = _cat(sd, [
                f"{ip}.attn.to_q.{wb}", f"{ip}.attn.to_k.{wb}",
                f"{ip}.attn.to_v.{wb}"])
            out[f"{op}.context_block.attn.qkv.{wb}"] = _cat(sd, [
                f"{ip}.attn.add_q_proj.{wb}", f"{ip}.attn.add_k_proj.{wb}",
                f"{ip}.attn.add_v_proj.{wb}"])
        _map_wb(out, sd, f"{op}.x_block.attn.proj", f"{ip}.attn.to_out.0")
        _map_wb(out, sd, f"{op}.x_block.adaLN_modulation.1", f"{ip}.norm1.linear")
        if not is_last:
            _map_wb(out, sd, f"{op}.context_block.attn.proj",
                    f"{ip}.attn.to_add_out")
            _map_wb(out, sd, f"{op}.context_block.adaLN_modulation.1",
                    f"{ip}.norm1_context.linear")
            _map_wb(out, sd, f"{op}.context_block.mlp.fc1",
                    f"{ip}.ff_context.net.0.proj")
            _map_wb(out, sd, f"{op}.context_block.mlp.fc2",
                    f"{ip}.ff_context.net.2")
        else:
            out[f"{op}.context_block.adaLN_modulation.1.weight"] = \
                _swap_chunks(sd[f"{ip}.norm1_context.linear.weight"])
            out[f"{op}.context_block.adaLN_modulation.1.bias"] = \
                _swap_chunks(sd[f"{ip}.norm1_context.linear.bias"])
        if f"{ip}.attn.norm_q.weight" in sd:          # SD3.5 qk norms
            out[f"{op}.x_block.attn.ln_q.weight"] = sd[f"{ip}.attn.norm_q.weight"]
            out[f"{op}.x_block.attn.ln_k.weight"] = sd[f"{ip}.attn.norm_k.weight"]
        if f"{ip}.attn.norm_added_q.weight" in sd:
            out[f"{op}.context_block.attn.ln_q.weight"] = \
                sd[f"{ip}.attn.norm_added_q.weight"]
            out[f"{op}.context_block.attn.ln_k.weight"] = \
                sd[f"{ip}.attn.norm_added_k.weight"]
        _map_wb(out, sd, f"{op}.x_block.mlp.fc1", f"{ip}.ff.net.0.proj")
        _map_wb(out, sd, f"{op}.x_block.mlp.fc2", f"{ip}.ff.net.2")
        i += 1
    return out


def sd3_sai_to_transformer(sd: dict) -> dict:
    """Inverse of sd3_transformer_to_sai."""
    out: dict = {}
    if "pos_embed" in sd:
        out["pos_embed.pos_embed"] = sd["pos_embed"]
    _map_wb(out, sd, "pos_embed.proj", "x_embedder.proj")
    _map_wb(out, sd, "context_embedder", "context_embedder")
    out["norm_out.linear.weight"] = \
        _swap_chunks(sd["final_layer.adaLN_modulation.1.weight"])
    out["norm_out.linear.bias"] = \
        _swap_chunks(sd["final_layer.adaLN_modulation.1.bias"])
    _map_wb(out, sd, "proj_out", "final_layer.linear")
    _map_wb(out, sd, "time_text_embed.timestep_embedder.linear_1",
            "t_embedder.mlp.0")
    _map_wb(out, sd, "time_text_embed.timestep_embedder.linear_2",
            "t_embedder.mlp.2")
    _map_wb(out, sd, "time_text_embed.text_embedder.linear_1",
            "y_embedder.mlp.0")
    _map_wb(out, sd, "time_text_embed.text_embedder.linear_2",
            "y_embedder.mlp.2")

    i = 0
    while f"joint_blocks.{i}.x_block.attn.qkv.weight" in sd:
        ip, op = f"joint_blocks.{i}", f"transformer_blocks.{i}"
        is_last = f"joint_blocks.{i + 1}.x_block.attn.qkv.weight" not in sd
        for wb in ("weight", "bias"):
            _split3(out, sd, f"{ip}.x_block.attn.qkv.{wb}",
                    [f"{op}.attn.to_q.{wb}", f"{op}.attn.to_k.{wb}",
                     f"{op}.attn.to_v.{wb}"])
            _split3(out, sd, f"{ip}.context_block.attn.qkv.{wb}",
                    [f"{op}.attn.add_q_proj.{wb}", f"{op}.attn.add_k_proj.{wb}",
                     f"{op}.attn.add_v_proj.{wb}"])
        _map_wb(out, sd, f"{op}.attn.to_out.0", f"{ip}.x_block.attn.proj")
        _map_wb(out, sd, f"{op}.norm1.linear", f"{ip}.x_block.adaLN_modulation.1")
        if not is_last:
            _map_wb(out, sd, f"{op}.attn.to_add_out",
                    f"{ip}.context_block.attn.proj")
            _map_wb(out, sd, f"{op}.norm1_context.linear",
                    f"{ip}.context_block.adaLN_modulation.1")
            _map_wb(out, sd, f"{op}.ff_context.net.0.proj",
                    f"{ip}.context_block.mlp.fc1")
            _map_wb(out, sd, f"{op}.ff_context.net.2",
                    f"{ip}.context_block.mlp.fc2")
        else:
            out[f"{op}.norm1_context.linear.weight"] = \
                _swap_chunks(sd[f"{ip}.context_block.adaLN_modulation.1.weight"])
            out[f"{op}.norm1_context.linear.bias"] = \
                _swap_chunks(sd[f"{ip}.context_block.adaLN_modulation.1.bias"])
        if f"{ip}.x_block.attn.ln_q.weight" in sd:
            out[f"{op}.attn.norm_q.weight"] = sd[f"{ip}.x_block.attn.ln_q.weight"]
            out[f"{op}.attn.norm_k.weight"] = sd[f"{ip}.x_block.attn.ln_k.weight"]
        if f"{ip}.context_block.attn.ln_q.weight" in sd:
            out[f"{op}.attn.norm_added_q.weight"] = \
                sd[f"{ip}.context_block.attn.ln_q.weight"]
            out[f"{op}.attn.norm_added_k.weight"] = \
                sd[f"{ip}.context_block.attn.ln_k.weight"]
        _map_wb(out, sd, f"{op}.ff.net.0.proj", f"{ip}.x_block.mlp.fc1")
        _map_wb(out, sd, f"{op}.ff.net.2", f"{ip}.x_block.mlp.fc2")
        i += 1
    return out


# -- HunyuanVideo (original-repo ckpt layout) -----------------------------------------

def hunyuan_transformer_to_ckpt(sd: dict, prefix: str = "model.model") -> dict:
    """diffusers HunyuanVideoTransformer3DModel keys -> original-repo ckpt
    keys (reference: convert_hunyuan_video_diffusers_to_ckpt.py:64-149)."""
    out: dict = {}

    def put(ok, ik):
        out[_combine(prefix, ok)] = sd[ik]

    def put_wb(op, ip):
        for wb in ("weight", "bias"):
            put(f"{op}.{wb}", f"{ip}.{wb}")

    put_wb("txt_in.c_embedder.in_layer",
           "context_embedder.time_text_embed.text_embedder.linear_1")
    put_wb("txt_in.c_embedder.out_layer",
           "context_embedder.time_text_embed.text_embedder.linear_2")
    put_wb("txt_in.t_embedder.in_layer",
           "context_embedder.time_text_embed.timestep_embedder.linear_1")
    put_wb("txt_in.t_embedder.out_layer",
           "context_embedder.time_text_embed.timestep_embedder.linear_2")
    put_wb("txt_in.input_embedder", "context_embedder.proj_in")
    out[_combine(prefix, "final_layer.adaLN_modulation.1.weight")] = \
        _swap_chunks(sd["norm_out.linear.weight"])
    out[_combine(prefix, "final_layer.adaLN_modulation.1.bias")] = \
        _swap_chunks(sd["norm_out.linear.bias"])
    put_wb("final_layer.linear", "proj_out")
    if "time_text_embed.guidance_embedder.linear_1.weight" in sd:
        # guidance-distilled models only (guidance_embeds=False variants
        # like SkyReels ship without these)
        put_wb("guidance_in.in_layer",
               "time_text_embed.guidance_embedder.linear_1")
        put_wb("guidance_in.out_layer",
               "time_text_embed.guidance_embedder.linear_2")
    put_wb("vector_in.in_layer", "time_text_embed.text_embedder.linear_1")
    put_wb("vector_in.out_layer", "time_text_embed.text_embedder.linear_2")
    put_wb("time_in.in_layer", "time_text_embed.timestep_embedder.linear_1")
    put_wb("time_in.out_layer", "time_text_embed.timestep_embedder.linear_2")
    put_wb("img_in.proj", "x_embedder.proj")

    i = 0
    while f"context_embedder.token_refiner.refiner_blocks.{i}.attn.to_q.weight" in sd:
        ip = f"context_embedder.token_refiner.refiner_blocks.{i}"
        op = f"txt_in.individual_token_refiner.blocks.{i}"
        for wb in ("weight", "bias"):
            out[_combine(prefix, f"{op}.self_attn.qkv.{wb}")] = _cat(sd, [
                f"{ip}.attn.to_q.{wb}", f"{ip}.attn.to_k.{wb}",
                f"{ip}.attn.to_v.{wb}"])
        put_wb(f"{op}.self_attn.proj", f"{ip}.attn.to_out.0")
        put_wb(f"{op}.mlp.0", f"{ip}.ff.net.0.proj")
        put_wb(f"{op}.mlp.2", f"{ip}.ff.net.2")
        put_wb(f"{op}.adaLN_modulation.1", f"{ip}.norm_out.linear")
        put_wb(f"{op}.norm1", f"{ip}.norm1")
        put_wb(f"{op}.norm2", f"{ip}.norm2")
        i += 1

    i = 0
    while f"transformer_blocks.{i}.attn.to_q.weight" in sd:
        ip, op = f"transformer_blocks.{i}", f"double_blocks.{i}"
        for wb in ("weight", "bias"):
            out[_combine(prefix, f"{op}.img_attn.qkv.{wb}")] = _cat(sd, [
                f"{ip}.attn.to_q.{wb}", f"{ip}.attn.to_k.{wb}",
                f"{ip}.attn.to_v.{wb}"])
            out[_combine(prefix, f"{op}.txt_attn.qkv.{wb}")] = _cat(sd, [
                f"{ip}.attn.add_q_proj.{wb}", f"{ip}.attn.add_k_proj.{wb}",
                f"{ip}.attn.add_v_proj.{wb}"])
        put(f"{op}.img_attn.norm.query_norm.scale", f"{ip}.attn.norm_q.weight")
        put(f"{op}.img_attn.norm.key_norm.scale", f"{ip}.attn.norm_k.weight")
        put(f"{op}.txt_attn.norm.query_norm.scale",
            f"{ip}.attn.norm_added_q.weight")
        put(f"{op}.txt_attn.norm.key_norm.scale",
            f"{ip}.attn.norm_added_k.weight")
        put_wb(f"{op}.img_attn.proj", f"{ip}.attn.to_out.0")
        put_wb(f"{op}.img_mlp.0", f"{ip}.ff.net.0.proj")
        put_wb(f"{op}.img_mlp.2", f"{ip}.ff.net.2")
        put_wb(f"{op}.img_mod.lin", f"{ip}.norm1.linear")
        put_wb(f"{op}.txt_attn.proj", f"{ip}.attn.to_add_out")
        put_wb(f"{op}.txt_mlp.0", f"{ip}.ff_context.net.0.proj")
        put_wb(f"{op}.txt_mlp.2", f"{ip}.ff_context.net.2")
        put_wb(f"{op}.txt_mod.lin", f"{ip}.norm1_context.linear")
        i += 1

    i = 0
    while f"single_transformer_blocks.{i}.attn.to_q.weight" in sd:
        ip, op = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        for wb in ("weight", "bias"):
            out[_combine(prefix, f"{op}.linear1.{wb}")] = _cat(sd, [
                f"{ip}.attn.to_q.{wb}", f"{ip}.attn.to_k.{wb}",
                f"{ip}.attn.to_v.{wb}", f"{ip}.proj_mlp.{wb}"])
        put(f"{op}.norm.query_norm.scale", f"{ip}.attn.norm_q.weight")
        put(f"{op}.norm.key_norm.scale", f"{ip}.attn.norm_k.weight")
        put_wb(f"{op}.linear2", f"{ip}.proj_out")
        put_wb(f"{op}.modulation.lin", f"{ip}.norm.linear")
        i += 1
    return out


def hunyuan_ckpt_to_transformer(sd: dict, prefix: str = "model.model") -> dict:
    """Inverse of hunyuan_transformer_to_ckpt (original ckpt -> diffusers)."""
    sd = {k[len(prefix) + 1:] if prefix and k.startswith(prefix + ".") else k: v
          for k, v in sd.items()}
    out: dict = {}

    def put_wb(op, ip):
        for wb in ("weight", "bias"):
            out[f"{op}.{wb}"] = sd[f"{ip}.{wb}"]

    put_wb("context_embedder.time_text_embed.text_embedder.linear_1",
           "txt_in.c_embedder.in_layer")
    put_wb("context_embedder.time_text_embed.text_embedder.linear_2",
           "txt_in.c_embedder.out_layer")
    put_wb("context_embedder.time_text_embed.timestep_embedder.linear_1",
           "txt_in.t_embedder.in_layer")
    put_wb("context_embedder.time_text_embed.timestep_embedder.linear_2",
           "txt_in.t_embedder.out_layer")
    put_wb("context_embedder.proj_in", "txt_in.input_embedder")
    out["norm_out.linear.weight"] = _swap_chunks(
        sd["final_layer.adaLN_modulation.1.weight"])
    out["norm_out.linear.bias"] = _swap_chunks(
        sd["final_layer.adaLN_modulation.1.bias"])
    put_wb("proj_out", "final_layer.linear")
    if "guidance_in.in_layer.weight" in sd:
        put_wb("time_text_embed.guidance_embedder.linear_1",
               "guidance_in.in_layer")
        put_wb("time_text_embed.guidance_embedder.linear_2",
               "guidance_in.out_layer")
    put_wb("time_text_embed.text_embedder.linear_1", "vector_in.in_layer")
    put_wb("time_text_embed.text_embedder.linear_2", "vector_in.out_layer")
    put_wb("time_text_embed.timestep_embedder.linear_1", "time_in.in_layer")
    put_wb("time_text_embed.timestep_embedder.linear_2", "time_in.out_layer")
    put_wb("x_embedder.proj", "img_in.proj")

    i = 0
    while f"txt_in.individual_token_refiner.blocks.{i}.self_attn.qkv.weight" in sd:
        ip = f"txt_in.individual_token_refiner.blocks.{i}"
        op = f"context_embedder.token_refiner.refiner_blocks.{i}"
        for wb in ("weight", "bias"):
            _split3(out, sd, f"{ip}.self_attn.qkv.{wb}", [
                f"{op}.attn.to_q.{wb}", f"{op}.attn.to_k.{wb}",
                f"{op}.attn.to_v.{wb}"])
        put_wb(f"{op}.attn.to_out.0", f"{ip}.self_attn.proj")
        put_wb(f"{op}.ff.net.0.proj", f"{ip}.mlp.0")
        put_wb(f"{op}.ff.net.2", f"{ip}.mlp.2")
        put_wb(f"{op}.norm_out.linear", f"{ip}.adaLN_modulation.1")
        put_wb(f"{op}.norm1", f"{ip}.norm1")
        put_wb(f"{op}.norm2", f"{ip}.norm2")
        i += 1

    i = 0
    while f"double_blocks.{i}.img_attn.qkv.weight" in sd:
        ip, op = f"double_blocks.{i}", f"transformer_blocks.{i}"
        for wb in ("weight", "bias"):
            _split3(out, sd, f"{ip}.img_attn.qkv.{wb}", [
                f"{op}.attn.to_q.{wb}", f"{op}.attn.to_k.{wb}",
                f"{op}.attn.to_v.{wb}"])
            _split3(out, sd, f"{ip}.txt_attn.qkv.{wb}", [
                f"{op}.attn.add_q_proj.{wb}", f"{op}.attn.add_k_proj.{wb}",
                f"{op}.attn.add_v_proj.{wb}"])
        out[f"{op}.attn.norm_q.weight"] = sd[f"{ip}.img_attn.norm.query_norm.scale"]
        out[f"{op}.attn.norm_k.weight"] = sd[f"{ip}.img_attn.norm.key_norm.scale"]
        out[f"{op}.attn.norm_added_q.weight"] = \
            sd[f"{ip}.txt_attn.norm.query_norm.scale"]
        out[f"{op}.attn.norm_added_k.weight"] = \
            sd[f"{ip}.txt_attn.norm.key_norm.scale"]
        put_wb(f"{op}.attn.to_out.0", f"{ip}.img_attn.proj")
        put_wb(f"{op}.ff.net.0.proj", f"{ip}.img_mlp.0")
        put_wb(f"{op}.ff.net.2", f"{ip}.img_mlp.2")
        put_wb(f"{op}.norm1.linear", f"{ip}.img_mod.lin")
        put_wb(f"{op}.attn.to_add_out", f"{ip}.txt_attn.proj")
        put_wb(f"{op}.ff_context.net.0.proj", f"{ip}.txt_mlp.0")
        put_wb(f"{op}.ff_context.net.2", f"{ip}.txt_mlp.2")
        put_wb(f"{op}.norm1_context.linear", f"{ip}.txt_mod.lin")
        i += 1

    i = 0
    while f"single_blocks.{i}.linear1.weight" in sd:
        ip, op = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        hidden = sd[f"{ip}.linear2.weight"].shape[0]
        for wb in ("weight", "bias"):
            q, k, v, mlp = _split_single_linear1(sd[f"{ip}.linear1.{wb}"], hidden)
            out[f"{op}.attn.to_q.{wb}"] = q
            out[f"{op}.attn.to_k.{wb}"] = k
            out[f"{op}.attn.to_v.{wb}"] = v
            out[f"{op}.proj_mlp.{wb}"] = mlp
        out[f"{op}.attn.norm_q.weight"] = sd[f"{ip}.norm.query_norm.scale"]
        out[f"{op}.attn.norm_k.weight"] = sd[f"{ip}.norm.key_norm.scale"]
        put_wb(f"{op}.proj_out", f"{ip}.linear2")
        put_wb(f"{op}.norm.linear", f"{ip}.modulation.lin")
        i += 1
    return out


# -- PixArt (the original repository's single-file layout) ---------------------------

def pixart_transformer_to_ckpt(sd: dict) -> dict:
    """diffusers PixArtTransformer2DModel -> the original PixArt repository's
    keys (reference: convert_pixart_diffusers_to_ckpt.py:10-110; the
    y_embedding and pos_embed buffers are generated downstream)."""
    out: dict = {}
    _map_wb(out, sd, "y_embedder.y_proj.fc1", "caption_projection.linear_1")
    _map_wb(out, sd, "y_embedder.y_proj.fc2", "caption_projection.linear_2")
    _map_wb(out, sd, "x_embedder.proj", "pos_embed.proj")
    _map_wb(out, sd, "t_embedder.mlp.0", "adaln_single.emb.timestep_embedder.linear_1")
    _map_wb(out, sd, "t_embedder.mlp.2", "adaln_single.emb.timestep_embedder.linear_2")
    _map_wb(out, sd, "t_block.1", "adaln_single.linear")
    # α-1024's micro-condition embedders, where the model has them
    if "adaln_single.emb.aspect_ratio_embedder.linear_1.weight" in sd:
        _map_wb(out, sd, "ar_embedder.mlp.0", "adaln_single.emb.aspect_ratio_embedder.linear_1")
        _map_wb(out, sd, "ar_embedder.mlp.2", "adaln_single.emb.aspect_ratio_embedder.linear_2")
        _map_wb(out, sd, "csize_embedder.mlp.0", "adaln_single.emb.resolution_embedder.linear_1")
        _map_wb(out, sd, "csize_embedder.mlp.2", "adaln_single.emb.resolution_embedder.linear_2")
    i = 0
    while f"transformer_blocks.{i}.attn1.to_q.weight" in sd:
        ip, op = f"transformer_blocks.{i}", f"blocks.{i}"
        for wb in ("weight", "bias"):
            out[f"{op}.attn.qkv.{wb}"] = _cat(sd, [
                f"{ip}.attn1.to_q.{wb}", f"{ip}.attn1.to_k.{wb}", f"{ip}.attn1.to_v.{wb}"])
            out[f"{op}.cross_attn.kv_linear.{wb}"] = _cat(sd, [
                f"{ip}.attn2.to_k.{wb}", f"{ip}.attn2.to_v.{wb}"])
        _map_wb(out, sd, f"{op}.attn.proj", f"{ip}.attn1.to_out.0")
        _map_wb(out, sd, f"{op}.cross_attn.q_linear", f"{ip}.attn2.to_q")
        _map_wb(out, sd, f"{op}.cross_attn.proj", f"{ip}.attn2.to_out.0")
        _map_wb(out, sd, f"{op}.mlp.fc1", f"{ip}.ff.net.0.proj")
        _map_wb(out, sd, f"{op}.mlp.fc2", f"{ip}.ff.net.2")
        out[f"{op}.scale_shift_table"] = sd[f"{ip}.scale_shift_table"]
        i += 1
    _map_wb(out, sd, "final_layer.linear", "proj_out")
    out["final_layer.scale_shift_table"] = sd["scale_shift_table"]
    return out


def pixart_ckpt_to_transformer(sd: dict) -> dict:
    """Inverse of pixart_transformer_to_ckpt (generated buffers dropped)."""
    out: dict = {}
    _map_wb(out, sd, "caption_projection.linear_1", "y_embedder.y_proj.fc1")
    _map_wb(out, sd, "caption_projection.linear_2", "y_embedder.y_proj.fc2")
    _map_wb(out, sd, "pos_embed.proj", "x_embedder.proj")
    _map_wb(out, sd, "adaln_single.emb.timestep_embedder.linear_1", "t_embedder.mlp.0")
    _map_wb(out, sd, "adaln_single.emb.timestep_embedder.linear_2", "t_embedder.mlp.2")
    _map_wb(out, sd, "adaln_single.linear", "t_block.1")
    if "ar_embedder.mlp.0.weight" in sd:
        _map_wb(out, sd, "adaln_single.emb.aspect_ratio_embedder.linear_1", "ar_embedder.mlp.0")
        _map_wb(out, sd, "adaln_single.emb.aspect_ratio_embedder.linear_2", "ar_embedder.mlp.2")
        _map_wb(out, sd, "adaln_single.emb.resolution_embedder.linear_1", "csize_embedder.mlp.0")
        _map_wb(out, sd, "adaln_single.emb.resolution_embedder.linear_2", "csize_embedder.mlp.2")
    i = 0
    while f"blocks.{i}.attn.qkv.weight" in sd:
        ip, op = f"blocks.{i}", f"transformer_blocks.{i}"
        for wb in ("weight", "bias"):
            _split3(out, sd, f"{ip}.attn.qkv.{wb}",
                    [f"{op}.attn1.to_q.{wb}", f"{op}.attn1.to_k.{wb}", f"{op}.attn1.to_v.{wb}"])
            _split3(out, sd, f"{ip}.cross_attn.kv_linear.{wb}",
                    [f"{op}.attn2.to_k.{wb}", f"{op}.attn2.to_v.{wb}"])
        _map_wb(out, sd, f"{op}.attn1.to_out.0", f"{ip}.attn.proj")
        _map_wb(out, sd, f"{op}.attn2.to_q", f"{ip}.cross_attn.q_linear")
        _map_wb(out, sd, f"{op}.attn2.to_out.0", f"{ip}.cross_attn.proj")
        _map_wb(out, sd, f"{op}.ff.net.0.proj", f"{ip}.mlp.fc1")
        _map_wb(out, sd, f"{op}.ff.net.2", f"{ip}.mlp.fc2")
        out[f"{op}.scale_shift_table"] = sd[f"{ip}.scale_shift_table"]
        i += 1
    _map_wb(out, sd, "proj_out", "final_layer.linear")
    out["scale_shift_table"] = sd["final_layer.scale_shift_table"]
    return out


def _strip_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# -- configs from shapes ---------------------------------------------------------------

def _count(sd: dict, prefix: str) -> int:
    """1 + the largest integer key token after `prefix` (0 when none)."""
    return 1 + max((int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)),
                   default=-1)


def _rope_axes(head_dim: int) -> tuple:
    """The published (16, 56, 56) at head width 128; at other widths (the
    tests' tiny models) three even axes summing to it."""
    if head_dim == 128:
        return (16, 56, 56)
    side = 2 * (head_dim // 6)
    return (head_dim - 2 * side, side, side)


def _infer_clip_config(hf_sd: dict, compute_dtype) -> CLIPTextConfig:
    """CLIP text config from a transformers-format state dict's shapes (the
    reference's rules: 64-wide heads, quick_gelu at width 768; the end
    token the vocabulary's last, as CLIP's 49407)."""
    vocab, hidden = hf_sd["text_model.embeddings.token_embedding.weight"].shape
    proj = hf_sd.get("text_projection.weight")
    return CLIPTextConfig(
        vocab_size=int(vocab), hidden_size=int(hidden),
        intermediate_size=int(hf_sd["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0]),
        num_layers=_count(hf_sd, "text_model.encoder.layers."),
        num_heads=max(int(hidden) // 64, 1),
        max_position_embeddings=int(
            hf_sd["text_model.embeddings.position_embedding.weight"].shape[0]),
        hidden_act="quick_gelu" if hidden == 768 else "gelu",
        projection_dim=int(proj.shape[0]) if proj is not None else None,
        eos_token_id=int(vocab) - 1,
        dtype=compute_dtype)


def _infer_t5_config(hf_sd: dict, compute_dtype):
    """T5 encoder config from its shapes; the head count from the relative
    position bias (T5-XXL: 64 heads of 64)."""
    from onetrainer_tpu_torch.io.sd3_checkpoints import t5_config_from_transformers
    inner = int(hf_sd["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0])
    bias = hf_sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    heads = int(bias.shape[1])
    return t5_config_from_transformers({
        "vocab_size": int(hf_sd["shared.weight"].shape[0]),
        "d_model": int(hf_sd["shared.weight"].shape[1]),
        "d_ff": int(hf_sd["encoder.block.0.layer.1.DenseReluDense.wi_0.weight"].shape[0]),
        "num_layers": _count(hf_sd, "encoder.block."),
        "d_kv": inner // heads, "num_heads": heads,
        "relative_attention_num_buckets": int(bias.shape[0]),
    }, compute_dtype)


def _single_file_te_params(tensors: dict, compute_dtype) -> dict:
    """{clip_l, clip_g, t5xxl: (config, state dict) or (None, None)} from
    the SAI `text_encoders.<name>.transformer.*` keys."""
    from onetrainer_tpu_torch.io.sd3_checkpoints import t5_state_dict
    out = {}
    for name, infer in (("clip_l", _infer_clip_config), ("clip_g", _infer_clip_config),
                        ("t5xxl", _infer_t5_config)):
        sub = _strip_prefix(tensors, f"text_encoders.{name}.transformer.")
        if name == "t5xxl":
            sub = t5_state_dict(sub)
        out[name] = (infer(sub, compute_dtype), sub) if sub else (None, None)
    return out


# the VAE's prefixes, the reference's doubled one (F14) first
_VAE_PREFIXES = ("first_stage_model.first_stage_model.", "vae.first_stage_model.",
                 "first_stage_model.", "vae.")


def _single_file_vae(tensors: dict, compute_dtype, scaling_factor, shift_factor):
    """(config, diffusers state dict) of a bundled LDM VAE, or (None, None).
    The keys map with the reference's four-level table; the config follows
    the converted tensors' shapes."""
    prefix = next((p for p in _VAE_PREFIXES if any(k.startswith(p) for k in tensors)), None)
    if prefix is None:
        return None, None
    sd = ldm.convert_vae_ldm_to_diffusers(tensors, prefix=prefix)
    levels = _count(sd, "encoder.down_blocks.")
    cfg = VAEConfig(
        in_channels=int(sd["encoder.conv_in.weight"].shape[1]),
        out_channels=int(sd["decoder.conv_out.weight"].shape[0]),
        latent_channels=int(sd["decoder.conv_in.weight"].shape[1]),
        block_out_channels=tuple(
            int(sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"].shape[0])
            for i in range(levels)),
        layers_per_block=_count(sd, "encoder.down_blocks.0.resnets."),
        scaling_factor=scaling_factor, shift_factor=shift_factor, dtype=compute_dtype)
    return cfg, sd


def _missing(present: dict) -> None:
    for name, ok in present.items():
        if not ok:
            print(f"{name} not in single-file checkpoint, continuing without it")


# -- loaders ---------------------------------------------------------------------------

def load_sd3_single_file(path: str, weight_dtype=torch.float32,
                         compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                         device: torch.device | str = "cuda") -> dict:
    """SAI single-file SD3/3.5 checkpoint (`model.diffusion_model.*` MMDiT,
    `first_stage_model.*` VAE, `text_encoders.*`) -> the dict
    load_sd3_diffusers returns."""
    from onetrainer_tpu_torch.io.sd3_checkpoints import (
        _refuse_dual_attention, sd3_config_from_diffusers,
    )
    tensors = _read_single_file(path, device, weight_dtype)
    sai = _strip_prefix(tensors, "model.diffusion_model.")
    _refuse_dual_attention(sai)
    sd = sd3_sai_to_transformer(sai)
    del sai
    caption_dim = int(sd["context_embedder.weight"].shape[0])
    qk_norm = "transformer_blocks.0.attn.norm_q.weight" in sd
    head_dim = int(sd["transformer_blocks.0.attn.norm_q.weight"].shape[0]) if qk_norm \
        else 64
    pos = sd.get("pos_embed.pos_embed")
    proj = sd["pos_embed.proj.weight"]
    tcfg = sd3_config_from_diffusers({
        "num_layers": _count(sd, "transformer_blocks."),
        "in_channels": int(proj.shape[1]), "out_channels": int(proj.shape[1]),
        "patch_size": int(proj.shape[-1]),
        "num_attention_heads": max(caption_dim // head_dim, 1),
        "attention_head_dim": min(head_dim, caption_dim),
        "caption_projection_dim": caption_dim,
        "joint_attention_dim": int(sd["context_embedder.weight"].shape[1]),
        "pooled_projection_dim": int(
            sd["time_text_embed.text_embedder.linear_1.weight"].shape[1]),
        "pos_embed_max_size": int(round(pos.shape[-2] ** 0.5))
        if pos is not None and pos.dim() >= 2 else 192,
        "qk_norm": "rms_norm" if qk_norm else None,
    }, compute_dtype, gradient_checkpointing)

    vae_cfg, vae = _single_file_vae(tensors, compute_dtype, 1.5305, 0.0609)
    tes = _single_file_te_params(tensors, compute_dtype)
    del tensors
    _missing({"vae": vae is not None, "clip_l": tes["clip_l"][1] is not None,
              "clip_g": tes["clip_g"][1] is not None,
              "t5xxl": tes["t5xxl"][1] is not None})
    from onetrainer_tpu_torch.io.sd3_checkpoints import t5_config_from_transformers
    from onetrainer_tpu_torch.models.sd3_model import sd3_vae_config
    return {
        "transformer_config": tcfg,
        "vae_config": vae_cfg or sd3_vae_config(compute_dtype),
        "te_config": tes["clip_l"][0] or clip_config_from_transformers(
            {"projection_dim": 768, "architectures": ["CLIPTextModelWithProjection"]},
            compute_dtype),
        "te2_config": tes["clip_g"][0] or clip_config_from_transformers(
            {"hidden_size": 1280, "intermediate_size": 5120, "num_hidden_layers": 32,
             "num_attention_heads": 20, "hidden_act": "gelu", "projection_dim": 1280,
             "architectures": ["CLIPTextModelWithProjection"]}, compute_dtype),
        "te3_config": tes["t5xxl"][0] or t5_config_from_transformers({}, compute_dtype),
        "transformer": sd,
        "vae": vae,
        "text_encoder": tes["clip_l"][1],
        "text_encoder_2": tes["clip_g"][1],
        "text_encoder_3": tes["t5xxl"][1],
        "tokenizer_dir": None,
        "tokenizer_2_dir": None,
        "tokenizer_3_dir": None,
        "prediction_type": "flow",
    }


_BFL_KEYS = ("double_blocks.", "single_blocks.", "img_in.", "txt_in.", "time_in.",
             "vector_in.", "guidance_in.", "final_layer.")


def load_flux_single_file(path: str, weight_dtype=torch.float32,
                          compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                          device: torch.device | str = "cuda") -> dict:
    """BFL single-file FLUX checkpoint (the transformer's keys bare or
    under `model.diffusion_model.`; a VAE and text encoders when bundled)
    -> the dict load_flux_diffusers returns. FLUX.1-fill's 384-wide
    `img_in` follows from its shape."""
    from onetrainer_tpu_torch.io.flux_checkpoints import flux_config_from_diffusers
    from onetrainer_tpu_torch.io.sd3_checkpoints import t5_config_from_transformers
    tensors = _read_single_file(path, device, weight_dtype)
    bfl = _strip_prefix(tensors, "model.diffusion_model.")
    if not any(k.startswith("double_blocks.") for k in bfl):
        bfl = {k: v for k, v in tensors.items() if k.startswith(_BFL_KEYS)}
    sd = flux_bfl_to_transformer(bfl)
    hidden = int(sd["transformer_blocks.0.attn.to_q.weight"].shape[0])
    head_dim = int(sd["transformer_blocks.0.attn.norm_q.weight"].shape[0])
    tcfg = flux_config_from_diffusers({
        "in_channels": int(sd["x_embedder.weight"].shape[1]),
        "out_channels": int(sd["proj_out.weight"].shape[0]),
        "num_layers": _count(sd, "transformer_blocks."),
        "num_single_layers": _count(sd, "single_transformer_blocks."),
        "num_attention_heads": hidden // head_dim, "attention_head_dim": head_dim,
        "joint_attention_dim": int(sd["context_embedder.weight"].shape[1]),
        "pooled_projection_dim": int(
            sd["time_text_embed.text_embedder.linear_1.weight"].shape[1]),
        "guidance_embeds": "time_text_embed.guidance_embedder.linear_1.weight" in sd,
        "axes_dims_rope": _rope_axes(head_dim),
    }, compute_dtype, gradient_checkpointing)

    vae_cfg, vae = _single_file_vae(tensors, compute_dtype, 0.3611, 0.1159)
    tes = _single_file_te_params(tensors, compute_dtype)
    del tensors, bfl
    _missing({"vae": vae is not None,
              "text encoder 1 (clip l)": tes["clip_l"][1] is not None,
              "text encoder 2 (t5)": tes["t5xxl"][1] is not None})
    from onetrainer_tpu_torch.models.sd3_model import sd3_vae_config
    return {
        "transformer_config": tcfg,
        "vae_config": vae_cfg or VAEConfig(**{
            **sd3_vae_config(compute_dtype).__dict__, "scaling_factor": 0.3611,
            "shift_factor": 0.1159}),
        "te_config": tes["clip_l"][0] or clip_config_from_transformers({}, compute_dtype),
        "te2_config": tes["t5xxl"][0] or t5_config_from_transformers({}, compute_dtype),
        "transformer": sd,
        "vae": vae,
        "text_encoder": tes["clip_l"][1],
        "text_encoder_2": tes["t5xxl"][1],
        "tokenizer_dir": None,
        "tokenizer_2_dir": None,
        "prediction_type": "flow",
    }


def load_hunyuan_single_file(path: str, weight_dtype=torch.float32,
                             compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                             device: torch.device | str = "cuda") -> dict:
    """HunyuanVideo original-repo single file (the transformer under
    `model.model.` or bare; the port's own files bundle the video VAE
    under `vae.`, Llama and CLIP-L under `text_encoders.<llama|clip_l>.
    transformer.`) -> the dict load_hunyuan_diffusers returns."""
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import (
        hunyuan_config_from_diffusers, hunyuan_transformer_state_dict,
        llama_config_from_transformers, video_vae_config_from_diffusers,
    )
    tensors = _read_single_file(path, device, weight_dtype)
    prefix = "model.model" if any(k.startswith("model.model.") for k in tensors) else ""
    transformer_keys = {k: v for k, v in tensors.items()
                        if not k.startswith(("vae.", "text_encoders."))}
    sd = hunyuan_ckpt_to_transformer(transformer_keys, prefix=prefix)
    xw = sd["x_embedder.proj.weight"]
    hidden, in_ch = int(xw.shape[0]), int(xw.shape[1])
    head_dim = int(sd["transformer_blocks.0.attn.norm_q.weight"].shape[0]) \
        if "transformer_blocks.0.attn.norm_q.weight" in sd else 128
    tcfg = hunyuan_config_from_diffusers({
        "num_layers": _count(sd, "transformer_blocks."),
        "num_single_layers": _count(sd, "single_transformer_blocks."),
        "num_refiner_layers": _count(sd, "context_embedder.token_refiner.refiner_blocks."),
        "in_channels": in_ch,
        "out_channels": int(sd["proj_out.weight"].shape[0]) // 4,  # t_patch 1, 2x2 patches
        "num_attention_heads": hidden // head_dim,
        "attention_head_dim": head_dim,
        "text_embed_dim": int(sd["context_embedder.proj_in.weight"].shape[1]),
        "pooled_projection_dim": int(
            sd["time_text_embed.text_embedder.linear_1.weight"].shape[1]),
        "guidance_embeds": "time_text_embed.guidance_embedder.linear_1.weight" in sd,
        "rope_axes_dim": _rope_axes(head_dim),
    }, compute_dtype, gradient_checkpointing)

    vae = _strip_prefix(tensors, "vae.") or None
    llama = _strip_prefix(tensors, "text_encoders.llama.transformer.") or None
    clip = _strip_prefix(tensors, "text_encoders.clip_l.transformer.") or None
    del tensors, transformer_keys
    _missing({"vae": vae is not None, "text encoder 1 (llama)": llama is not None,
              "text encoder 2 (clip l)": clip is not None})
    vae_cfg = video_vae_config_from_diffusers({}, compute_dtype)
    if vae is not None:
        levels = _count(vae, "encoder.down_blocks.")
        vae_cfg = video_vae_config_from_diffusers({
            "in_channels": int(vae["encoder.conv_in.weight"].shape[1]),
            "latent_channels": int(vae["decoder.conv_in.weight"].shape[1]),
            "block_out_channels": [int(vae[f"encoder.down_blocks.{i}.0.conv1.weight"].shape[0])
                                   for i in range(levels)],
            "layers_per_block": len({k.split(".")[3] for k in vae
                                     if k.startswith("encoder.down_blocks.0.")
                                     and k.endswith(".conv1.weight")}),
        }, compute_dtype)
    llama_cfg = llama_config_from_transformers({}, compute_dtype)
    if llama is not None:
        q = llama["layers.0.self_attn.q_proj.weight"]
        kv = llama["layers.0.self_attn.k_proj.weight"]
        # Llama-3's 128-wide heads; a narrower model's head width is the
        # widest that divides both projections
        head = 128 if q.shape[0] % 128 == 0 and kv.shape[0] % 128 == 0 \
            else math.gcd(int(q.shape[0]), int(kv.shape[0]))
        llama_cfg = llama_config_from_transformers({
            "vocab_size": int(llama["embed_tokens.weight"].shape[0]),
            "hidden_size": int(llama["embed_tokens.weight"].shape[1]),
            "intermediate_size": int(llama["layers.0.mlp.gate_proj.weight"].shape[0]),
            "num_hidden_layers": _count(llama, "layers."),
            "num_attention_heads": int(q.shape[0]) // head,
            "num_key_value_heads": int(kv.shape[0]) // head,
            "head_dim": head,
        }, compute_dtype)
    return {
        "transformer_config": tcfg,
        "vae_config": vae_cfg,
        "te_config": llama_cfg,
        "te2_config": _infer_clip_config(clip, compute_dtype) if clip is not None
        else clip_config_from_transformers({}, compute_dtype),
        "transformer": hunyuan_transformer_state_dict(sd),
        "vae": vae,
        "text_encoder": llama,
        "text_encoder_2": clip,
        "tokenizer_dir": None,
        "tokenizer_2_dir": None,
        "prediction_type": "flow",
    }


def load_pixart_single_file(path: str, weight_dtype=torch.float32,
                            compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                            device: torch.device | str = "cuda") -> dict:
    """The original PixArt repository's single file (the transformer alone;
    reference: PixArtAlphaModelLoader's ckpt path) -> the dict
    load_pixart_diffusers returns, the VAE and T5 None. The config is the
    reference's reading of the shapes: 16 heads, the micro-conditions when
    the file has their embedders."""
    from onetrainer_tpu_torch.io.pixart_checkpoints import pixart_config_from_diffusers
    from onetrainer_tpu_torch.io.sd3_checkpoints import t5_config_from_transformers
    from onetrainer_tpu_torch.models.vae import sd15_vae_config
    sd = pixart_ckpt_to_transformer(_read_single_file(path, device, weight_dtype))
    hidden = int(sd["transformer_blocks.0.attn1.to_q.weight"].shape[0])
    tcfg = pixart_config_from_diffusers({
        "num_layers": _count(sd, "transformer_blocks."),
        "in_channels": int(sd["pos_embed.proj.weight"].shape[1]),
        "out_channels": int(sd["proj_out.weight"].shape[0]) // 4,
        "num_attention_heads": 16, "attention_head_dim": hidden // 16,
        "use_additional_conditions":
            "adaln_single.emb.aspect_ratio_embedder.linear_1.weight" in sd,
    }, compute_dtype, gradient_checkpointing)
    _missing({"vae": False, "text encoder (t5)": False})
    return {
        "transformer_config": tcfg,
        "vae_config": sd15_vae_config(dtype=compute_dtype),
        "te_config": t5_config_from_transformers({}, compute_dtype),
        "transformer": sd,
        "vae": None,
        "text_encoder": None,
        "tokenizer_dir": None,
        "prediction_type": "epsilon",
    }


# -- savers ----------------------------------------------------------------------------

def _prefixed(prefix: str, sd: dict | None) -> dict:
    return {} if sd is None else {f"{prefix}{k}": v for k, v in sd.items()}


def _ldm_vae(vae: dict | None) -> dict:
    """A diffusers VAE's tensors under SAI's `first_stage_model.` keys, mapped
    with the reference's four-level table."""
    return {} if vae is None else ldm.convert_vae_diffusers_to_ldm(vae)


def save_sd3_single_file(path: str, transformer: dict, vae: dict | None, te: dict | None,
                         te2: dict | None, te3: dict | None, save_dtype=torch.float32,
                         metadata: dict | None = None) -> None:
    """The SAI layout: the MMDiT under `model.diffusion_model.`, the VAE
    under `first_stage_model.`, CLIP-L, CLIP-G and T5 under
    `text_encoders.<clip_l|clip_g|t5xxl>.transformer.` (reference:
    setup/families.py:_sd3_save_single_file); each part given."""
    sd = _prefixed("model.diffusion_model.", sd3_transformer_to_sai(_cast(transformer,
                                                                          save_dtype)))
    sd.update(_ldm_vae(None if vae is None else _cast(vae, save_dtype)))
    for name, part in (("clip_l", te), ("clip_g", te2), ("t5xxl", te3)):
        if part is not None:
            sd.update(_prefixed(f"text_encoders.{name}.transformer.", _cast(part, save_dtype)))
    save_safetensors(path, sd, _meta(metadata))


def save_flux_single_file(path: str, transformer: dict, vae: dict | None, te: dict | None,
                          te2: dict | None, save_dtype=torch.float32,
                          metadata: dict | None = None) -> None:
    """The BFL transformer keys (reference: setup/families.py:
    _flux_save_single_file), with the VAE and CLIP-L and T5 bundled under
    SD3's prefixes when given."""
    sd = flux_transformer_to_bfl(_cast(transformer, save_dtype))
    sd.update(_ldm_vae(None if vae is None else _cast(vae, save_dtype)))
    for name, part in (("clip_l", te), ("t5xxl", te2)):
        if part is not None:
            sd.update(_prefixed(f"text_encoders.{name}.transformer.", _cast(part, save_dtype)))
    save_safetensors(path, sd, _meta(metadata))


def save_hunyuan_single_file(path: str, transformer: dict, vae: dict | None,
                             te: dict | None, te2: dict | None, save_dtype=torch.float32,
                             metadata: dict | None = None) -> None:
    """The original repository's transformer keys under `model.model.`
    (reference: setup/families.py:_hunyuan_save_single_file), with the
    video VAE, Llama and CLIP-L bundled under `vae.` and
    `text_encoders.<llama|clip_l>.transformer.` when given."""
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import hunyuan_diffusers_state_dict
    sd = hunyuan_transformer_to_ckpt(
        hunyuan_diffusers_state_dict(_cast(transformer, save_dtype)))
    sd.update(_prefixed("vae.", None if vae is None else _cast(vae, save_dtype)))
    for name, part in (("llama", te), ("clip_l", te2)):
        if part is not None:
            sd.update(_prefixed(f"text_encoders.{name}.transformer.", _cast(part, save_dtype)))
    save_safetensors(path, sd, _meta(metadata))


def save_pixart_single_file(path: str, transformer: dict, save_dtype=torch.float32,
                            metadata: dict | None = None) -> None:
    """The original repository's transformer keys, the transformer alone
    (reference: setup/families.py:_pixart_save_single_file)."""
    save_safetensors(path, pixart_transformer_to_ckpt(_cast(transformer, save_dtype)),
                     _meta(metadata))


# -- Stable Cascade (the stage_c single-file layout) ----------------------------------

def cascade_prior_to_ckpt(sd: dict) -> dict:
    """diffusers StableCascadeUNet keys -> stage_c.safetensors keys: to_q,
    to_k and to_v fused into attention.attn.in_proj_*, to_out.0 renamed
    attn.out_proj; every other key as it is (reference:
    convert_stable_cascade_diffusers_to_ckpt.py:32-50)."""
    out: dict = {}
    for key, value in sd.items():
        if ".attention.to_out.0." in key:
            out[key.replace(".attention.to_out.0.", ".attention.attn.out_proj.")] = value
        elif ".attention.to_q." in key:
            base, wb = key.rsplit(".", 1)
            stem = base[: -len(".attention.to_q")]
            suffix = "in_proj_weight" if wb == "weight" else "in_proj_bias"
            out[f"{stem}.attention.attn.{suffix}"] = _cat(sd, [
                f"{stem}.attention.to_q.{wb}", f"{stem}.attention.to_k.{wb}",
                f"{stem}.attention.to_v.{wb}"])
        elif ".attention.to_k." in key or ".attention.to_v." in key:
            continue
        else:
            out[key] = value
    return out


def cascade_ckpt_to_prior(sd: dict) -> dict:
    """Inverse of cascade_prior_to_ckpt (stage_c -> diffusers)."""
    out: dict = {}
    for key, value in sd.items():
        if ".attention.attn.out_proj." in key:
            out[key.replace(".attention.attn.out_proj.", ".attention.to_out.0.")] = value
        elif key.endswith((".attention.attn.in_proj_weight", ".attention.attn.in_proj_bias")):
            stem = key[: key.index(".attention.attn.in_proj_")]
            wb = "weight" if key.endswith("weight") else "bias"
            _split3(out, sd, key, [f"{stem}.attention.to_q.{wb}", f"{stem}.attention.to_k.{wb}",
                                   f"{stem}.attention.to_v.{wb}"])
        else:
            out[key] = value
    return out


def _cascade_text_encoder_path(path: str) -> str:
    return os.path.join(os.path.dirname(path) or ".", "text_encoder.safetensors")


def load_cascade_single_file(path: str, weight_dtype=torch.float32,
                             compute_dtype=torch.bfloat16, gradient_checkpointing=False,
                             device: torch.device | str = "cuda",
                             effnet_path: str | None = None) -> dict:
    """Stable Cascade's stage_c.safetensors (fused in_proj attention keys;
    reference: WuerstchenModelLoader's single-file branch) -> the dict
    io/wuerstchen_checkpoints.py:load_wuerstchen_diffusers returns. The
    config is the reference's reading of the shapes (64-wide heads, the
    block counts, the CLIP widths), but for the latent channels: the
    head's rows are (a, b), twice the latent's channels, where the
    reference takes a quarter of them (8 for stage C's 16; ROADMAP F28). A
    sibling text_encoder.safetensors
    loads when present (else the text encoder is None), its config read
    from its shapes, where the reference reads its width alone and keeps
    CLIP-L's depth (ROADMAP F29); the effnet from `effnet_path`."""
    from onetrainer_tpu_torch.io.wuerstchen_checkpoints import (
        load_effnet, prior_config_from_diffusers,
    )
    from onetrainer_tpu_torch.models.wuerstchen import EffnetConfig
    sd = cascade_ckpt_to_prior(_read_single_file(path, device, weight_dtype))
    hidden0 = int(sd["embedding.1.weight"].shape[0])
    down = sd.get("down_downscalers.1.1.blocks.0.weight")
    hidden1 = int(down.shape[0]) if down is not None else hidden0
    pcfg = prior_config_from_diffusers({
        "_class_name": "StableCascadeUNet",
        "in_channels": int(sd["clf.1.weight"].shape[0]) // 2,   # (a, b): ROADMAP F28
        "block_out_channels": (hidden0, hidden1),
        "num_attention_heads": (hidden0 // 64, hidden1 // 64),
        "down_num_layers_per_block": (_count(sd, "down_blocks.0.") // 3,
                                      _count(sd, "down_blocks.1.") // 3),
        "clip_text_in_channels": int(sd["clip_txt_mapper.weight"].shape[1]),
        "clip_text_pooled_in_channels": int(sd["clip_txt_pooled_mapper.weight"].shape[1]),
        "clip_image_in_channels": int(sd["clip_img_mapper.weight"].shape[1]),
    }, compute_dtype, gradient_checkpointing)
    te_path = _cascade_text_encoder_path(path)
    te = None
    if os.path.isfile(te_path):
        te = _read_single_file(te_path, device, weight_dtype)
    else:
        print("text_encoder.safetensors not found next to stage_c, "
              "continuing without the text encoder")
    return {
        "prior_config": pcfg,
        "effnet_config": EffnetConfig(dtype=compute_dtype),
        "te_config": _infer_clip_config(te, compute_dtype) if te is not None
        else clip_config_from_transformers({}, compute_dtype),
        "prior": sd,
        "effnet": load_effnet(effnet_path, device, weight_dtype),
        "text_encoder": te,
        "tokenizer_dir": None,
        "prediction_type": "epsilon",
    }


def save_cascade_single_file(path: str, prior: dict, te: dict | None,
                             save_dtype=torch.float32, metadata: dict | None = None) -> None:
    """Stable Cascade's single-file export (reference:
    setup/families.py:_wuerstchen_save_single_file): the prior as
    stage_c.safetensors with fused attention keys and the text encoder
    beside it as text_encoder.safetensors. A `*.safetensors` path is the
    stage_c file, anything else a directory for both."""
    if path.endswith(".safetensors"):
        stage_c = path
    else:
        os.makedirs(path, exist_ok=True)
        stage_c = os.path.join(path, "stage_c.safetensors")
    save_safetensors(stage_c, cascade_prior_to_ckpt(_cast(prior, save_dtype)),
                     metadata or {})
    if te is not None:
        save_safetensors(_cascade_text_encoder_path(stage_c), _cast(te, save_dtype),
                         metadata or {})
