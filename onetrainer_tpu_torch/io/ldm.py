"""LDM single-file checkpoint <-> diffusers key conversion.

Copy of onetrainer_tpu/io/ldm.py (tests/test_torch_port_copies.py holds it
to the original). The maps move tensors as they are: torch tensors (on
any device) or numpy arrays, the four array operations (fuse and unfuse
the open_clip attention projection, the constants the open_clip tower
carries) done in the values' own library.

The weight-format contract the reference implements with per-family
tables (reference: modules/util/convert/convert_sd_diffusers_to_ckpt.py,
convert_sdxl_diffusers_to_ckpt.py and the loaders' reverse path). Here
the maps are *generated* from the block structure so one implementation
covers SD1.5/2.x and SDXL single-file checkpoints:

  model.diffusion_model.*       <-> unet
  first_stage_model.*           <-> vae
  cond_stage_model.transformer.*            <-> text_encoder (SD1.x, HF layout)
  cond_stage_model.model.*                  <-> text_encoder (SD2.x, open_clip)
  conditioner.embedders.0.transformer.*     <-> text_encoder   (SDXL)
  conditioner.embedders.1.model.*           <-> text_encoder_2 (SDXL, open_clip)
"""

from __future__ import annotations

import numpy as np
import torch


# -- UNet ---------------------------------------------------------------------------

_RESNET_RENAMES = [
    ("norm1", "in_layers.0"),
    ("conv1", "in_layers.2"),
    ("time_emb_proj", "emb_layers.1"),
    ("norm2", "out_layers.0"),
    ("conv2", "out_layers.3"),
    ("conv_shortcut", "skip_connection"),
]


def unet_key_map(num_blocks: int = 4, layers_per_block: int = 2,
                 attn_blocks: tuple[bool, ...] = (True, True, True, False),
                 ) -> dict[str, str]:
    """diffusers unet key-prefix -> ldm key-prefix."""
    m: dict[str, str] = {
        "time_embedding.linear_1": "time_embed.0",
        "time_embedding.linear_2": "time_embed.2",
        "add_embedding.linear_1": "label_emb.0.0",
        "add_embedding.linear_2": "label_emb.0.2",
        "conv_in": "input_blocks.0.0",
        "conv_norm_out": "out.0",
        "conv_out": "out.2",
        "mid_block.resnets.0": "middle_block.0",
        "mid_block.attentions.0": "middle_block.1",
        "mid_block.resnets.1": "middle_block.2",
    }
    per = layers_per_block + 1  # input blocks per level (incl. downsample)
    for i in range(num_blocks):
        for j in range(layers_per_block):
            idx = i * per + j + 1
            m[f"down_blocks.{i}.resnets.{j}"] = f"input_blocks.{idx}.0"
            if attn_blocks[i]:
                m[f"down_blocks.{i}.attentions.{j}"] = f"input_blocks.{idx}.1"
        if i != num_blocks - 1:
            m[f"down_blocks.{i}.downsamplers.0.conv"] = \
                f"input_blocks.{(i + 1) * per}.0.op"
    up_per = layers_per_block + 1
    rev_attn = list(reversed(attn_blocks))
    for i in range(num_blocks):
        for j in range(up_per):
            idx = i * up_per + j
            m[f"up_blocks.{i}.resnets.{j}"] = f"output_blocks.{idx}.0"
            if rev_attn[i]:
                m[f"up_blocks.{i}.attentions.{j}"] = f"output_blocks.{idx}.1"
        if i != num_blocks - 1:
            last = i * up_per + up_per - 1
            suffix = 2 if rev_attn[i] else 1
            m[f"up_blocks.{i}.upsamplers.0.conv"] = \
                f"output_blocks.{last}.{suffix}.conv"
    # resnet-internal renames composed onto the block maps
    expanded = {}
    for dk, lk in m.items():
        expanded[dk] = lk
        if "resnets" in dk or lk.startswith("middle_block.0") or \
                lk.startswith("middle_block.2") or ".0" == lk[-2:]:
            pass
    return m


def _apply_unet_leaf_renames(rest: str, to_ldm: bool) -> str:
    pairs = _RESNET_RENAMES if to_ldm else [(b, a) for a, b in _RESNET_RENAMES]
    for a, b in pairs:
        if rest == a or rest.startswith(a + "."):
            return b + rest[len(a):]
    return rest


def convert_unet_diffusers_to_ldm(sd: dict, num_blocks=4, layers_per_block=2,
                                  attn_blocks=(True, True, True, False),
                                  prefix="model.diffusion_model.") -> dict:
    m = unet_key_map(num_blocks, layers_per_block, attn_blocks)
    # longest prefixes first
    ordered = sorted(m.items(), key=lambda kv: -len(kv[0]))
    out = {}
    for key, value in sd.items():
        for dk, lk in ordered:
            if key == dk or key.startswith(dk + "."):
                rest = key[len(dk):].lstrip(".")
                is_resnet = ("resnets" in dk) or lk in (
                    "middle_block.0", "middle_block.2")
                if is_resnet and rest:
                    rest = _apply_unet_leaf_renames(rest, to_ldm=True)
                out[prefix + lk + ("." + rest if rest else "")] = value
                break
        else:
            out[prefix + key] = value
    return out


def convert_unet_ldm_to_diffusers(sd: dict, num_blocks=4, layers_per_block=2,
                                  attn_blocks=(True, True, True, False),
                                  prefix="model.diffusion_model.") -> dict:
    m = unet_key_map(num_blocks, layers_per_block, attn_blocks)
    rev = sorted(((lk, dk) for dk, lk in m.items()), key=lambda kv: -len(kv[0]))
    out = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        for lk, dk in rev:
            if key == lk or key.startswith(lk + "."):
                rest = key[len(lk):].lstrip(".")
                is_resnet = ("resnets" in dk) or lk in (
                    "middle_block.0", "middle_block.2")
                if is_resnet and rest:
                    rest = _apply_unet_leaf_renames(rest, to_ldm=False)
                out[dk + ("." + rest if rest else "")] = value
                break
        else:
            out[key] = value
    return out


# -- VAE ----------------------------------------------------------------------------

_VAE_RESNET_RENAMES = [("conv_shortcut", "nin_shortcut")]
_VAE_ATTN_RENAMES = [
    ("group_norm", "norm"), ("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
    ("to_out.0", "proj_out"),
]


def vae_key_map(num_blocks: int = 4, layers_per_block: int = 2) -> dict[str, str]:
    m: dict[str, str] = {
        "encoder.conv_in": "encoder.conv_in",
        "encoder.conv_norm_out": "encoder.norm_out",
        "encoder.conv_out": "encoder.conv_out",
        "decoder.conv_in": "decoder.conv_in",
        "decoder.conv_norm_out": "decoder.norm_out",
        "decoder.conv_out": "decoder.conv_out",
        "quant_conv": "quant_conv",
        "post_quant_conv": "post_quant_conv",
        "encoder.mid_block.resnets.0": "encoder.mid.block_1",
        "encoder.mid_block.attentions.0": "encoder.mid.attn_1",
        "encoder.mid_block.resnets.1": "encoder.mid.block_2",
        "decoder.mid_block.resnets.0": "decoder.mid.block_1",
        "decoder.mid_block.attentions.0": "decoder.mid.attn_1",
        "decoder.mid_block.resnets.1": "decoder.mid.block_2",
    }
    for i in range(num_blocks):
        for j in range(layers_per_block):
            m[f"encoder.down_blocks.{i}.resnets.{j}"] = f"encoder.down.{i}.block.{j}"
        if i != num_blocks - 1:
            m[f"encoder.down_blocks.{i}.downsamplers.0.conv"] = \
                f"encoder.down.{i}.downsample.conv"
    for i in range(num_blocks):
        ldm_i = num_blocks - 1 - i  # decoder up blocks are reversed in ldm
        for j in range(layers_per_block + 1):
            m[f"decoder.up_blocks.{i}.resnets.{j}"] = \
                f"decoder.up.{ldm_i}.block.{j}"
        if i != num_blocks - 1:
            m[f"decoder.up_blocks.{i}.upsamplers.0.conv"] = \
                f"decoder.up.{ldm_i}.upsample.conv"
    return m


def _vae_leaf(rest: str, is_attn: bool, to_ldm: bool, value):
    pairs = (_VAE_ATTN_RENAMES if is_attn else _VAE_RESNET_RENAMES)
    if not to_ldm:
        pairs = [(b, a) for a, b in pairs]
    for a, b in pairs:
        if rest == a or rest.startswith(a + "."):
            rest = b + rest[len(a):]
            break
    # ldm attention q/k/v/proj_out are 1x1 convs, diffusers are linear
    if is_attn and rest.endswith("weight") and not rest.startswith("norm"):
        if to_ldm and value.ndim == 2:
            value = value.reshape(value.shape[0], value.shape[1], 1, 1)
        elif not to_ldm and value.ndim == 4:
            value = value.reshape(value.shape[0], value.shape[1])
    return rest, value


def convert_vae_diffusers_to_ldm(sd: dict, num_blocks=4, layers_per_block=2,
                                 prefix="first_stage_model.") -> dict:
    m = vae_key_map(num_blocks, layers_per_block)
    ordered = sorted(m.items(), key=lambda kv: -len(kv[0]))
    out = {}
    for key, value in sd.items():
        for dk, lk in ordered:
            if key == dk or key.startswith(dk + "."):
                rest = key[len(dk):].lstrip(".")
                is_attn = "attentions" in dk or "attn" in lk
                if rest:
                    rest, value = _vae_leaf(rest, is_attn, True, value)
                out[prefix + lk + ("." + rest if rest else "")] = value
                break
        else:
            out[prefix + key] = value
    return out


def convert_vae_ldm_to_diffusers(sd: dict, num_blocks=4, layers_per_block=2,
                                 prefix="first_stage_model.") -> dict:
    m = vae_key_map(num_blocks, layers_per_block)
    rev = sorted(((lk, dk) for dk, lk in m.items()), key=lambda kv: -len(kv[0]))
    out = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        for lk, dk in rev:
            if key == lk or key.startswith(lk + "."):
                rest = key[len(lk):].lstrip(".")
                is_attn = "attentions" in dk or "attn" in lk
                if rest:
                    rest, value = _vae_leaf(rest, is_attn, False, value)
                out[dk + ("." + rest if rest else "")] = value
                break
        else:
            out[key] = value
    return out


# -- open_clip text encoder <-> HF CLIP ------------------------------------------------

def _ones_like(ref, shape: tuple):
    """Ones of `shape` in `ref`'s library, dtype (and device)."""
    if isinstance(ref, torch.Tensor):
        return torch.ones(shape, dtype=ref.dtype, device=ref.device)
    return np.ones(shape, dtype=ref.dtype)


def convert_openclip_to_hf(sd: dict, prefix: str) -> dict:
    """open_clip text tower -> transformers CLIPTextModel keys.
    Unpacks the fused attn in_proj into q/k/v."""
    out = {}
    for key, value in sd.items():
        if not key.startswith(prefix):
            continue
        key = key[len(prefix):]
        if key.startswith("transformer.resblocks."):
            rest = key[len("transformer.resblocks."):]
            layer, _, leaf = rest.partition(".")
            base = f"text_model.encoder.layers.{layer}."
            if leaf.startswith("attn.in_proj_"):
                kind = leaf.split("_")[-1]  # weight / bias
                n = value.shape[0] // 3
                q, k, v = value[:n], value[n:2 * n], value[2 * n:]
                out[base + f"self_attn.q_proj.{kind}"] = q
                out[base + f"self_attn.k_proj.{kind}"] = k
                out[base + f"self_attn.v_proj.{kind}"] = v
            elif leaf.startswith("attn.out_proj"):
                out[base + "self_attn.out_proj" + leaf[len("attn.out_proj"):]] = value
            elif leaf.startswith("ln_1"):
                out[base + "layer_norm1" + leaf[4:]] = value
            elif leaf.startswith("ln_2"):
                out[base + "layer_norm2" + leaf[4:]] = value
            elif leaf.startswith("mlp.c_fc"):
                out[base + "mlp.fc1" + leaf[len("mlp.c_fc"):]] = value
            elif leaf.startswith("mlp.c_proj"):
                out[base + "mlp.fc2" + leaf[len("mlp.c_proj"):]] = value
        elif key.startswith("token_embedding"):
            out["text_model.embeddings.token_embedding" +
                key[len("token_embedding"):]] = value
        elif key == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = value
        elif key.startswith("ln_final"):
            out["text_model.final_layer_norm" + key[len("ln_final"):]] = value
        elif key == "text_projection":
            # open_clip stores [hidden, proj]; HF linear is [proj, hidden]
            out["text_projection.weight"] = value.transpose(1, 0)
        elif key == "text_projection.weight":
            out["text_projection.weight"] = value
    return out


def convert_hf_to_openclip(sd: dict, prefix: str) -> dict:
    """transformers CLIPTextModel keys -> open_clip text tower."""
    out = {}
    packs: dict[str, dict] = {}
    for key, value in sd.items():
        if key.startswith("text_model.encoder.layers."):
            rest = key[len("text_model.encoder.layers."):]
            layer, _, leaf = rest.partition(".")
            base = f"{prefix}transformer.resblocks.{layer}."
            if leaf.startswith("self_attn.") and ("q_proj" in leaf or
                                                  "k_proj" in leaf or "v_proj" in leaf):
                kind = "weight" if leaf.endswith("weight") else "bias"
                which = leaf.split(".")[1][0]  # q/k/v
                packs.setdefault(base + f"attn.in_proj_{kind}", {})[which] = value
            elif leaf.startswith("self_attn.out_proj"):
                out[base + "attn.out_proj" + leaf[len("self_attn.out_proj"):]] = value
            elif leaf.startswith("layer_norm1"):
                out[base + "ln_1" + leaf[len("layer_norm1"):]] = value
            elif leaf.startswith("layer_norm2"):
                out[base + "ln_2" + leaf[len("layer_norm2"):]] = value
            elif leaf.startswith("mlp.fc1"):
                out[base + "mlp.c_fc" + leaf[len("mlp.fc1"):]] = value
            elif leaf.startswith("mlp.fc2"):
                out[base + "mlp.c_proj" + leaf[len("mlp.fc2"):]] = value
        elif key.startswith("text_model.embeddings.token_embedding"):
            out[prefix + "token_embedding" +
                key[len("text_model.embeddings.token_embedding"):]] = value
        elif key == "text_model.embeddings.position_embedding.weight":
            out[prefix + "positional_embedding"] = value
        elif key.startswith("text_model.final_layer_norm"):
            out[prefix + "ln_final" + key[len("text_model.final_layer_norm"):]] = value
        elif key == "text_projection.weight":
            # open_clip applies x @ text_projection, HF's Linear applies
            # x @ W.T — the open_clip tensor is the HF weight TRANSPOSED.
            # The reference's converter omits this transpose
            # (convert_sdxl_diffusers_to_ckpt.py:131) even though its own
            # loader goes through diffusers' transposing open_clip->HF
            # conversion, so a reference round trip silently flips the
            # (square) CLIP-G projection. Deliberate deviation: we match
            # open_clip/diffusers semantics, not the reference bug
            # (tests/test_reference_goldens_ldm.py).
            out[prefix + "text_projection"] = value.transpose(1, 0)
    for key, qkv in packs.items():
        parts = [qkv["q"], qkv["k"], qkv["v"]]
        out[key] = torch.cat(parts) if isinstance(parts[0], torch.Tensor) \
            else np.concatenate(parts, axis=0)
    # constants the reference converter always writes
    # (convert_sdxl_diffusers_to_ckpt.py:132, convert_sd_diffusers_to_
    # ckpt.py:135-136): tools reading the open_clip tower expect them
    any_val = next(iter(out.values()))
    out.setdefault(prefix + "logit_scale", _ones_like(any_val, ()))
    if prefix + "text_projection" not in out:
        hidden = sd["text_model.final_layer_norm.weight"].shape[0]
        out[prefix + "text_projection"] = _ones_like(any_val, (hidden, hidden))
    return out


# -- whole-checkpoint entry points ------------------------------------------------------

def split_sd15_single_file(sd: dict) -> dict[str, dict]:
    """LDM single file -> {'unet', 'vae', 'text_encoder'} diffusers dicts."""
    unet = convert_unet_ldm_to_diffusers(sd)
    vae = convert_vae_ldm_to_diffusers(sd)
    te = {}
    for key, value in sd.items():
        if key.startswith("cond_stage_model.transformer."):
            te[key[len("cond_stage_model.transformer."):]] = value
    if not te:  # SD2.x open_clip tower
        te = convert_openclip_to_hf(sd, "cond_stage_model.model.")
    return {"unet": unet, "vae": vae, "text_encoder": te}


def merge_sd15_single_file(unet: dict, vae: dict, te: dict,
                           sd2_openclip: bool = False) -> dict:
    out = {}
    out.update(convert_unet_diffusers_to_ldm(unet))
    out.update(convert_vae_diffusers_to_ldm(vae))
    if sd2_openclip:
        out.update(convert_hf_to_openclip(te, "cond_stage_model.model."))
    else:
        for key, value in te.items():
            out["cond_stage_model.transformer." + key] = value
    return out


SDXL_ATTN_BLOCKS = (False, True, True)


def split_sdxl_single_file(sd: dict) -> dict[str, dict]:
    unet = convert_unet_ldm_to_diffusers(
        sd, num_blocks=3, layers_per_block=2, attn_blocks=SDXL_ATTN_BLOCKS)
    vae = convert_vae_ldm_to_diffusers(sd)
    te1 = {k[len("conditioner.embedders.0.transformer."):]: v
           for k, v in sd.items()
           if k.startswith("conditioner.embedders.0.transformer.")}
    te2 = convert_openclip_to_hf(sd, "conditioner.embedders.1.model.")
    return {"unet": unet, "vae": vae, "text_encoder": te1, "text_encoder_2": te2}


def merge_sdxl_single_file(unet: dict, vae: dict, te1: dict, te2: dict) -> dict:
    out = {}
    out.update(convert_unet_diffusers_to_ldm(
        unet, num_blocks=3, layers_per_block=2, attn_blocks=SDXL_ATTN_BLOCKS))
    out.update(convert_vae_diffusers_to_ldm(vae))
    for key, value in te1.items():
        out["conditioner.embedders.0.transformer." + key] = value
    out.update(convert_hf_to_openclip(te2, "conditioner.embedders.1.model."))
    return out
