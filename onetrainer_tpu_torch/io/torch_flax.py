"""Mechanical torch(diffusers/transformers) ↔ flax parameter conversion.

The port's own copy of the numpy key maps in onetrainer_tpu/io/torch_flax.py
(the JAX package's scan-layer stacking helpers, which need jax, are left
out). The port uses it to carry the JAX package's flax trees into its
modules and to name LoRA adapters by their flax module path.

The JAX package's flax modules name their submodules after the
torch module tree (list indices merged: `down_blocks.0` → `down_blocks_0`),
so conversion reduces to a path transform plus per-leaf layout changes:

  conv weight   OIHW → HWIO kernel
  linear weight [out,in] → [in,out] kernel
  norm weight   → scale
  embeddings    → table kept as-is

Both directions are exact inverses; weight round-trip fidelity is the
contract that keeps checkpoints drop-in compatible with the PyTorch
ecosystem (reference weight contract: modules/modelLoader/mixin/
HFModelLoaderMixin.py, modules/modelSaver/mixin/DtypeModelSaverMixin.py).
"""

from __future__ import annotations

import numpy as np


def merge_int_tokens(key: str) -> tuple[str, ...]:
    """'down_blocks.0.resnets.1.conv1.weight' ->
    ('down_blocks_0', 'resnets_1', 'conv1', 'weight')"""
    out: list[str] = []
    for token in key.split('.'):
        if token.isdigit() and out:
            out[-1] = f"{out[-1]}_{token}"
        else:
            out.append(token)
    return tuple(out)


# torch attribute names that contain a literal underscore+digit and must
# NOT be split back into list indices (diffusers TimestepEmbedding etc.)
_KEEP_UNDERSCORE = frozenset({'linear_1', 'linear_2', 'norm_1', 'norm_2',
                              'wi_0', 'wi_1', 'w1_a', 'w1_b', 'w2_a', 'w2_b'})


def split_int_tokens(path: tuple[str, ...]) -> str:
    """Inverse of merge_int_tokens: 'down_blocks_0' -> 'down_blocks.0'."""
    tokens: list[str] = []
    for part in path:
        if part in _KEEP_UNDERSCORE:
            tokens.append(part)
            continue
        pieces = part.split('_')
        rebuilt = pieces[0]
        for p in pieces[1:]:
            if p.isdigit():
                rebuilt += f".{p}"
            else:
                rebuilt += f"_{p}"
        tokens.append(rebuilt)
    return '.'.join(tokens)


def torch_to_flax_leaf(path: tuple[str, ...], tensor: np.ndarray,
                       embedding_paths: frozenset[tuple[str, ...]] = frozenset(),
                       ) -> tuple[tuple[str, ...], np.ndarray]:
    """Map one torch state-dict entry to (flax path, flax array)."""
    *parents, leaf = path
    parents = tuple(parents)
    if path in embedding_paths or parents in embedding_paths:
        # embedding table: drop the '.weight' leaf, keep layout
        return parents if leaf == 'weight' else path, tensor
    if leaf == 'weight':
        if tensor.ndim == 4:      # conv OIHW -> HWIO
            return parents + ('kernel',), tensor.transpose(2, 3, 1, 0)
        if tensor.ndim == 2:      # linear [out,in] -> [in,out]
            return parents + ('kernel',), tensor.transpose(1, 0)
        if tensor.ndim == 1:      # group/layer norm
            return parents + ('scale',), tensor
        if tensor.ndim == 5:      # conv3d OIDHW -> DHWIO
            return parents + ('kernel',), tensor.transpose(2, 3, 4, 1, 0)
    if leaf == 'bias':
        return parents + ('bias',), tensor
    return path, tensor


def flax_to_torch_leaf(path: tuple[str, ...], tensor: np.ndarray,
                       embedding_paths: frozenset[tuple[str, ...]] = frozenset(),
                       ) -> tuple[str, np.ndarray]:
    """Inverse of torch_to_flax_leaf, producing a torch state-dict key."""
    *parents, leaf = path
    parents = tuple(parents)
    if tuple(path) in embedding_paths:
        return split_int_tokens(path) + '.weight', tensor
    if leaf == 'kernel':
        if tensor.ndim == 4:
            return split_int_tokens(parents) + '.weight', tensor.transpose(3, 2, 0, 1)
        if tensor.ndim == 2:
            return split_int_tokens(parents) + '.weight', tensor.transpose(1, 0)
        if tensor.ndim == 5:
            return split_int_tokens(parents) + '.weight', tensor.transpose(4, 3, 0, 1, 2)
    if leaf == 'scale':
        return split_int_tokens(parents) + '.weight', tensor
    if leaf == 'bias':
        return split_int_tokens(parents) + '.bias', tensor
    return split_int_tokens(path), tensor


def _nest(flat: dict[tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def _flatten(tree: dict, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    flat: dict[tuple[str, ...], np.ndarray] = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def torch_state_dict_to_flax(
        state_dict: dict[str, np.ndarray],
        key_map=None,
        embedding_paths: frozenset[tuple[str, ...]] = frozenset(),
) -> dict:
    """Convert a flat torch state dict to a nested flax param tree.

    key_map: optional fn(torch_key) -> torch_key | None applied first
    (strip prefixes, rename, or drop entries by returning None).
    """
    flat: dict[tuple[str, ...], np.ndarray] = {}
    for key, tensor in state_dict.items():
        if key_map is not None:
            key = key_map(key)
            if key is None:
                continue
        path = merge_int_tokens(key)
        flax_path, arr = torch_to_flax_leaf(path, np.asarray(tensor), embedding_paths)
        flat[flax_path] = arr
    return _nest(flat)


def flax_params_to_torch(
        params: dict,
        key_map=None,
        embedding_paths: frozenset[tuple[str, ...]] = frozenset(),
) -> dict[str, np.ndarray]:
    """Convert a nested flax param tree back to a flat torch state dict."""
    out: dict[str, np.ndarray] = {}
    for path, tensor in _flatten(params).items():
        key, arr = flax_to_torch_leaf(path, tensor, embedding_paths)
        if key_map is not None:
            key = key_map(key)
            if key is None:
                continue
        out[key] = arr
    return out


# -- per-model adapters ----------------------------------------------------------

# CLIP text (transformers CLIPTextModel[WithProjection]) — strip the
# text_model prefix and flatten the embeddings container.
_CLIP_EMBEDDING_PATHS = frozenset({
    ('token_embedding',),
    ('position_embedding',),
})


def clip_torch_key_map(key: str) -> str | None:
    if key == 'text_model.embeddings.position_ids':
        return None
    key = key.replace('text_model.', '')
    key = key.replace('embeddings.token_embedding', 'token_embedding')
    key = key.replace('embeddings.position_embedding', 'position_embedding')
    key = key.replace('encoder.layers.', 'layers.')
    return key


def clip_flax_key_map(key: str) -> str:
    if key.startswith('token_embedding') or key.startswith('position_embedding'):
        return 'text_model.embeddings.' + key
    if key.startswith('layers.'):
        return 'text_model.encoder.' + key
    if key.startswith('text_projection'):
        return key
    return 'text_model.' + key


def clip_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    return torch_state_dict_to_flax(
        state_dict, key_map=clip_torch_key_map, embedding_paths=_CLIP_EMBEDDING_PATHS)


def clip_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(
        params, key_map=clip_flax_key_map, embedding_paths=_CLIP_EMBEDDING_PATHS)


# UNet / VAE (diffusers) — names match 1:1 after int merging; to_out.0 and
# ff.net.0/2 merge into to_out_0 / net_0 / net_2 automatically.
def unet_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    return torch_state_dict_to_flax(state_dict)


def unet_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    return flax_params_to_torch(params)


vae_state_dict_to_flax = unet_state_dict_to_flax
vae_flax_to_state_dict = unet_flax_to_state_dict


# T5 encoder (transformers T5EncoderModel) — structural rename, RMS-norm
# weights stay named 'weight', relative bias table keeps layout.
_T5_EMBEDDING_PATHS = frozenset({('shared',)})


def t5_torch_key_map(key: str) -> str | None:
    if key == 'shared.weight':
        return 'shared.weight'
    if key.startswith('encoder.embed_tokens'):
        return None  # duplicate of shared
    key = key.replace('encoder.block.', 'block.')
    key = key.replace('.layer.0.SelfAttention.relative_attention_bias.weight',
                      '.attention.relative_attention_bias#table')
    key = key.replace('.layer.0.SelfAttention.', '.attention.')
    key = key.replace('.layer.0.layer_norm.weight', '.ln_attn.weight#norm')
    key = key.replace('.layer.1.DenseReluDense.', '.')
    key = key.replace('.layer.1.layer_norm.weight', '.ln_mlp.weight#norm')
    key = key.replace('encoder.final_layer_norm.weight',
                      'final_layer_norm.weight#norm')
    return key


def t5_state_dict_to_flax(state_dict: dict[str, np.ndarray]) -> dict:
    flat: dict[tuple[str, ...], np.ndarray] = {}
    for key, tensor in state_dict.items():
        key = t5_torch_key_map(key)
        if key is None:
            continue
        tensor = np.asarray(tensor)
        if key.endswith('#table'):
            path = merge_int_tokens(key[:-6])
            flat[path] = tensor  # [buckets, heads], no transpose
        elif key.endswith('#norm'):
            path = merge_int_tokens(key[:-5])
            flat[path] = tensor  # T5LayerNorm param is literally 'weight'
        else:
            path = merge_int_tokens(key)
            flax_path, arr = torch_to_flax_leaf(path, tensor, _T5_EMBEDDING_PATHS)
            flat[flax_path] = arr
    return _nest(flat)


def t5_flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for path, tensor in _flatten(params).items():
        if path == ('shared',):
            out['shared.weight'] = tensor
            continue
        if path[-1] == 'relative_attention_bias':
            key = 'encoder.' + split_int_tokens(path[:-1]).replace(
                'attention', 'layer.0.SelfAttention') + \
                '.relative_attention_bias.weight'
            out[key] = tensor
            continue
        if path[-1] == 'weight':  # RMS norms
            parent = split_int_tokens(path[:-1])
            if parent.endswith('ln_attn'):
                key = 'encoder.' + parent[:-len('ln_attn')] + 'layer.0.layer_norm.weight'
            elif parent.endswith('ln_mlp'):
                key = 'encoder.' + parent[:-len('ln_mlp')] + 'layer.1.layer_norm.weight'
            elif parent == 'final_layer_norm':
                key = 'encoder.final_layer_norm.weight'
            else:
                key = 'encoder.' + parent + '.weight'
            out[key] = tensor
            continue
        key, arr = flax_to_torch_leaf(path, tensor)
        key = 'encoder.' + key
        key = key.replace('.attention.', '.layer.0.SelfAttention.')
        for mlp in ('wi_0', 'wi_1', 'wo'):
            key = key.replace(f'.{mlp}.weight', f'.layer.1.DenseReluDense.{mlp}.weight')
        key = key.replace('encoder.block.', 'encoder.block.')
        out[key] = arr
    return out
