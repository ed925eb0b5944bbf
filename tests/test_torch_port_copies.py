"""The port's own copies of the reference's framework-free modules agree
with the originals: configs (onetrainer_tpu/config), enums
(onetrainer_tpu/util/enums.py), model names (util/model_names.py), the CLIP
and Gemma tokenizer wrappers (setup/tokenizer.py), the torch<->flax key maps
(io/torch_flax.py; Sana's, Gemma's and DC-AE's in io/sana_checkpoints.py),
and the copies the train and sample entry points
brought: the LDM key maps (io/ldm.py), modelspec metadata
(util/model_spec.py), bucketing, concepts and augmentations (data/), the
trainer's base class, progress, timed actions, callbacks, commands and
path helpers. The port imports none of these from the JAX package; these
tests hold the copies to them exactly (the verbatim ones by their code,
the adapted ones by their results).
"""

import ast
import enum
import os
import random

import numpy as np
import pytest
import torch

from onetrainer_tpu.config.concept_config import ConceptConfig
from onetrainer_tpu.config.sample_config import SampleConfig
from onetrainer_tpu.config.train_config import TrainConfig
from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.setup.tokenizer import SDTokenizer
from onetrainer_tpu.util import enums as jax_enums
from onetrainer_tpu_torch.config.concept_config import ConceptConfig as PortConceptConfig
from onetrainer_tpu_torch.config.sample_config import SampleConfig as PortSampleConfig
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.io import torch_flax as pt_tf
from onetrainer_tpu_torch.setup.tokenizer import SDTokenizer as PortSDTokenizer
from onetrainer_tpu_torch.util import enums as pt_enums
from tests.test_torch_port_models import tiny_pair


@pytest.mark.parametrize("ref_cls,port_cls", [
    (TrainConfig, PortTrainConfig),
    (SampleConfig, PortSampleConfig),
    (ConceptConfig, PortConceptConfig),
], ids=["train", "sample", "concept"])
def test_config_defaults_are_equal(ref_cls, port_cls):
    # drawn anew on each call: a concept's default seed (`random`) and an
    # embedding's uuid (uuid4)
    random.seed(0)
    port = port_cls.default_values().to_dict()
    random.seed(0)
    ref = ref_cls.default_values().to_dict()
    if "embedding" in ref:
        assert port["embedding"].pop("uuid") != ref["embedding"].pop("uuid")
    assert port == ref


def test_train_config_round_trips_through_the_port():
    """A non-default reference config, serialized, loads into the port's
    copy (migrations included) and serializes back unchanged."""
    config = TrainConfig.default_values()
    config.model_type = jax_enums.ModelType.STABLE_DIFFUSION_XL_10_BASE
    config.training_method = jax_enums.TrainingMethod.LORA
    config.lora_rank, config.lora_alpha = 8, 4.0
    config.learning_rate_scheduler = jax_enums.LearningRateScheduler.COSINE
    config.optimizer.optimizer = jax_enums.Optimizer.ADAMW
    config.optimizer.weight_decay = 0.05
    config.text_encoder.train = False
    data = config.to_dict()
    port = PortTrainConfig.default_values().from_dict(data)
    assert port.to_dict() == data
    assert port.training_method is pt_enums.TrainingMethod.LORA
    assert port.weight_dtypes().lora == pt_enums.DataType(
        config.weight_dtypes().lora.value)


def _enum_classes(module) -> dict:
    return {name: obj for name, obj in vars(module).items()
            if isinstance(obj, type) and issubclass(obj, enum.Enum)
            and obj.__module__ == module.__name__}


def test_every_enum_member_matches_by_name_and_value():
    ref, port = _enum_classes(jax_enums), _enum_classes(pt_enums)
    assert set(port) == set(ref)
    for name, ref_cls in ref.items():
        assert [(m.name, m.value) for m in port[name]] == \
            [(m.name, m.value) for m in ref_cls], name


# DataType's maps onto JAX and ml_dtypes types; the port maps onto torch
# dtypes instead (to_torch_dtype, tests/test_torch_port_imports.py)
_FRAMEWORK_DTYPE_MAPS = ("to_jnp_dtype", "to_save_dtype", "to_compute_dtype",
                         "to_load_dtype")


def test_enum_predicates_match():
    """The helper predicates the configs and steps call give the same
    answers on every member."""
    for name, ref_cls in _enum_classes(jax_enums).items():
        port_cls = getattr(pt_enums, name)
        methods = [m for m, f in vars(ref_cls).items()
                   if callable(f) and not m.startswith("_")
                   and m not in _FRAMEWORK_DTYPE_MAPS]
        for method in methods:
            for member in ref_cls:
                want = getattr(member, method)()
                got = getattr(port_cls[member.name], method)()
                if isinstance(want, enum.Enum):
                    want, got = want.value, got.value
                assert got == want, (name, method, member.name)


class _StubTokenizer:
    """A transformers-like tokenizer: one id per character class."""

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [3 + (ord(ch) % 90) for ch in text if not ch.isspace()]}


@pytest.mark.parametrize("stub", [False, True], ids=["hash_fallback", "stub"])
def test_sd_tokenizer_gives_equal_ids(stub):
    ref = SDTokenizer(None, max_length=16, vocab_size=100, bos=98, eos=99)
    port = PortSDTokenizer(None, max_length=16, vocab_size=100, bos=98, eos=99)
    for tok in (ref, port):
        if stub:
            tok._tokenizer = _StubTokenizer()
        assert tok.register_placeholder("<emb>", 2) == [100, 101]
    for text in ("a photo of <emb> on a table", "<emb><emb> and <emb>", "",
                 "a much longer prompt that runs past the sixteen tokens of the window"):
        np.testing.assert_array_equal(port(text), ref(text), err_msg=text)
        assert port.encode_pieces(text) == ref.encode_pieces(text)


def test_key_maps_give_equal_trees():
    """The port's key maps carry the tiny SDXL's trees exactly as the
    reference's do, both ways."""
    _, (unet, te, te2, vae), _ = tiny_pair(seed=4)
    pairs = [
        (unet, pt_tf.unet_flax_to_state_dict, jax_tf.unet_flax_to_state_dict,
         pt_tf.unet_state_dict_to_flax, jax_tf.unet_state_dict_to_flax),
        (vae, pt_tf.vae_flax_to_state_dict, jax_tf.vae_flax_to_state_dict,
         pt_tf.vae_state_dict_to_flax, jax_tf.vae_state_dict_to_flax),
        (te, pt_tf.clip_flax_to_state_dict, jax_tf.clip_flax_to_state_dict,
         pt_tf.clip_state_dict_to_flax, jax_tf.clip_state_dict_to_flax),
        (te2, pt_tf.clip_flax_to_state_dict, jax_tf.clip_flax_to_state_dict,
         pt_tf.clip_state_dict_to_flax, jax_tf.clip_state_dict_to_flax),
    ]
    for tree, port_to_sd, ref_to_sd, port_to_flax, ref_to_flax in pairs:
        sd = ref_to_sd(tree)
        got = port_to_sd(tree)
        assert set(got) == set(sd)
        for key, value in sd.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        back_ref = jax_tf._flatten(ref_to_flax(sd))
        back_port = pt_tf._flatten(port_to_flax(sd))
        assert set(back_port) == set(back_ref)
        for path, value in back_ref.items():
            np.testing.assert_array_equal(back_port[path], value, err_msg=str(path))
    for key in ("text_model.embeddings.token_embedding.weight",
                "text_model.encoder.layers.0.self_attn.q_proj.weight",
                "text_projection.weight", "logit_scale"):
        assert pt_tf.clip_torch_key_map(key) == jax_tf.clip_torch_key_map(key)


def test_nf4_code_table_is_the_reference_copy():
    """The NF4 codebook the port's quantizer, plain dequant and kernel use
    (ops/nf4.py) is the reference's (ops/quant.py), and the padding of the
    packed layout is its nf4_pad_len."""
    from onetrainer_tpu.ops.nf4_pallas import nf4_pad_len
    from onetrainer_tpu.ops.quant import NF4_BLOCK, NF4_CODE
    from onetrainer_tpu_torch.ops import nf4 as pt_nf4
    assert pt_nf4.NF4_CODE == NF4_CODE and pt_nf4.NF4_BLOCK == NF4_BLOCK
    for n in (1, 1023, 2048, 2049, 13_107_200, 29_491_200):
        assert pt_nf4.nf4_pad_len(n) == nf4_pad_len(n)


# -- the copies the train and sample entry points brought ------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# module copied verbatim but for its package name and docstrings
_VERBATIM = ("data/bucketing.py", "data/concepts.py", "util/timed_action.py",
             "util/train_progress.py", "util/path_util.py", "util/callbacks.py",
             "util/commands.py", "trainer/base_trainer.py")


def _normalized_ast(package: str, path: str, drop_pil_imports: bool = False) -> str:
    """The module's AST without docstrings, its package renamed to the
    reference's, and (on request) without its Pillow imports."""
    with open(os.path.join(_REPO, package, path), encoding="utf-8") as f:
        tree = ast.parse(f.read().replace("onetrainer_tpu_torch", "onetrainer_tpu"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list):
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body.pop(0)
            if drop_pil_imports:
                body[:] = [n for n in body if not (
                    isinstance(n, ast.ImportFrom) and n.module == "PIL")]
    return ast.dump(tree)


@pytest.mark.parametrize("path", _VERBATIM)
def test_verbatim_copies_equal_their_originals(path):
    assert _normalized_ast("onetrainer_tpu_torch", path) == \
        _normalized_ast("onetrainer_tpu", path)


def test_augments_copy_moves_only_its_pillow_imports():
    """data/augments.py imports Pillow inside the three functions that need
    it; apart from that it is the original's code, and it augments alike."""
    from onetrainer_tpu.data import augments as ref
    from onetrainer_tpu_torch.data import augments as port
    path = "data/augments.py"
    assert _normalized_ast("onetrainer_tpu_torch", path, drop_pil_imports=True) == \
        _normalized_ast("onetrainer_tpu", path, drop_pil_imports=True)
    concept = ConceptConfig.default_values()
    image_cfg, text_cfg = concept.image, concept.text
    for flag in ("enable_random_flip", "enable_random_rotate", "enable_random_brightness",
                 "enable_random_contrast", "enable_random_saturation", "enable_random_hue",
                 "enable_random_circular_mask_shrink", "enable_random_mask_rotate_crop"):
        setattr(image_cfg, flag, True)
    text_cfg.tag_dropout_enable = text_cfg.enable_tag_shuffling = True
    text_cfg.caps_randomize_enable = True
    port_concept = PortConceptConfig.default_values().from_dict(concept.to_dict())
    image = np.random.default_rng(0).random((48, 40, 3)).astype(np.float32)
    mask = np.zeros((48, 40, 1), np.float32)
    mask[10:30, 8:20] = 1.0
    for seed in range(4):
        want = ref.augment_image(image, concept, np.random.default_rng(seed), mask)
        got = port.augment_image(image, port_concept, np.random.default_rng(seed), mask)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        prompt = "first, second tag, third, Fourth, fifth"
        assert port.augment_text(prompt, port_concept, np.random.default_rng(seed)) == \
            ref.augment_text(prompt, concept, np.random.default_rng(seed))


def test_ldm_copy_gives_the_original_maps_on_numpy_and_torch():
    from onetrainer_tpu.io import ldm as ref
    from onetrainer_tpu_torch.io import ldm as port
    for args in ((), (3, 2, (False, True, True)), (2, 1, (True, False))):
        assert port.unet_key_map(*args) == ref.unet_key_map(*args)
    assert port.vae_key_map() == ref.vae_key_map() and port.vae_key_map(2, 1) == \
        ref.vae_key_map(2, 1)
    _, (unet, te, te2, vae), _ = tiny_pair(seed=5)
    parts = {"unet": jax_tf.unet_flax_to_state_dict(unet),
             "vae": jax_tf.vae_flax_to_state_dict(vae),
             "te": jax_tf.clip_flax_to_state_dict(te),
             "te2": jax_tf.clip_flax_to_state_dict(te2)}
    merges = [
        (lambda m: m.merge_sd15_single_file(parts["unet"], parts["vae"], parts["te"]),
         "split_sd15_single_file"),
        (lambda m: m.merge_sd15_single_file(parts["unet"], parts["vae"], parts["te2"],
                                            sd2_openclip=True), "split_sd15_single_file"),
        (lambda m: m.merge_sdxl_single_file(parts["unet"], parts["vae"], parts["te"],
                                            parts["te2"]), "split_sdxl_single_file"),
    ]
    for merge, split in merges:
        want = merge(ref)
        got = merge(port)
        assert list(got) == list(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        # torch tensors through the copy give the numpy result
        as_torch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in want.items()}
        want_split, got_split = getattr(ref, split)(want), getattr(port, split)(as_torch)
        assert got_split.keys() == want_split.keys()
        for part, sd in want_split.items():
            assert list(got_split[part]) == list(sd), part
            for key, value in sd.items():
                np.testing.assert_array_equal(got_split[part][key].numpy(), value,
                                              err_msg=key)
    torch_te2 = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in parts["te2"].items()}
    got = port.convert_hf_to_openclip(torch_te2, "p.")
    for key, value in ref.convert_hf_to_openclip(parts["te2"], "p.").items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_model_spec_copy_gives_the_original_metadata():
    import ml_dtypes

    from onetrainer_tpu.util import model_spec as ref
    from onetrainer_tpu_torch.util import model_spec as port
    rng = np.random.default_rng(1)
    arrays = {"b": rng.standard_normal((3, 4)).astype(np.float32),
              "a": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
              "c": np.arange(4, dtype=np.int64)}
    tensors = {"b": torch.from_numpy(arrays["b"]), "c": torch.from_numpy(arrays["c"]),
               "a": torch.from_numpy(arrays["a"].view(np.int16).copy()).view(torch.bfloat16)}
    assert port.sha256_of_tensors(tensors) == ref.sha256_of_tensors(arrays)
    config = TrainConfig.default_values()
    config.include_train_config = jax_enums.ConfigPart.SETTINGS
    port_config = PortTrainConfig.default_values().from_dict(config.to_dict())
    for model_type in (jax_enums.ModelType.STABLE_DIFFUSION_15,
                       jax_enums.ModelType.STABLE_DIFFUSION_21,
                       jax_enums.ModelType.STABLE_DIFFUSION_XL_10_BASE):
        for method in (jax_enums.TrainingMethod.LORA, jax_enums.TrainingMethod.FINE_TUNE):
            want = ref.make_modelspec_metadata(model_type, method, resolution="512",
                                               prediction_type="epsilon",
                                               train_config=config, tensors=arrays)
            got = port.make_modelspec_metadata(
                pt_enums.ModelType(model_type.value), pt_enums.TrainingMethod(method.value),
                resolution="512", prediction_type="epsilon", train_config=port_config,
                tensors=tensors)
            assert got == want


@pytest.mark.parametrize("stub", [False, True], ids=["hash_fallback", "stub"])
def test_t5_tokenizer_gives_equal_ids(stub):
    """SD3's T5 wrapper (no BOS, EOS 1, pad 0), with and without a
    transformers-like tokenizer, placeholders spliced alike."""
    from onetrainer_tpu.setup.tokenizer import T5TokenizerWrapper
    from onetrainer_tpu_torch.setup.tokenizer import T5TokenizerWrapper as PortT5
    ref = T5TokenizerWrapper(None, max_length=12, vocab_size=110)
    port = PortT5(None, max_length=12, vocab_size=110)
    for tok in (ref, port):
        if stub:
            tok._tokenizer = _StubTokenizer()
        assert tok.register_placeholder("<emb>", 2) == [110, 111]
    for text in ("a photo of <emb> on a table", "<emb> and <emb>", "",
                 "a much longer prompt that runs past the twelve tokens of the window"):
        np.testing.assert_array_equal(port(text), ref(text), err_msg=text)


def test_remat_defaults_are_the_references():
    """SD3's loader builds with the reference's SD3 default policy."""
    from onetrainer_tpu.models import remat as jax_remat
    from onetrainer_tpu_torch.models import remat as pt_remat
    assert pt_remat.SD3_POLICY == jax_remat._DEFAULTS["sd3"]


def test_sd3_config_readers_give_equal_configs():
    """The SD3 loader's config readers (transformer, T5) over a non-default
    diffusers / transformers config, field by field."""
    import dataclasses

    from onetrainer_tpu.io.flux_checkpoints import t5_config_from_transformers
    from onetrainer_tpu.io.sd3_checkpoints import sd3_config_from_diffusers
    from onetrainer_tpu_torch.io import sd3_checkpoints as pt_ckpt
    transformer = {"sample_size": 64, "num_layers": 38, "num_attention_heads": 38,
                   "pos_embed_max_size": 384, "qk_norm": "rms_norm",
                   "caption_projection_dim": 2432}
    t5 = {"vocab_size": 32128, "d_model": 512, "d_kv": 32, "d_ff": 1024, "num_layers": 6,
          "num_heads": 8, "relative_attention_max_distance": 64}
    for ref, port in ((sd3_config_from_diffusers(transformer),
                       pt_ckpt.sd3_config_from_diffusers(transformer)),
                      (t5_config_from_transformers(t5), pt_ckpt.t5_config_from_transformers(t5))):
        fields = {f.name for f in dataclasses.fields(port)} - {"dtype"}
        assert fields <= {f.name for f in dataclasses.fields(ref)}
        for name in fields:
            assert getattr(port, name) == getattr(ref, name), name


def test_flux_remat_default_and_lora_presets_are_the_references():
    """FLUX's loader builds with the reference's FLUX default policy (no
    `_DEFAULTS` entry: "full"), and its setup's layer presets are the
    reference's."""
    from onetrainer_tpu.models import remat as jax_remat
    from onetrainer_tpu.setup.flux_setup import FLUX_LORA_PRESETS
    from onetrainer_tpu_torch.models import remat as pt_remat
    from onetrainer_tpu_torch.setup import flux_setup as pt_setup
    assert pt_remat.FLUX_POLICY == jax_remat._DEFAULTS.get("flux", "full") == "full"
    assert pt_setup.FLUX_LORA_PRESETS == FLUX_LORA_PRESETS


def test_flux_config_reader_gives_equal_configs():
    """The FLUX loader's transformer config reader over the default (empty),
    FLUX.1-dev's and a non-default diffusers config, field by field."""
    import dataclasses

    from onetrainer_tpu.io.flux_checkpoints import flux_config_from_diffusers
    from onetrainer_tpu_torch.io import flux_checkpoints as pt_ckpt
    dev = {"in_channels": 64, "num_layers": 19, "num_single_layers": 38,
           "num_attention_heads": 24, "attention_head_dim": 128, "joint_attention_dim": 4096,
           "pooled_projection_dim": 768, "guidance_embeds": True, "axes_dims_rope": [16, 56, 56]}
    other = {"in_channels": 16, "out_channels": 32, "num_layers": 2, "num_single_layers": 3,
             "num_attention_heads": 4, "attention_head_dim": 32, "joint_attention_dim": 24,
             "pooled_projection_dim": 20, "guidance_embeds": False, "axes_dims_rope": [8, 12, 12]}
    for config in ({}, dev, other):
        ref = flux_config_from_diffusers(config, gradient_checkpointing=True)
        port = pt_ckpt.flux_config_from_diffusers(config, gradient_checkpointing=True)
        fields = {f.name for f in dataclasses.fields(port)} - {"dtype"}
        assert fields <= {f.name for f in dataclasses.fields(ref)}
        for name in fields:
            assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("stub", [False, True], ids=["hash_fallback", "stub"])
def test_llama_tokenizer_gives_equal_ids(stub):
    """HunyuanVideo's Llama wrapper: the template's 95 positions (the hash
    fallback's filler, or a transformers-like tokenizer over the template),
    the text, the padding and its mask, placeholders spliced alike; the
    prompt template is the reference's."""
    from onetrainer_tpu.models.hunyuan_video import DEFAULT_PROMPT_TEMPLATE
    from onetrainer_tpu.setup.tokenizer import LlamaTokenizerWrapper
    from onetrainer_tpu_torch.models import hunyuan_video as pt_hv
    from onetrainer_tpu_torch.setup.tokenizer import LlamaTokenizerWrapper as PortLlama
    assert pt_hv.DEFAULT_PROMPT_TEMPLATE == DEFAULT_PROMPT_TEMPLATE
    for vocab in (130, 128320):
        ref = LlamaTokenizerWrapper(None, vocab_size=vocab)
        port = PortLlama(None, vocab_size=vocab)
        for tok in (ref, port):
            if stub:
                tok._tokenizer = _StubTokenizer()
            assert tok.register_placeholder("<emb>", 2) == [vocab, vocab + 1]
        assert (port.bos, port.eos, port.pad) == (ref.bos, ref.eos, ref.pad)
        for text in ("a photo of <emb> on a table", "", " ".join(["word"] * 90)):
            if stub and "<emb>" not in text:
                continue   # the stub takes no template/padding keywords
            want = ref(text)
            np.testing.assert_array_equal(port(text), want, err_msg=text)
            np.testing.assert_array_equal(port.mask(want), ref.mask(want))
            assert want.shape == (172,)


def test_hunyuan_remat_default_and_config_readers_are_the_references():
    """HunyuanVideo's loader builds with the reference's default policy (no
    `_DEFAULTS` entry: "full"); its config readers (transformer, Llama,
    causal VAE) over the default (empty) and non-default configs, field by
    field."""
    import dataclasses

    from onetrainer_tpu.io import hunyuan_checkpoints as ref_ckpt
    from onetrainer_tpu.models import remat as jax_remat
    from onetrainer_tpu_torch.io import hunyuan_checkpoints as pt_ckpt
    from onetrainer_tpu_torch.models import remat as pt_remat
    assert pt_remat.HUNYUAN_POLICY == jax_remat._DEFAULTS.get("hunyuan_video", "full") == "full"
    transformer = {"num_layers": 2, "num_single_layers": 4, "num_refiner_layers": 1,
                   "num_attention_heads": 4, "attention_head_dim": 32, "text_embed_dim": 24,
                   "pooled_projection_dim": 20, "guidance_embeds": False,
                   "rope_axes_dim": [8, 12, 12]}
    llama = {"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 96,
             "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2,
             "rope_theta": 10000.0, "rms_norm_eps": 1e-6}
    vae = {"latent_channels": 8, "block_out_channels": [16, 32], "layers_per_block": 1,
           "temporal_compression_ratio": 2, "spatial_compression_ratio": 2,
           "scaling_factor": 0.5}
    for reader, configs in (("hunyuan_config_from_diffusers", ({}, transformer)),
                            ("llama_config_from_transformers", ({}, llama)),
                            ("video_vae_config_from_diffusers", ({}, vae))):
        for config in configs:
            ref = getattr(ref_ckpt, reader)(config)
            port = getattr(pt_ckpt, reader)(config)
            fields = {f.name for f in dataclasses.fields(port)} - {"dtype"}
            assert fields <= {f.name for f in dataclasses.fields(ref)}
            for name in fields:
                assert getattr(port, name) == getattr(ref, name), (reader, name)


def _function_ast(package: str, path: str, name: str) -> str:
    """One top-level function's AST without its docstring."""
    with open(os.path.join(_REPO, package, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    if (node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)):
        node.body.pop(0)
    return ast.dump(node)


def test_inpainting_copies_equal_their_originals():
    """sampling/inpaint.py's `flux_fill_mask_channels` is the reference's
    code, and the FLUX.1-fill transformer config its `flux_fill_config`;
    the loader's conditioning flags are the reference's, by name."""
    import inspect

    from onetrainer_tpu.data.loader import Text2ImageDataLoader as RefLoader
    from onetrainer_tpu.models import flux as jax_flux
    from onetrainer_tpu_torch.data.loader import Text2ImageDataLoader as PortLoader
    from onetrainer_tpu_torch.models import flux as pt_flux
    path = "sampling/inpaint.py"
    assert _function_ast("onetrainer_tpu_torch", path, "flux_fill_mask_channels") == \
        _function_ast("onetrainer_tpu", path, "flux_fill_mask_channels")
    port, ref = pt_flux.flux_fill_config(), jax_flux.flux_fill_config()
    assert (port.in_channels, port.out_channels) == (ref.in_channels, ref.out_channels) \
        == (384, 64)
    for flag in ("conditioning_image", "fill_mask_channels"):
        assert inspect.signature(PortLoader).parameters[flag].default is \
            inspect.signature(RefLoader).parameters[flag].default is False


@pytest.mark.parametrize("family", ["sd3", "sd3_qk_norm", "flux", "flux_fill", "hunyuan",
                                    "pixart"])
def test_single_file_key_maps_give_the_originals_both_ways(family):
    """io/single_file.py's key maps (the SAI, BFL, HunyuanVideo and PixArt layouts)
    are the reference's on torch tensors: on the same seeded transformer's
    tensors (numpy to the reference's, torch to the port's) they give the
    same keys in the same order and the same values, exactly, both ways.
    Every map is a rename, a concatenation, a split or a swap of halves,
    so the helpers (`_swap_chunks`, `_cat`, `_split3`, the single blocks'
    four-way split) are held with them."""
    from onetrainer_tpu.io import single_file as ref
    from onetrainer_tpu_torch.io import single_file as port
    from onetrainer_tpu_torch.io.hunyuan_checkpoints import hunyuan_diffusers_state_dict
    if family.startswith("sd3"):
        from tests.test_torch_port_sd3 import tiny_sd3_pair
        model = tiny_sd3_pair(qk_norm=family == "sd3_qk_norm")[2]
        maps = ("sd3_transformer_to_sai", "sd3_sai_to_transformer")
    elif family.startswith("flux"):
        from tests.test_torch_port_flux import tiny_flux_pair
        from tests.test_torch_port_flux_fill import tiny_fill_pair
        model = (tiny_fill_pair if family == "flux_fill" else tiny_flux_pair)()[2]
        maps = ("flux_transformer_to_bfl", "flux_bfl_to_transformer")
    elif family == "pixart":
        from tests.test_torch_port_pixart import tiny_pixart_pair
        model = tiny_pixart_pair(num_heads=3, use_additional_conditions=True)[2]
        maps = ("pixart_transformer_to_ckpt", "pixart_ckpt_to_transformer")
    else:
        from tests.test_torch_port_hunyuan import tiny_hunyuan_pair
        model = tiny_hunyuan_pair()[2]
        maps = ("hunyuan_transformer_to_ckpt", "hunyuan_ckpt_to_transformer")
    sd = {k: v.detach() for k, v in model.transformer.state_dict().items()}
    if family == "hunyuan":
        sd = hunyuan_diffusers_state_dict(sd)
    for name in maps:   # to the layout, then back from what the reference gave
        want = getattr(ref, name)({k: v.numpy() for k, v in sd.items()})
        got = getattr(port, name)(sd)
        assert list(got) == list(want), name
        for key, value in want.items():
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                          err_msg=f"{name} {key}")
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in want.items()}


@pytest.mark.parametrize("stub", [False, True], ids=["hash_fallback", "stub"])
def test_gemma_tokenizer_gives_equal_ids(stub):
    """Sana's Gemma wrapper (BOS 2 first, no EOS, pad 0), with and without
    a transformers-like tokenizer, placeholders spliced alike, and its keep
    mask."""
    from onetrainer_tpu.setup.tokenizer import GemmaTokenizerWrapper
    from onetrainer_tpu_torch.setup.tokenizer import GemmaTokenizerWrapper as PortGemma
    ref = GemmaTokenizerWrapper(None, max_length=12, vocab_size=120)
    port = PortGemma(None, max_length=12, vocab_size=120)
    for tok in (ref, port):
        if stub:
            tok._tokenizer = _StubTokenizer()
        assert tok.register_placeholder("<emb>", 2) == [120, 121]
    assert (port.bos, port.eos, port.pad) == (ref.bos, ref.eos, ref.pad)
    for text in ("a photo of <emb> on a table", "<emb> and <emb>", "",
                 "a much longer prompt that runs past the twelve tokens of the window"):
        want = ref(text)
        np.testing.assert_array_equal(port(text), want, err_msg=text)
        np.testing.assert_array_equal(port.mask(want), ref.mask(want))


def test_sana_key_maps_give_equal_trees():
    """The port's copies of the reference's Sana, Gemma and DC-AE key maps
    carry the tiny Sana's trees exactly as the reference's do, both ways;
    PixArt's and the T5's go through the generic maps held above."""
    from onetrainer_tpu.io import sana_checkpoints as ref
    from onetrainer_tpu_torch.io import sana_checkpoints as port
    from tests.test_torch_port_sana import tiny_sana_pair
    _, trees, _ = tiny_sana_pair()
    for tree, (to_sd, to_flax) in zip(trees, (
            ("sana_flax_to_state_dict", "sana_state_dict_to_flax"),
            ("gemma_flax_to_state_dict", "gemma_state_dict_to_flax"),
            ("dcae_flax_to_state_dict", "dcae_state_dict_to_flax"))):
        sd = getattr(ref, to_sd)(tree)
        got = getattr(port, to_sd)(tree)
        assert list(got) == list(sd)
        for key, value in sd.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        back_ref = jax_tf._flatten(getattr(ref, to_flax)(sd))
        back_port = pt_tf._flatten(getattr(port, to_flax)(sd))
        assert set(back_port) == set(back_ref)
        for path, value in back_ref.items():
            np.testing.assert_array_equal(back_port[path], value, err_msg=str(path))
    for key in ("model.layers.0.self_attn.q_proj.weight", "embed_tokens.weight"):
        assert port.gemma_torch_key_map(key) == ref.gemma_torch_key_map(key)
    for key in ("patch_embed.proj.weight", "caption_projection.linear_1.bias", "proj_out.weight"):
        assert port.sana_torch_key_map(key) == ref.sana_torch_key_map(key)
        assert port.sana_flax_key_map(port.sana_torch_key_map(key)) == key
