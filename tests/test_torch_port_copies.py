"""The port's own copies of the reference's framework-free modules agree
with the originals: configs (onetrainer_tpu/config), enums
(onetrainer_tpu/util/enums.py), model names (util/model_names.py), the CLIP
tokenizer wrapper (setup/tokenizer.py) and the torch<->flax key maps
(io/torch_flax.py). The port imports none of these from the JAX package;
these tests hold the copies to them exactly.
"""

import enum
import random

import numpy as np
import pytest

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
