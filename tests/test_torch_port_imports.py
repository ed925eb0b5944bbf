"""The torch port stands without JAX: every module of onetrainer_tpu_torch
imports, the SDXL slice samples and takes two LoRA training steps, with
the JAX package (onetrainer_tpu), jax, flax, optax, ml_dtypes,
transformers, PIL and safetensors blocked (none but the port's own code is
installed on the machine with the card). chip_smoke.py refuses to run
without a CUDA device (printing no result)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("onetrainer_tpu", "jax", "flax", "optax", "ml_dtypes",
           "transformers", "PIL", "safetensors")

_SCRIPT = textwrap.dedent(f"""
    import importlib, pkgutil, sys
    for name in {BLOCKED!r}:
        sys.modules[name] = None
    sys.path.insert(0, {REPO!r})
    import torch
    import onetrainer_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        onetrainer_tpu_torch.__path__, "onetrainer_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    import chip_smoke

    from onetrainer_tpu_torch.config.sample_config import SampleConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.io.weights import init_sdxl_weights
    from onetrainer_tpu_torch.models.clip import CLIPTextConfig
    from onetrainer_tpu_torch.models.sdxl import StableDiffusionXLModel
    from onetrainer_tpu_torch.models.unet import UNetConfig
    from onetrainer_tpu_torch.models.vae import VAEConfig
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import ModelType, TrainingMethod

    te = dict(vocab_size=100, intermediate_size=64, num_layers=2, num_heads=4,
              max_position_embeddings=16, eos_token_id=99)
    model = StableDiffusionXLModel(
        model_type=ModelType.STABLE_DIFFUSION_XL_10_BASE,
        unet_config=UNetConfig(
            block_out_channels=(32, 64), cross_attn_blocks=(False, True),
            layers_per_block=1, transformer_layers_per_block=(1, 2),
            num_heads=(4, 4), cross_attention_dim=80,
            use_linear_projection=True, addition_embed_dim=8,
            addition_pooled_dim=48, gradient_checkpointing=True,
            remat_policy="tx_only"),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        te_config=CLIPTextConfig(hidden_size=32, **te),
        te2_config=CLIPTextConfig(hidden_size=48, projection_dim=48, **te),
        device="meta")
    init_sdxl_weights(model, seed=0, device="cpu")
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_XL_10_BASE
    family = get_family(config.model_type)
    sc = SampleConfig.default_values()
    sc.prompt, sc.height, sc.width, sc.diffusion_steps = "a cat", 32, 32, 2
    image = family.sample(family.create_setup(model, config, 1), sc, None).image
    assert image.shape == (32, 32, 3) and image.dtype.name == "uint8"

    config.training_method = TrainingMethod.LORA
    config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
    config.text_encoder.train = config.text_encoder_2.train = False
    setup = family.create_setup(model, config, 10)
    encode_images, encode_text = family.make_encode_fns(setup)
    latents = encode_images(torch.rand((2, 32, 32, 3)) * 2 - 1)
    text = encode_text("a cat")
    batch = dict(latents, loss_weight=torch.ones(2),
                 original_resolution=torch.full((2, 2), 32),
                 crop_offset=torch.zeros((2, 2)), crop_resolution=torch.full((2, 2), 32))
    for name in ("text_encoder_hidden_state", "text_encoder_2_hidden_state",
                 "text_encoder_2_pooled_state"):
        batch[name] = text[name].expand(2, *text[name].shape)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert setup.state.step == 2
    assert any(e["lora_up"].abs().max() > 0 for e in setup.state.params["unet_lora"].values())
    leaked = sorted(n for n, m in sys.modules.items()
                    if n.split(".")[0] in {BLOCKED!r} and m is not None)
    assert not leaked, leaked
    print(len(mods))
""")


def test_port_imports_and_samples_without_jax():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20   # modules imported


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_torch_dtype_map_covers_every_data_type():
    import torch

    from onetrainer_tpu_torch.util.enums import DataType, to_torch_dtype
    assert to_torch_dtype(DataType.BFLOAT_16) is torch.bfloat16
    assert to_torch_dtype(DataType.TFLOAT_32) is torch.float32
    assert to_torch_dtype(DataType.NONE) is None
    for data_type in DataType:
        to_torch_dtype(data_type)   # every member maps
