"""The torch port stands without JAX: every module of onetrainer_tpu_torch
imports, the SDXL slice samples and takes two LoRA training steps and two
QLoRA steps (NF4 UNet, bf16 adapters, stochastic rounding), and the SD 2.x
slice (v-prediction, text-encoder layer skip 1) samples and takes two LoRA
steps, the SD3 slice (dots_nb_attn checkpointing) samples and takes two
LoRA steps on cached text, the FLUX slice ("full" checkpointing) samples
and takes two LoRA steps on an NF4 transformer and cached text, the
HunyuanVideo slice ("full" checkpointing) samples a 5-frame clip and takes
two LoRA steps on an NF4 transformer, 5-frame clips and cached text, the
FLUX.1-fill slice inpaints from PNGs at another size than the sample's and
takes two LoRA steps on an NF4 transformer with the conditioning latent
and the 64-channel mask, the PixArt-Σ and Sana slices ("full"
checkpointing) each sample and take two LoRA steps on an NF4 transformer
with bf16 adapters, stochastic rounding and cached text, the Stable
Cascade slice samples through the stand-in and takes two LoRA steps on an
NF4 prior with bf16 adapters, stochastic rounding, effnet latents and
cached text with its pooled projection, and the train and
sample CLIs run a tiny SD 1.5
checkpoint end to end (load, cache, train, back up, save the LoRA file,
sample) and a tiny SD 1.5 inpainting checkpoint over PNGs that are not at
their bucket's size (resized without Pillow), with masks and a
conditioning image, then `--sample-inpainting`, with
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
    torch.set_num_threads(1)   # tiny models; the suite runs beside other workers
    import onetrainer_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        onetrainer_tpu_torch.__path__, "onetrainer_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    assert "onetrainer_tpu_torch.train.ema" in mods
    assert {{"onetrainer_tpu_torch.ops.quant_opt", "onetrainer_tpu_torch.train.dadapt",
             "onetrainer_tpu_torch.util.optimizer_util"}} <= set(mods)
    import chip_smoke

    from onetrainer_tpu_torch.config.sample_config import SampleConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.io.weights import init_sd_weights
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
    init_sd_weights(model, seed=0, device="cpu")
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

    from onetrainer_tpu_torch.ops.quant import is_quantized
    from onetrainer_tpu_torch.util.enums import DataType
    config.unet.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    model.unet = model.unet.__class__(model.unet_config)
    init_sd_weights(model, seed=1, device="cpu")
    setup = family.create_setup(model, config, 10)
    assert sum(is_quantized(getattr(m, "weight", None)) for m in model.unet.modules()) > 10
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"].dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for e in setup.state.params["unet_lora"].values()
               for t in e.values())

    from onetrainer_tpu_torch.io.weights import init_sd_weights
    from onetrainer_tpu_torch.models.sd import StableDiffusionModel
    sd = StableDiffusionModel(
        model_type=ModelType.STABLE_DIFFUSION_21,
        unet_config=UNetConfig(
            block_out_channels=(32, 64), cross_attn_blocks=(True, False),
            layers_per_block=1, num_heads=(4, 4), cross_attention_dim=32,
            use_linear_projection=True),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        te_config=CLIPTextConfig(hidden_size=32, hidden_act="gelu", **te),
        text_encoder_layer_skip=1, device="meta")
    init_sd_weights(sd, seed=2, device="cpu")
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_21
    config.force_v_prediction = True
    family = get_family(config.model_type)
    image = family.sample(family.create_setup(sd, config, 1), sc, None).image
    assert image.shape == (32, 32, 3) and image.dtype.name == "uint8"
    config.training_method = TrainingMethod.LORA
    config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
    config.text_encoder.train = False
    setup = family.create_setup(sd, config, 10)
    encode_images, encode_text = family.make_encode_fns(setup)
    text = encode_text("a cat")["text_encoder_hidden_state"]
    batch = dict(encode_images(torch.rand((2, 32, 32, 3)) * 2 - 1),
                 loss_weight=torch.ones(2),
                 text_encoder_hidden_state=text.expand(2, *text.shape))
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert sd.prediction_type == "v_prediction" and setup.state.step == 2
    assert any(e["lora_up"].abs().max() > 0 for e in setup.state.params["unet_lora"].values())

    from onetrainer_tpu_torch.io.weights import init_sd3_weights
    from onetrainer_tpu_torch.models.sd3 import SD3Config
    from onetrainer_tpu_torch.models.sd3_model import StableDiffusion3Model
    from onetrainer_tpu_torch.models.t5 import T5Config
    sd3 = StableDiffusion3Model(
        model_type=ModelType.STABLE_DIFFUSION_3,
        transformer_config=SD3Config(
            sample_size=8, in_channels=4, out_channels=4, num_layers=2, num_heads=2,
            head_dim=16, joint_attention_dim=24, caption_projection_dim=32,
            pooled_projection_dim=32 + 48, pos_embed_max_size=16,
            gradient_checkpointing=True, remat_policy="dots_nb_attn"),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                             latent_channels=4, scaling_factor=1.5305, shift_factor=0.0609),
        te_config=CLIPTextConfig(hidden_size=32, projection_dim=32, **te),
        te2_config=CLIPTextConfig(hidden_size=48, projection_dim=48, **te),
        te3_config=T5Config(vocab_size=110, d_model=24, d_kv=6, d_ff=48, num_layers=2,
                            num_heads=4),
        device="meta")
    init_sd3_weights(sd3, seed=3, device="cpu")
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_DIFFUSION_3
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    image = family.sample(family.create_setup(sd3, config, 1), sc, None).image
    assert image.shape == (32, 32, 3) and image.dtype.name == "uint8"
    config.training_method = TrainingMethod.LORA
    config.prior.train = True
    config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
    config.text_encoder.train = config.text_encoder_2.train = False
    setup = family.create_setup(sd3, config, 10)
    encode_images, encode_text = family.make_encode_fns(setup)
    text = encode_text("a cat")
    batch = dict(encode_images(torch.rand((2, 32, 32, 3)) * 2 - 1),
                 loss_weight=torch.ones(2), tokens=torch.as_tensor(text["tokens"]).expand(2, -1),
                 sd3_context=text["sd3_context"].expand(2, -1, -1),
                 sd3_pooled=text["sd3_pooled"].expand(2, -1))
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert setup.state.step == 2
    assert any(e["lora_up"].abs().max() > 0
               for e in setup.state.params["transformer_lora"].values())

    from onetrainer_tpu_torch.io.weights import init_flux_weights
    from onetrainer_tpu_torch.models.flux import FluxConfig
    from onetrainer_tpu_torch.models.flux_model import FluxModel
    flux = FluxModel(
        model_type=ModelType.FLUX_DEV_1,
        transformer_config=FluxConfig(
            in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
            hidden_size=32, num_heads=2, head_dim=16, joint_attention_dim=24,
            pooled_projection_dim=32, axes_dims_rope=(4, 6, 6),
            gradient_checkpointing=True),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                             latent_channels=4, scaling_factor=0.3611, shift_factor=0.1159),
        te_config=CLIPTextConfig(hidden_size=32, **te),
        te2_config=T5Config(vocab_size=110, d_model=24, d_kv=6, d_ff=48, num_layers=2,
                            num_heads=4),
        device="meta")
    init_flux_weights(flux, seed=4, device="cpu")
    config = TrainConfig.default_values()
    config.model_type = ModelType.FLUX_DEV_1
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    image = family.sample(family.create_setup(flux, config, 1), sc, None).image
    assert image.shape == (32, 32, 3) and image.dtype.name == "uint8"
    config.training_method = TrainingMethod.LORA
    config.prior.train = True
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
    flux.transformer = flux.transformer.__class__(flux.transformer_config)
    init_flux_weights(flux, seed=5, device="cpu")
    setup = family.create_setup(flux, config, 10)
    assert sum(is_quantized(getattr(m, "weight", None))
               for m in flux.transformer.modules()) > 10
    encode_images, encode_text = family.make_encode_fns(setup)
    text = encode_text("a cat")
    batch = dict(encode_images(torch.rand((2, 32, 32, 3)) * 2 - 1), loss_weight=torch.ones(2),
                 t5_hidden_state=text["t5_hidden_state"].expand(2, -1, -1),
                 clip_pooled_state=text["clip_pooled_state"].expand(2, -1))
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert setup.state.step == 2
    assert any(e["lora_up"].abs().max() > 0
               for e in setup.state.params["transformer_lora"].values())

    from onetrainer_tpu_torch.io.weights import init_hunyuan_weights
    from onetrainer_tpu_torch.models.hunyuan_video import HunyuanVideoConfig
    from onetrainer_tpu_torch.models.hunyuan_video_model import HunyuanVideoModel
    from onetrainer_tpu_torch.models.llama import LlamaConfig
    from onetrainer_tpu_torch.models.video_vae import VideoVAEConfig
    hv = HunyuanVideoModel(
        model_type=ModelType.HUNYUAN_VIDEO,
        transformer_config=HunyuanVideoConfig(
            num_layers=1, num_single_layers=1, num_refiner_layers=1, hidden_size=32,
            num_heads=2, head_dim=16, text_embed_dim=24, pooled_projection_dim=32,
            axes_dims_rope=(4, 6, 6), gradient_checkpointing=True),
        vae_config=VideoVAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1),
        te_config=LlamaConfig(vocab_size=130, hidden_size=24, intermediate_size=48,
                              num_layers=2, num_heads=2, num_kv_heads=1, head_dim=12),
        te2_config=CLIPTextConfig(hidden_size=32, **te),
        device="meta")
    init_hunyuan_weights(hv, seed=6, device="cpu")
    config = TrainConfig.default_values()
    config.model_type = ModelType.HUNYUAN_VIDEO
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    sc.frames = 5
    out = family.sample(family.create_setup(hv, config, 1), sc, None)
    assert out.video.shape == (5, 32, 32, 3) and out.video.dtype.name == "uint8"
    config.training_method = TrainingMethod.LORA
    config.prior.train = True
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
    hv.transformer = hv.transformer.__class__(hv.transformer_config)
    init_hunyuan_weights(hv, seed=7, device="cpu")
    setup = family.create_setup(hv, config, 10)
    assert sum(is_quantized(getattr(m, "weight", None))
               for m in hv.transformer.modules()) > 10
    encode_images, encode_text = family.make_encode_fns(setup)
    text = encode_text("a cat")
    batch = dict(encode_images(torch.rand((2, 5, 32, 32, 3)) * 2 - 1),
                 loss_weight=torch.ones(2),
                 **{{k: torch.as_tensor(text[k]).expand(2, *torch.as_tensor(text[k]).shape)
                    for k in ("text_encoder_1_hidden_state", "tokens_mask_1",
                              "text_encoder_2_pooled_state")}})
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert setup.state.step == 2
    assert any(e["lora_up"].abs().max() > 0
               for e in setup.state.params["transformer_lora"].values())
    import os, tempfile
    import numpy as np
    from onetrainer_tpu_torch.io.png import write_png
    from onetrainer_tpu_torch.sampling.inpaint import flux_fill_mask_channels
    fill = FluxModel(
        model_type=ModelType.FLUX_FILL_DEV_1,
        transformer_config=FluxConfig(
            in_channels=288, out_channels=16, num_layers=1, num_single_layers=1,
            hidden_size=32, num_heads=2, head_dim=16, joint_attention_dim=24,
            pooled_projection_dim=32, axes_dims_rope=(4, 6, 6),
            gradient_checkpointing=True),
        vae_config=VAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1,
                             latent_channels=4, scaling_factor=0.3611, shift_factor=0.1159),
        te_config=CLIPTextConfig(hidden_size=32, **te),
        te2_config=T5Config(vocab_size=110, d_model=24, d_kv=6, d_ff=48, num_layers=2,
                            num_heads=4),
        device="meta")
    init_flux_weights(fill, seed=8, device="cpu")
    inputs = tempfile.mkdtemp()
    rng = np.random.default_rng(0)
    write_png(os.path.join(inputs, "base.png"),
              rng.integers(0, 256, (41, 57, 3), dtype=np.uint8))
    mask = np.zeros((41, 57), np.uint8)
    mask[10:30, 5:40] = 255
    write_png(os.path.join(inputs, "mask.png"), mask)
    config = TrainConfig.default_values()
    config.model_type = ModelType.FLUX_FILL_DEV_1
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    sc.frames, sc.height, sc.width, sc.cfg_scale = 1, 64, 64, 30.0
    sc.sample_inpainting = True
    sc.base_image_path = os.path.join(inputs, "base.png")
    sc.mask_image_path = os.path.join(inputs, "mask.png")
    image = family.sample(family.create_setup(fill, config, 1), sc, None).image
    assert image.shape == (64, 64, 3) and image.dtype.name == "uint8"
    config.training_method = TrainingMethod.LORA
    config.prior.train = True
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
    setup = family.create_setup(fill, config, 10)
    assert is_quantized(fill.transformer.x_embedder.weight)
    encode_images, encode_text = family.make_encode_fns(setup)
    text = encode_text("a cat")
    images = torch.rand((2, 64, 64, 3)) * 2 - 1
    pixel_mask = np.zeros((64, 64, 1), np.float32)
    pixel_mask[16:48, 8:40] = 1.0
    batch = dict(encode_images(images), loss_weight=torch.ones(2),
                 t5_hidden_state=text["t5_hidden_state"].expand(2, -1, -1),
                 clip_pooled_state=text["clip_pooled_state"].expand(2, -1),
                 latent_conditioning_image=encode_images(
                     images * (1 - torch.from_numpy(pixel_mask)))["latent_image"],
                 latent_mask=torch.from_numpy(flux_fill_mask_channels(pixel_mask))[None]
                 .expand(2, -1, -1, -1))
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert any(e["lora_up"].abs().max() > 0
               for e in setup.state.params["transformer_lora"].values())
    from onetrainer_tpu_torch.io.weights import init_pixart_weights, init_sana_weights
    from onetrainer_tpu_torch.models.dcae import DCAEConfig
    from onetrainer_tpu_torch.models.gemma import Gemma2Config
    from onetrainer_tpu_torch.models.pixart import PixArtConfig
    from onetrainer_tpu_torch.models.pixart_model import PixArtAlphaModel
    from onetrainer_tpu_torch.models.sana import SanaConfig
    from onetrainer_tpu_torch.models.sana_model import SanaModel
    pixart = PixArtAlphaModel(
        model_type=ModelType.PIXART_SIGMA,
        transformer_config=PixArtConfig(
            sample_size=8, num_layers=1, num_heads=2, head_dim=16, cross_attention_dim=24,
            caption_channels=24, gradient_checkpointing=True),
        vae_config=VAEConfig(block_out_channels=(32, 32), layers_per_block=1, latent_channels=4),
        te_config=T5Config(vocab_size=110, d_model=24, d_kv=6, d_ff=48, num_layers=2,
                           num_heads=4),
        device="meta")
    sana = SanaModel(
        model_type=ModelType.SANA,
        transformer_config=SanaConfig(
            in_channels=8, out_channels=8, num_layers=1, num_attention_heads=4,
            attention_head_dim=8, num_cross_attention_heads=2, cross_attention_head_dim=16,
            caption_channels=24, gradient_checkpointing=True),
        vae_config=DCAEConfig(latent_channels=8, encoder_block_out_channels=(8, 16, 16),
                              decoder_block_out_channels=(8, 16, 16),
                              encoder_layers_per_block=(1, 1, 1),
                              decoder_layers_per_block=(1, 1, 1),
                              vit_stages=(False, False, True), attention_head_dim=8),
        te_config=Gemma2Config(vocab_size=120, hidden_size=24, intermediate_size=48,
                               num_layers=2, num_heads=2, num_kv_heads=1, head_dim=12,
                               query_pre_attn_scalar=12.0),
        device="meta")
    sc.sample_inpainting = False
    sc.height = sc.width = 32
    sc.cfg_scale = 4.5
    for model, init, cached in ((pixart, init_pixart_weights, ("t5_hidden_state",)),
                                (sana, init_sana_weights,
                                 ("text_encoder_hidden_state", "tokens_mask"))):
        init(model, seed=9, device="cpu")
        config = TrainConfig.default_values()
        config.model_type = model.model_type
        config.training_method = TrainingMethod.FINE_TUNE
        config.prior.train = config.text_encoder.train = False
        family = get_family(config.model_type)
        image = family.sample(family.create_setup(model, config, 1), sc, None).image
        assert image.shape == (32, 32, 3) and image.std() > 0
        config.training_method = TrainingMethod.LORA
        config.prior.train = True
        config.prior.weight_dtype = DataType.NFLOAT_4
        config.lora_weight_dtype = DataType.BFLOAT_16
        config.optimizer.stochastic_rounding = True
        config.batch_size, config.learning_rate_warmup_steps = 2, 0.0
        model.transformer = model.transformer.__class__(model.transformer_config)
        init(model, seed=10, device="cpu")
        setup = family.create_setup(model, config, 10)
        assert sum(is_quantized(getattr(m, "weight", None))
                   for m in model.transformer.modules()) >= 2
        encode_images, encode_text = family.make_encode_fns(setup)
        text = encode_text("a cat")
        batch = dict(encode_images(torch.rand((2, 32, 32, 3)) * 2 - 1),
                     loss_weight=torch.ones(2),
                     **{{k: torch.as_tensor(text[k]).expand(2, *torch.as_tensor(text[k]).shape)
                        for k in cached}})
        for _ in range(2):
            metrics = setup.train_step(setup.state, batch, gen)
            assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
        assert any(e["lora_up"].abs().max() > 0
                   for e in setup.state.params["transformer_lora"].values())
    assert {{"onetrainer_tpu_torch.models." + m for m in (
        "wuerstchen", "cascade", "diffnext", "paella_vq", "wuerstchen_model", "resize")}} | {{
        "onetrainer_tpu_torch.io.wuerstchen_checkpoints",
        "onetrainer_tpu_torch.setup.wuerstchen_setup",
        "onetrainer_tpu_torch.train.wuerstchen_train_step",
        "onetrainer_tpu_torch.sampling.wuerstchen_sampler"}} <= set(mods)
    from onetrainer_tpu_torch.io.weights import init_wuerstchen_weights
    from onetrainer_tpu_torch.models.cascade import CascadePriorConfig
    from onetrainer_tpu_torch.models.wuerstchen import EffnetConfig
    from onetrainer_tpu_torch.models.wuerstchen_model import WuerstchenModel
    cascade = WuerstchenModel(
        model_type=ModelType.STABLE_CASCADE_1,
        prior_config=CascadePriorConfig(c_hidden=(64, 64), nhead=(1, 1), blocks=(1, 1),
                                        c_cond=64, clip_text_in=32, clip_text_pooled_in=32,
                                        clip_image_in=16),
        effnet_config=EffnetConfig(), te_config=CLIPTextConfig(
            hidden_size=32, projection_dim=32, **te), device="meta")
    init_wuerstchen_weights(cascade, seed=11, device="cpu")
    config = TrainConfig.default_values()
    config.model_type = ModelType.STABLE_CASCADE_1
    config.training_method = TrainingMethod.FINE_TUNE
    config.prior.train = config.text_encoder.train = False
    family = get_family(config.model_type)
    sc.height = sc.width = 128
    image = family.sample(family.create_setup(cascade, config, 1), sc, None).image
    assert image.shape == (128, 128, 3) and image.std() > 0
    config.training_method = TrainingMethod.LORA
    config.prior.train = True
    config.prior.weight_dtype = DataType.NFLOAT_4
    config.lora_weight_dtype = DataType.BFLOAT_16
    config.optimizer.stochastic_rounding = True
    setup = family.create_setup(cascade, config, 10)
    assert sum(is_quantized(getattr(m, "weight", None)) for m in cascade.prior.modules()) >= 10
    encode_images, encode_text = family.make_encode_fns(setup)
    text = encode_text("a cat")
    batch = dict(encode_images(torch.rand((2, 128, 128, 3)) * 2 - 1), loss_weight=torch.ones(2),
                 **{{k: text[k].expand(2, *text[k].shape) for k in (
                     "text_encoder_hidden_state", "pooled_text_encoder_output")}})
    assert batch["latent_image"].shape == (2, 3, 3, 16)
    for _ in range(2):
        metrics = setup.train_step(setup.state, batch, gen)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert any(e["lora_up"].abs().max() > 0 for e in setup.state.params["prior_lora"].values())
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


_CLI_SCRIPT = textwrap.dedent(f"""
    import json, os, sys, tempfile
    for name in {BLOCKED!r}:
        sys.modules[name] = None
    sys.path.insert(0, {REPO!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from onetrainer_tpu_torch.config.concept_config import ConceptConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.io.png import read_png, write_png
    from onetrainer_tpu_torch.io.safetensors_io import load_safetensors
    from onetrainer_tpu_torch.io.sd_checkpoints import save_sd_diffusers, state_dict_of
    from onetrainer_tpu_torch.io.weights import init_sd_weights
    from onetrainer_tpu_torch.models.clip import CLIPTextConfig
    from onetrainer_tpu_torch.models.sd import StableDiffusionModel
    from onetrainer_tpu_torch.models.unet import UNetConfig
    from onetrainer_tpu_torch.models.vae import VAEConfig
    from onetrainer_tpu_torch.scripts import sample, train
    from onetrainer_tpu_torch.util.enums import ModelType, TimeUnit, TrainingMethod

    root = tempfile.mkdtemp()
    model = StableDiffusionModel(
        model_type=ModelType.STABLE_DIFFUSION_15,
        unet_config=UNetConfig(block_out_channels=(32, 64), cross_attn_blocks=(True, False),
                               layers_per_block=1, num_heads=(4, 4), cross_attention_dim=32),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        te_config=CLIPTextConfig(vocab_size=100, hidden_size=32, intermediate_size=64,
                                 num_layers=2, num_heads=4, max_position_embeddings=16,
                                 eos_token_id=99), device="meta")
    init_sd_weights(model, seed=0, device="cpu")
    base = os.path.join(root, "ckpt")
    save_sd_diffusers(base, model, *(state_dict_of(m) for m in
                                     (model.unet, model.vae, model.text_encoder)))
    configs = {{
        "unet": {{"block_out_channels": [32, 64], "layers_per_block": 1,
                  "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                  "attention_head_dim": 4, "cross_attention_dim": 32}},
        "vae": {{"block_out_channels": [32, 64], "layers_per_block": 1}},
        "text_encoder": {{"vocab_size": 100, "hidden_size": 32, "intermediate_size": 64,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "max_position_embeddings": 16, "eos_token_id": 99}},
    }}
    for name, cfg in configs.items():
        with open(os.path.join(base, name, "config.json"), "w") as f:
            json.dump(cfg, f)
    ds = os.path.join(root, "ds")
    os.makedirs(ds)
    rng = np.random.default_rng(0)
    for i in range(4):
        write_png(os.path.join(ds, f"img{{i}}.png"),
                  (rng.random((32, 32, 3)) * 255).astype(np.uint8))
        with open(os.path.join(ds, f"img{{i}}.txt"), "w") as f:
            f.write(f"a photo of thing {{i}}")
    config = TrainConfig.default_values()
    config.base_model_name = base
    config.model_type = ModelType.STABLE_DIFFUSION_15
    config.training_method = TrainingMethod.LORA
    config.workspace_dir, config.cache_dir = os.path.join(root, "ws"), os.path.join(root, "c")
    config.epochs, config.batch_size, config.resolution = 1, 2, "32"
    config.lora_rank, config.learning_rate_warmup_steps = 4, 0.0
    config.tensorboard, config.aspect_ratio_bucketing = False, False
    config.backup_after_unit = config.save_every_unit = TimeUnit.NEVER
    config.text_encoder.train = False
    concept = ConceptConfig.default_values()
    concept.path = ds
    config.concepts, config.samples = [concept], []
    config.output_model_destination = os.path.join(root, "lora.safetensors")
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config.to_dict(), f)
    trainer = train.main(["--config-path", os.path.join(root, "config.json"),
                          "--device", "cpu"])
    assert trainer.train_progress.global_step == 2
    lora = load_safetensors(config.output_model_destination)
    assert any(k.startswith("lora_unet_") for k in lora)
    out = os.path.join(root, "cat.png")
    sample.main(["--model-type", "STABLE_DIFFUSION_15", "--base-model-name", base,
                 "--prompt", "a cat", "--destination", out, "--steps", "2",
                 "--width", "32", "--height", "32", "--device", "cpu"])
    assert read_png(out).shape == (32, 32, 3)

    # FINE_TUNE with masks, EMA, zero-terminal SNR, Adafactor and gradient
    # accumulation: epoch 1 with a backup, a resume from it, an fp16 file
    from onetrainer_tpu_torch.util.enums import DataType, EMAMode, ModelFormat, Optimizer
    for i in range(4):
        write_png(os.path.join(ds, f"img{{i}}-masklabel.png"),
                  (rng.random((32, 32)) * 255).astype(np.uint8))
    config.training_method = TrainingMethod.FINE_TUNE
    config.masked_training = config.normalize_masked_area_loss = True
    config.rescale_noise_scheduler_to_zero_terminal_snr = True
    config.ema, config.ema_update_step_interval = EMAMode.GPU, 1
    config.gradient_accumulation_steps = 2
    config.optimizer.optimizer = Optimizer.ADAFACTOR
    config.backup_before_save = True
    config.workspace_dir, config.cache_dir = os.path.join(root, "ft"), os.path.join(root, "fc")
    config.output_dtype, config.output_model_format = DataType.FLOAT_16, ModelFormat.SAFETENSORS
    config.output_model_destination = os.path.join(root, "ft.safetensors")
    for epochs in (1, 2):
        config.epochs, config.continue_last_backup = epochs, epochs == 2
        with open(os.path.join(root, "ft.json"), "w") as f:
            json.dump(config.to_dict(), f)
        trainer = train.main(["--config-path", os.path.join(root, "ft.json"),
                              "--device", "cpu"])
    state = trainer.setup.state
    assert trainer.train_progress.global_step == 4 and state.ema.step == 2
    assert trainer.model.prediction_type == "v_prediction"
    assert float(trainer.data_loader.materialize_batch(
        trainer.data_loader.batches_for_epoch(0)[0])["latent_mask"].min()) < 1.0
    out = load_safetensors(config.output_model_destination)
    assert {{v.dtype for v in out.values()}} == {{torch.float16}}

    # SD 1.5 inpainting: 9 input channels, PNGs at sizes no bucket has,
    # masks and one conditioning image, then --sample-inpainting
    inp = StableDiffusionModel(
        model_type=ModelType.STABLE_DIFFUSION_15_INPAINTING,
        unet_config=UNetConfig(in_channels=9, block_out_channels=(32, 64),
                               cross_attn_blocks=(True, False), layers_per_block=1,
                               num_heads=(4, 4), cross_attention_dim=32),
        vae_config=VAEConfig(block_out_channels=(32, 64), layers_per_block=1),
        te_config=model.te_config, device="meta")
    init_sd_weights(inp, seed=1, device="cpu")
    ibase = os.path.join(root, "inpaint")
    save_sd_diffusers(ibase, inp, *(state_dict_of(m) for m in
                                    (inp.unet, inp.vae, inp.text_encoder)))
    configs["unet"]["in_channels"] = 9
    for name, cfg in configs.items():
        with open(os.path.join(ibase, name, "config.json"), "w") as f:
            json.dump(cfg, f)
    ids = os.path.join(root, "ids")
    os.makedirs(ids)
    for i in range(4):
        h, w = 40 + 3 * i, 37 + 5 * i
        write_png(os.path.join(ids, f"img{{i}}.png"),
                  (rng.random((h, w, 3)) * 255).astype(np.uint8))
        m = np.zeros((h, w), np.uint8)
        m[h // 4:h // 2, w // 3:] = 255
        write_png(os.path.join(ids, f"img{{i}}-masklabel.png"), m)
        with open(os.path.join(ids, f"img{{i}}.txt"), "w") as f:
            f.write(f"a photo of thing {{i}}")
    write_png(os.path.join(ids, "img1-condlabel.png"),
              (rng.random((43, 42, 3)) * 255).astype(np.uint8))
    config = TrainConfig.default_values()
    config.base_model_name = ibase
    config.model_type = ModelType.STABLE_DIFFUSION_15_INPAINTING
    config.training_method = TrainingMethod.LORA
    config.workspace_dir, config.cache_dir = os.path.join(root, "iws"), os.path.join(root, "ic")
    config.epochs, config.batch_size, config.resolution = 1, 2, "32"
    config.lora_rank, config.learning_rate_warmup_steps = 4, 0.0
    config.tensorboard, config.aspect_ratio_bucketing = False, False
    config.backup_after_unit = config.save_every_unit = TimeUnit.NEVER
    config.text_encoder.train = False
    config.custom_conditioning_image = True
    concept = ConceptConfig.default_values()
    concept.path = ids
    config.concepts, config.samples = [concept], []
    config.output_model_destination = os.path.join(root, "inpaint.safetensors")
    with open(os.path.join(root, "inpaint.json"), "w") as f:
        json.dump(config.to_dict(), f)
    trainer = train.main(["--config-path", os.path.join(root, "inpaint.json"),
                          "--device", "cpu"])
    assert trainer.train_progress.global_step == 2
    batch = trainer.data_loader.materialize_batch(trainer.data_loader.batches_for_epoch(0)[0])
    assert batch["latent_conditioning_image"].shape == (2, 16, 16, 4)
    assert batch["latent_mask"].shape == (2, 16, 16, 1)
    assert [e.cond_path is not None for e in trainer.data_loader.entries].count(True) == 1
    out = os.path.join(root, "filled.png")
    sample.main(["--model-type", "STABLE_DIFFUSION_15_INPAINTING", "--base-model-name",
                 ibase, "--prompt", "a cat", "--destination", out, "--steps", "2",
                 "--width", "32", "--height", "32", "--device", "cpu",
                 "--sample-inpainting", "--base-image-path", os.path.join(ids, "img0.png"),
                 "--mask-image-path", os.path.join(ids, "img0-masklabel.png")])
    assert read_png(out).shape == (32, 32, 3)
    leaked = sorted(n for n, m in sys.modules.items()
                    if n.split(".")[0] in {BLOCKED!r} and m is not None)
    assert not leaked, leaked
    import shutil
    shutil.rmtree(root)
    print("cli ok")
""")


def test_train_and_sample_clis_run_without_jax():
    """The port's train CLI (tiny SD 1.5 diffusers checkpoint written by the
    port, PNGs at their bucket size, caching, two LoRA steps, backup before
    the kohya save), its sample CLI, and a FINE_TUNE run with masks, EMA
    and gradient accumulation that backs up and resumes, with the JAX
    package, jax, PIL and the rest blocked."""
    proc = subprocess.run([sys.executable, "-c", _CLI_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ["cli", "ok"]
