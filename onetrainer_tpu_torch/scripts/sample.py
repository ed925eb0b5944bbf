"""Standalone sampling with the port (reference: scripts/sample.py):

    python -m onetrainer_tpu_torch.scripts.sample --model-type STABLE_DIFFUSION_15 \
        --base-model-name <dir-or-file> --prompt "a cat" \
        --destination out.png [--steps 20 --cfg 7 --width 512 --height 512] \
        [--sample-inpainting --base-image-path base.png --mask-image-path mask.png] \
        [--embedding-name embedding.safetensors] [--decoder-model-name <dir>] \
        [--device cuda]

The arguments are the reference's. SD 1.5/2.x, SDXL, SD3, FLUX.1-dev,
HunyuanVideo, PixArt-α/Σ, Sana, Würstchen v2 and Stable Cascade
text-to-image run (SD3, FLUX and HunyuanVideo from a diffusers directory
or their single file: SAI's, BFL's and HunyuanVideo's, with the VAE and
text encoders bundled; PixArt and Sana from a diffusers directory;
Würstchen v2 from a prior directory, decoded through DiffNeXt and the
Paella VQGAN of `--decoder-model-name`'s decoder directory, else through
the reference's linear stand-in, as Stable Cascade always is, from a
prior directory or its stage_c file; FLUX and HunyuanVideo take `--cfg`
as their guidance
embedding and ignore the negative prompt and the scheduler; HunyuanVideo
samples one frame, the sample config's default, and writes it as the
image), and so do the inpainting models: SD 1.5 and SD 2.0 inpainting,
SDXL inpainting and FLUX.1-fill, which with `--sample-inpainting` fill the
white region of `--mask-image-path` in `--base-image-path` (both resized to
the sample's size; PNGs need no Pillow) and without it start from a black
image and a full mask, as the reference does. `--embedding-name` loads a
trained embedding file (the train command's EMBEDDING output, or the
reference's) into each text encoder's rows past its vocabulary, under the
file's placeholder: the config's `embedding.placeholder`, `<embedding>` by
default, which the prompt names (the reference's scripts/sample.py:69-74).
Other model types raise NotImplementedError. Sampling runs
on the card unless `--device` names another device. A PNG destination is
written by the port's own PNG codec; other formats need Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description="Sample from a model")
    p.add_argument("--model-type", required=True)
    p.add_argument("--base-model-name", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--destination", required=True)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--cfg", type=float, default=7.0)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--scheduler", default="DDIM")
    p.add_argument("--decoder-model-name", default="",
                   help="Würstchen/Cascade stage-B decoder repo dir "
                        "(reference: ModelNames.decoder_model)")
    p.add_argument("--embedding-name", default="",
                   help="a trained embedding safetensors to apply")
    p.add_argument("--text-encoder-layer-skip", type=int, default=0)
    p.add_argument("--sample-inpainting", action="store_true", default=False)
    p.add_argument("--base-image-path", default="",
                   help="base image for inpainting sampling")
    p.add_argument("--mask-image-path", default="",
                   help="mask image for inpainting sampling")
    p.add_argument("--weight-dtype", default="",
                   help="weight dtype during sampling (e.g. BFLOAT_16)")
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default: cuda)")
    return p.parse_args(argv)


def save_image(path: str, image: np.ndarray) -> None:
    """Write a uint8 HWC image: PNG with the port's codec, else Pillow."""
    if path.lower().endswith(".png"):
        from onetrainer_tpu_torch.io.png import write_png
        write_png(path, image)
        return
    from PIL import Image
    Image.fromarray(image).save(path)


def main(argv: list[str] | None = None):
    """Sample one image as the command line (or `argv`) asks, write it to
    the destination and return the sampler's output."""
    args = parse_args(argv)
    from onetrainer_tpu_torch.config.sample_config import SampleConfig
    from onetrainer_tpu_torch.config.train_config import TrainConfig
    from onetrainer_tpu_torch.setup.families import get_family
    from onetrainer_tpu_torch.util.enums import (
        DataType, ModelType, NoiseScheduler, TrainingMethod,
    )

    config = TrainConfig.default_values()
    config.model_type = ModelType[args.model_type]
    if not (config.model_type.is_stable_diffusion()
            or config.model_type.is_stable_diffusion_xl()
            or config.model_type.is_stable_diffusion_3()
            or config.model_type.is_flux() or config.model_type.is_hunyuan_video()
            or config.model_type.is_pixart() or config.model_type.is_sana()
            or config.model_type.is_wuerstchen()):
        raise NotImplementedError(f"{config.model_type} sampling is not ported "
                                  "(SD 1.5/2.x, SDXL, SD3, FLUX.1-dev, FLUX.1-fill, "
                                  "HunyuanVideo, PixArt-α/Σ, Sana, Würstchen v2 and "
                                  "Stable Cascade only)")
    config.base_model_name = args.base_model_name
    if args.decoder_model_name:
        config.decoder.model_name = args.decoder_model_name
    config.training_method = TrainingMethod.FINE_TUNE
    config.unet.train = False
    config.prior.train = False
    config.text_encoder.train = False
    config.text_encoder_2.train = False
    if args.embedding_name:
        # the embedding's vectors become the text encoders' extra rows
        config.training_method = TrainingMethod.EMBEDDING
        config.embedding.model_name = args.embedding_name
    if args.weight_dtype:
        config.weight_dtype = DataType[args.weight_dtype]

    family = get_family(config.model_type)
    model = family.load(args.base_model_name, config, device=args.device)
    setup = family.create_setup(model, config, 1)

    sample_config = SampleConfig.default_values()
    sample_config.prompt = args.prompt
    sample_config.negative_prompt = args.negative_prompt
    sample_config.width = args.width
    sample_config.height = args.height
    sample_config.diffusion_steps = args.steps
    sample_config.cfg_scale = args.cfg
    sample_config.seed = args.seed
    sample_config.noise_scheduler = NoiseScheduler[args.scheduler]
    sample_config.text_encoder_1_layer_skip = args.text_encoder_layer_skip
    sample_config.sample_inpainting = args.sample_inpainting
    sample_config.base_image_path = args.base_image_path
    sample_config.mask_image_path = args.mask_image_path

    out = family.sample(setup, sample_config, lambda s, m: print(f"step {s}/{m}"))
    os.makedirs(os.path.dirname(os.path.abspath(args.destination)), exist_ok=True)
    save_image(args.destination, out.image)
    print(f"saved {args.destination}")
    return out


if __name__ == "__main__":
    main()
