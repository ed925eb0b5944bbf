"""Inpainting sampling inputs: the base image and mask, the mask's erosion,
the conditioning image, and FLUX.1-fill's 8x8 mask-channel shuffle.

Counterpart of onetrainer_tpu/sampling/inpaint.py (reference:
modules/modelSampler/FluxSampler.py:206-325,
modules/dataLoader/flux/ShuffleFluxFillMaskChannels.py:5-30). PNG inputs
are read by the port's codec and resized by the loader's `resize_bilinear`,
bit for bit as the reference's Pillow calls; other image formats need
Pillow. `flux_fill_mask_channels` is the reference's code.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from onetrainer_tpu_torch.data.loader import resize_bilinear, resize_nearest
from onetrainer_tpu_torch.io import png


def erode_mask(mask: np.ndarray, radius: int = 2) -> np.ndarray:
    """The mask [H, W, 1] box-filtered (a (2r+1)^2 mean, zero padding) and
    thresholded at 0.5: the masked region shrinks so seams fall inside it."""
    size = radius * 2 + 1
    x = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).permute(2, 0, 1)[None]
    blurred = F.avg_pool2d(x, size, stride=1, padding=radius, count_include_pad=True)
    return (blurred[0].permute(1, 2, 0) > 0.5).numpy().astype(np.float32)


def _read_resized(path: str, mode: str, width: int, height: int) -> np.ndarray:
    """The file at `path` converted to `mode` ("RGB" or "L") as uint8 and
    resized to width x height (bilinear)."""
    pixels = png.read_png_rgb(path) if mode == "RGB" else png.read_png_l(path)
    if pixels is None:
        from PIL import Image
        with Image.open(path) as img:
            pixels = np.asarray(img.convert(mode))
    return resize_bilinear(np.asarray(pixels, np.uint8), width, height)


def load_inpainting_inputs(sample_config, height: int, width: int):
    """-> (image in [-1, 1] [H, W, 3], eroded pixel mask [H, W, 1],
    conditioning image = image * (1 - mask)). Without
    `sample_inpainting`: a black image, a full mask and the black image (the
    reference feeds a black conditioning image and a full mask)."""
    if not sample_config.sample_inpainting:
        image = np.zeros((height, width, 3), np.float32)
        mask = np.ones((height, width, 1), np.float32)
        return image, mask, image
    image = _read_resized(sample_config.base_image_path, "RGB", width, height)
    image = np.asarray(image, np.float32) / 255.0
    mask = _read_resized(sample_config.mask_image_path, "L", width, height)
    mask = erode_mask((np.asarray(mask, np.float32) / 255.0)[..., None])
    image = image * 2.0 - 1.0
    conditioning = image * (1.0 - mask)
    return image, mask, conditioning


def downsample_mask(mask: np.ndarray, scale: int) -> np.ndarray:
    """Pixel mask [H, W, 1] -> latent-resolution mask (nearest, through
    uint8)."""
    h, w = mask.shape[:2]
    pixels = resize_nearest((mask[..., 0] * 255).astype(np.uint8), w // scale, h // scale)
    return (np.asarray(pixels, np.float32) / 255.0)[..., None]


def flux_fill_mask_channels(mask: np.ndarray, scale: int = 8) -> np.ndarray:
    """Pixel mask [H,W,1] -> [H/8, W/8, 64]: each latent cell carries its
    8×8 pixel-mask patch as channels
    (reference: ShuffleFluxFillMaskChannels.py:5-30; FluxSampler.py:300-316)."""
    h, w = mask.shape[:2]
    gh, gw = h // scale, w // scale
    m = mask[..., 0].reshape(gh, scale, gw, scale)
    return m.transpose(0, 2, 1, 3).reshape(gh, gw, scale * scale)


def inpainting_latents(vae, sample_config, height: int, width: int,
                       device: torch.device) -> tuple[torch.Tensor, np.ndarray]:
    """(the conditioning image's VAE latent [1, h, w, C], unscaled: the
    encode's mean; the eroded pixel mask [H, W, 1]) of a sample config,
    encoded once on `device`."""
    _, mask, conditioning = load_inpainting_inputs(sample_config, height, width)
    cond = torch.from_numpy(np.ascontiguousarray(conditioning))[None].to(device)
    latent, _ = vae.encode(cond)
    return latent.float(), mask


def unet_inpainting_channels(vae, vae_config, sample_config, height: int, width: int,
                             device: torch.device) -> torch.Tensor:
    """The channels a 9-channel UNet takes after the noisy latent, [1, h,
    w, 1 + C]: the mask downsampled to the latent and the conditioning
    latent times the VAE's scaling factor."""
    latent, mask = inpainting_latents(vae, sample_config, height, width, device)
    latent_mask = torch.from_numpy(downsample_mask(mask, vae_config.spatial_scale))[None]
    return torch.cat([latent_mask.to(device), latent * vae_config.scaling_factor], dim=-1)
