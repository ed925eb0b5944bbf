"""Parity of the torch port's SD VAE fine-tune (FINE_TUNE_VAE) with the
reference (onetrainer_tpu/setup/sd_setup.py `create_sd_setup`,
FINE_TUNE_VAE branch, and onetrainer_tpu/train/vae_train_step.py
`make_vae_train_step`), on the tiny SD 1.5-shaped model of
tests/test_torch_port_train_sd.py with the same weights, built through the
setup entry points from one config, the batch the cached latents and the
original pixels:
- fp32: AdamW, clip 1.0, an EMA (decay 0.999, every update);
- bf16: the VAE's parameters in bf16, AdamW, stochastic rounding on the
  reference's own rounding bits.
Each side takes two steps on the reference's latent-sampling draws (its
key splits, vae_train_step.py:43 and :25).

Tolerances: loss and grad_norm 1e-4 relative in fp32; the VAE's change
from its initial weights, and the EMA's, FT_REL relative L2 after each
step (tests/test_torch_port_train_finetune.py gives the reason: AdamW moves
an element by about lr whatever its gradient's size, so rounding decides
near-zero gradients): the biases of the decoder's 32-channel block, each
channel there its own GroupNorm group, and the attention's key bias have
an exact gradient of zero and are left out (ZERO_GRADIENT). bf16: F8's
rule of that file, as there: each element
after step k within the sum over steps j <= k of one bf16 step of the
reference's value after j (2^-7 relative) plus 2^-5 of the reference's
change in step j, but for at most BF16_OUTSIDE of the elements, and at
most BF16_OTHER_NEIGHBOUR on the other bf16 neighbour; the loss 1e-3 and
the grad norm 2^-5 relative (bf16 networks summed in another order).
The UNet and the text encoder stay bit for bit; the data loader's pixel
cache holds each image beside its latents. Torch runs one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onetrainer_tpu.io import torch_flax as jax_tf
from onetrainer_tpu.setup import sd_setup as jax_setup
from onetrainer_tpu.util.enums import EMAMode, TrainingMethod
from onetrainer_tpu_torch.config.train_config import TrainConfig as PortTrainConfig
from onetrainer_tpu_torch.setup.families import get_family
from tests.test_torch_port_train_finetune import (
    BF16_OTHER_NEIGHBOUR, BF16_OUTSIDE, BF16_STEP, BF16_UPDATE_REL, FT_REL, NORM_REL_BF16,
    _flat, _rel,
)
from tests.test_torch_port_train_sd import _configs, _images, tiny_sd_pair
from tests.test_torch_port_train_sdxl import SEED, _round_bits

REL = 1e-4
LOSS_REL_BF16 = 1e-3
STEPS = 2


def ZERO_GRADIENT(name: str) -> bool:
    """A VAE parameter whose exact gradient is zero in the decode."""
    return name.endswith("to_k.bias") or (
        name.startswith("decoder.up_blocks.1.") and name.endswith(".bias"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vae_configs(case: str):
    config, _ = _configs("sd15")
    config.training_method = TrainingMethod.FINE_TUNE_VAE
    config.learning_rate = 1e-3
    config.clip_grad_norm = 1.0
    if case == "fp32":
        config.ema = EMAMode.GPU
        config.ema_decay = 0.999
        config.ema_update_step_interval = 1
    else:
        config.optimizer.stochastic_rounding = True
    return config, PortTrainConfig.default_values().from_dict(config.to_dict())


def _vae_state_dict(tree) -> dict:
    return jax_tf.vae_flax_to_state_dict(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jax.device_get(tree)))


def _batch(encode_images, images, as_array) -> dict:
    batch = {k: as_array(v) for k, v in encode_images(images).items()}
    batch["image"] = as_array(images)
    batch["loss_weight"] = as_array(np.ones((2,), np.float32))
    return batch


def _reference(case: str) -> dict:
    jax_model, _, port = tiny_sd_pair("sd15")
    if case == "bf16":
        jax_model.vae_params = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                            jax_model.vae_params)
        port.vae.to(torch.bfloat16)
    config, port_config = _vae_configs(case)
    setup = jax_setup.create_sd_setup(jax_model, config, total_steps=10)
    init = _vae_state_dict(setup.state.params["vae"])
    images = _images()
    encode_images, _ = jax_setup.make_encode_fns(setup)
    batch = jax.tree.map(jnp.asarray, _batch(encode_images, images, np.asarray))
    rng = jax.random.PRNGKey(SEED)
    state, steps = setup.state, []
    for step in range(STEPS):
        rng_loss, _ = jax.random.split(jax.random.fold_in(rng, step))
        latent = batch["latent_image"]
        draws = {"latent_noise": np.asarray(jax.random.normal(rng_loss, latent.shape,
                                                              latent.dtype))}
        if case == "bf16":
            bits = jax.device_get(_round_bits(state.params, rng, step))
            draws["round_bits"] = {"vae": {k: np.ascontiguousarray(v).astype(np.int64)
                                           for k, v in _vae_state_dict(bits["vae"]).items()}}
        state, metrics = setup.train_step(state, setup.frozen, batch, rng)
        steps.append(dict(draws=draws, loss=float(metrics["loss"]),
                          grad_norm=float(metrics["grad_norm"]),
                          params=_vae_state_dict(state.params["vae"]),
                          ema=None if state.ema is None
                          else _vae_state_dict(state.ema.params["vae"])))
    return dict(case=case, port=port, port_config=port_config, init=init, images=images,
                batch=jax.device_get(batch), steps=steps)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def run(request):
    """The reference's two steps, then the port's on its draws."""
    ref = _reference(request.param)
    family = get_family(ref["port_config"].model_type)
    setup = family.create_setup(ref["port"], ref["port_config"], 10)
    frozen = {f"{name}.{k}": v.clone() for name, m in setup.model.modules().items()
              if name != "vae" for k, v in m.state_dict().items()}
    encode_images, _ = family.make_encode_fns(setup)
    batch = _batch(encode_images, torch.from_numpy(ref["images"]), torch.as_tensor)
    for name in ("latent_image", "latent_logvar"):
        np.testing.assert_allclose(batch[name].float().numpy(), ref["batch"][name],
                                   atol=1e-4 if request.param == "fp32" else 5e-2, rtol=0)
    gen = torch.Generator().manual_seed(0)
    steps = []
    for ref_step in ref["steps"]:
        draws = {"latent_noise": torch.from_numpy(ref_step["draws"]["latent_noise"].copy())}
        if "round_bits" in ref_step["draws"]:
            draws["round_bits"] = {"vae": {k: torch.from_numpy(v) for k, v in
                                           ref_step["draws"]["round_bits"]["vae"].items()}}
        out = setup.train_step(setup.state, batch, gen, **draws)
        steps.append(dict(loss=float(out["loss"]), grad_norm=float(out["grad_norm"]),
                          params={k: t.detach().float().clone()
                                  for k, t in setup.state.params["vae"].items()}))
    return ref, setup, steps, frozen


def test_vae_fine_tune_steps_match_jax(run):
    ref, setup, steps, frozen = run
    bf16 = ref["case"] == "bf16"
    assert set(setup.state.params) == {"vae"}
    assert list(setup.state.params["vae"]) == [n for n, _ in setup.model.vae.named_parameters()]
    assert set(setup.state.params["vae"]) == set(ref["init"])
    assert not setup.step_cfg.loss.masked_training
    for i, (got, want) in enumerate(zip(steps, ref["steps"])):
        assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_REL_BF16 if bf16 else REL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=NORM_REL_BF16 if bf16 else REL)
    names = [n for n in ref["init"] if not ZERO_GRADIENT(n)]
    limit = 0.0
    for i, (got, want) in enumerate(zip(steps, ref["steps"])):
        g = _flat({n: got["params"][n].numpy() for n in names}, names)
        w = _flat(want["params"], names)
        before = _flat(ref["init"] if i == 0 else ref["steps"][i - 1]["params"], names)
        if not bf16:
            start = _flat(ref["init"], names)
            assert _rel(g - start, w - start) <= FT_REL, i
            continue
        change = np.abs(w - before)
        limit = limit + BF16_STEP * np.abs(w) + BF16_UPDATE_REL * change
        outside = float(np.mean(np.abs(g - w) > limit))
        other = float(np.mean(g != w))
        print(f"bf16 after {i + 1} step(s): {100 * other:.3f}% of {w.size} elements on "
              f"the other bf16 neighbour, {int(round(outside * w.size))} outside the bound")
        assert outside <= BF16_OUTSIDE[i + 1], i
        assert other <= BF16_OTHER_NEIGHBOUR[i + 1], i
    if not bf16:
        start = _flat(ref["init"], names)
        ema = _flat({n: t.numpy() for n, t in setup.state.ema.params["vae"].items()}, names)
        assert _rel(ema - start, _flat(ref["steps"][-1]["ema"], names) - start) <= FT_REL
    else:
        assert all(t.dtype == torch.bfloat16 for t in setup.state.params["vae"].values())
    after = {f"{name}.{k}": v for name, m in setup.model.modules().items()
             if name != "vae" for k, v in m.state_dict().items()}
    assert all(torch.equal(after[k], v) for k, v in frozen.items())


def test_loader_caches_the_pixels_for_the_vae_step(tmp_path):
    """With `cache_pixels` the loader's rows carry the original pixels
    ("image", NHWC in [-1, 1]) beside the latents, from the cache and
    without one, and the VAE fine-tune's trainer asks for them."""
    from onetrainer_tpu_torch.data.loader import Text2ImageDataLoader
    from tests.test_data import make_dataset
    from tests.test_trainer import tiny_train_config
    ds = make_dataset(str(tmp_path / "ds"), n=2)
    config = PortTrainConfig.default_values().from_dict(tiny_train_config(
        str(tmp_path / "base"), ds, str(tmp_path / "ws"), str(tmp_path / "cache")).to_dict())
    config.resolution = "32"
    config.batch_size = 2

    def encode_images(images):
        x = torch.as_tensor(images)
        return {"latent_image": x[:, ::8, ::8, :1] * 0 + 1,
                "latent_logvar": x[:, ::8, ::8, :1] * 0}

    def encode_text(prompt):
        return {"tokens": np.zeros(4, np.int32)}

    loader = Text2ImageDataLoader(config, encode_images, encode_text, cache_pixels=True)
    loader.ensure_cached(loader.batches_for_epoch(0))
    batch = next(iter(loader.iter_epoch(0)))
    assert batch["image"].shape == (config.batch_size, 32, 32, 3)
    assert float(batch["image"].min()) >= -1.0 and float(batch["image"].max()) <= 1.0
    plain = Text2ImageDataLoader(config, encode_images, encode_text)
    assert plain._cache_key(plain.plan_epoch(0)[0]) != loader._cache_key(loader.plan_epoch(0)[0])
