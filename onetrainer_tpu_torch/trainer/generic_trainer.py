"""The local training loop: load → setup → cache → epoch/step loop →
backup/save → final save.

Counterpart of onetrainer_tpu/trainer/generic_trainer.py (reference:
modules/trainer/GenericTrainer.py): the same status sequence, cadence
(TimedAction-scheduled backup and save, TrainCommands polling, rolling
backups, backup_before_save), TensorBoard scalars (`loss/train_step`,
`smooth_loss/train_step`, per-group `lr/*`) and file layout, for LoRA,
FINE_TUNE and EMBEDDING training of the models the port runs (SD 1.5/2.x,
SDXL, SD3, FLUX and HunyuanVideo, the last over video clips too), with
additional embeddings, EMA and gradient accumulation, and the VAE
fine-tune (FINE_TUNE_VAE) of SD 1.5/2.x.

Where the port departs from the reference:
- Features it has not ported raise at `start()` instead of being
  skipped: validation, sampling during training (a non-empty `samples`),
  EMA held on the CPU, prior preservation, the debug dump, a device mesh,
  circular padding and host offload.
- A backup holds the optimizer state (`optimizer.safetensors`, with the
  adapters for LoRA), the EMA (`ema.safetensors`) when on, `meta.json`
  and `onetrainer_config/args.json`; embedding vectors are kept in
  `optimizer.safetensors` under params/<group>. For FINE_TUNE and
  FINE_TUNE_VAE it holds the trained model too, in fp32 as the reference
  writes it: a
  diffusers directory `model/` when the base is one, else a single file
  `model.safetensors` in the base's layout (LDM, SAI, BFL or
  HunyuanVideo's; a diffusers directory written from a single-file base
  would carry no configs), and a resume loads the trained weights from
  it. The FINE_TUNE and FINE_TUNE_VAE output is a diffusers directory or,
  with a single-file `output_model_format`, the family's single file; the
  EMBEDDING output is the embedding file (setup/families.py:
  save_embedding_output). A LoRA or EMBEDDING backup holds no model: a resume loads the base from
  `config.base_model_name` and the adapters from the backup, as
  OneTrainer does. (The reference's LoRA backup holds the merged base +
  LoRA as `model/` and its resume loads that as the base and applies the
  adapters on top of it a second time; ROADMAP queue 3, F7.)
- Randomness: the generator of each step is seeded from (42, global
  step), so a resumed run draws what an uninterrupted one would, as the
  reference's step folds its step counter into a fixed key.
- The loss of step N is read after step N+1 is dispatched (lag 1,
  fixed); there is no OT_METRICS_LAG, OT_MEM_DEBUG or transport retry.
- Caching runs under the "epoch N: caching" status, before the step loop
  starts: every encode and step runs on the calling thread.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import traceback
from contextlib import nullcontext

import numpy as np
import torch

from onetrainer_tpu_torch.config.train_config import TrainConfig
from onetrainer_tpu_torch.data.loader import Text2ImageDataLoader
from onetrainer_tpu_torch.io.safetensors_io import SafetensorsFile, save_safetensors
from onetrainer_tpu_torch.setup.families import (
    get_family, save_embedding_output, save_lora_output,
)
from onetrainer_tpu_torch.setup.sd_setup import refuse_unported
from onetrainer_tpu_torch.train.optimizers import (
    opt_state_tensors, schedule_free_eval, set_opt_state_counts,
)
from onetrainer_tpu_torch.train.train_state import param_groups
from onetrainer_tpu_torch.trainer.base_trainer import BaseTrainer
from onetrainer_tpu_torch.util.callbacks import TrainCallbacks
from onetrainer_tpu_torch.util.commands import TrainCommands
from onetrainer_tpu_torch.util.enums import ModelType, TimeUnit, TrainingMethod
from onetrainer_tpu_torch.util.path_util import get_string_timestamp
from onetrainer_tpu_torch.util.train_progress import TrainProgress

STEP_SEED = 42
# the methods whose backup holds the trained model
_MODEL_BACKUP = (TrainingMethod.FINE_TUNE, TrainingMethod.FINE_TUNE_VAE)
_MESH_KNOBS = ("OT_MESH_DP", "OT_MESH_FSDP", "OT_MESH_SP")


def step_seed(global_step: int) -> int:
    """The seed of step `global_step`'s generator: a function of (42, step)."""
    return int(np.random.SeedSequence([STEP_SEED, global_step]).generate_state(
        1, np.uint64)[0])


def unported_features(config: TrainConfig) -> list[str]:
    """What `config` asks of the training loop that the port's trainer does
    not run (what it asks of the setup: setup/sd_setup.py:refuse_unported)."""
    asked = {
        "validation": config.validation,
        "sampling during training": bool(config.samples),
        "the debug dump": config.debug_mode,
        "a device mesh": any(int(os.environ.get(k, 0) or 0) > 1 for k in _MESH_KNOBS),
        "circular padding": bool(config.force_circular_padding),
        "host offload": config.gradient_checkpointing.offload(),
    }
    return [what for what, on in asked.items() if on]


def state_tensors(state) -> tuple[dict, dict]:
    """(tensors, metadata) of a train state for `optimizer.safetensors`:
    LoRA adapters under params/<group>/<adapter key>/<name>, embedding
    vectors under params/<group> (a fine-tuned module's parameters are the
    backup's model, not here), the optimizer's state tensors under
    opt_state/<...> (train/optimizers.py: opt_state_tensors), its step
    counts in the metadata."""
    tensors = {f"params/{group}/{key}/{name}": t.detach()
               for group, tree in state.params.items() if isinstance(tree, dict)
               for key, entry in tree.items() if isinstance(entry, dict)
               for name, t in entry.items()}
    tensors.update({f"params/{group}": t.detach() for group, t in state.params.items()
                    if isinstance(t, torch.Tensor)})
    opt, counts = opt_state_tensors(state.opt_state)
    tensors.update({f"opt_state/{k}": t for k, t in opt.items()})
    return tensors, {k: str(v) for k, v in counts.items()}


def ema_tensors(state) -> tuple[dict, dict]:
    """(tensors, metadata) of a train state's EMA for `ema.safetensors`:
    params/<group>/<name> (train/train_state.py:param_names), the update
    count in the metadata."""
    from onetrainer_tpu_torch.train.train_state import param_names
    names, tensors = param_names(state.ema.params), param_groups(state.ema.params)
    return ({f"params/{group}/{name}": t for group in names
             for name, t in zip(names[group], tensors[group])},
            {"step": str(state.ema.step)})


class GenericTrainer(BaseTrainer):
    def __init__(self, config: TrainConfig,
                 callbacks: TrainCallbacks | None = None,
                 commands: TrainCommands | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__(config, callbacks or TrainCallbacks(),
                         commands or TrainCommands())
        self.device = torch.device(device)
        self.model = None
        self.setup = None
        self.family = None
        self.data_loader: Text2ImageDataLoader | None = None
        self.train_progress = TrainProgress()
        self._loss_ema = None
        self._pending_metrics: list = []   # [(metrics, global_step), ...]

    # -- lifecycle ----------------------------------------------------------------

    def start(self):
        config = self.config
        refuse_unported(config)
        unported = unported_features(config)
        if unported:
            raise NotImplementedError(
                f"not ported to the torch trainer yet: {', '.join(unported)}")
        self.callbacks.on_update_status("loading the model")

        last_backup = config.get_last_backup_path() if config.continue_last_backup else None
        if last_backup:
            print(f"resuming from backup {last_backup}")
            self._restore_backup_meta(last_backup)

        self.family = get_family(config.model_type)
        self._source_dir = config.base_model_name
        if last_backup and config.training_method in _MODEL_BACKUP:
            # the trained weights, from the backup's model
            self._source_dir = next(
                (p for p in (os.path.join(last_backup, name)
                             for name in ("model", "model.safetensors")) if os.path.exists(p)),
                None)
            if self._source_dir is None:
                raise FileNotFoundError(f"backup {last_backup} holds no model")
        self.model = self.family.load(self._source_dir, config, device=self.device)

        self.callbacks.on_update_status("creating the data loader")
        self.data_loader = Text2ImageDataLoader(
            config, None, None, quantization=self.family.quantization,
            model_tag=str(config.model_type),
            latent_scale=self.model.vae_config.spatial_scale,
            conditioning_image=(config.model_type.has_conditioning_image_input()
                                or config.custom_conditioning_image),
            fill_mask_channels=config.model_type == ModelType.FLUX_FILL_DEV_1,
            video_mode=self.family.video,
            cache_pixels=config.training_method == TrainingMethod.FINE_TUNE_VAE)
        steps_per_epoch = max(len(self.data_loader), 1)
        total = config.epochs * steps_per_epoch // max(
            config.gradient_accumulation_steps, 1)
        self.setup = self.family.create_setup(
            self.model, config, max(total, 1), steps_per_epoch)
        if self.setup.train_step is None:
            raise ValueError("the config trains no part (unet, text encoders, embeddings)")
        self.data_loader.encode_images, self.data_loader.encode_text = \
            self.family.make_encode_fns(self.setup)

        if last_backup:
            self._restore_internal_state(last_backup)

    def _restore_backup_meta(self, backup_dir: str):
        meta_path = os.path.join(backup_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.train_progress = TrainProgress.from_dict(
                    json.load(f).get("train_progress", {}))

    @torch.no_grad()
    def _restore_internal_state(self, backup_dir: str):
        """Copy the backup's optimizer state, LoRA adapters, embedding
        vectors and EMA into the setup's tensors in place (the layers hold
        the adapters, the step the vectors, by reference); a backup that
        does not match the configured training raises."""
        state = self.setup.state
        for file, (want, _) in (("optimizer.safetensors", state_tensors(state)),
                                ("ema.safetensors", ema_tensors(state)
                                 if state.ema is not None else (None, None))):
            if want is None:
                continue
            with SafetensorsFile(os.path.join(backup_dir, file)) as f:
                if set(f.keys()) != set(want):
                    raise ValueError(f"backup {backup_dir} does not match the configured "
                                     f"training ({file})")
                for key, t in want.items():
                    t.copy_(f.tensor(key).reshape(t.shape))   # a 0-dim scalar is stored as [1]
                if file == "optimizer.safetensors":
                    set_opt_state_counts(state.opt_state, f.metadata)
                else:
                    state.ema.step = int(f.metadata["step"])
        state.step = self.train_progress.global_step
        print("restored optimizer state")

    # -- scheduled actions ----------------------------------------------------------

    def _needs(self, name: str, interval, unit: TimeUnit, start_at_zero=False) -> bool:
        return self.repeating_action_needed(
            name, interval, unit, self.train_progress, start_at_zero=start_at_zero)

    def backup(self, train_progress: TrainProgress | None = None):
        progress = train_progress or self.train_progress
        self.callbacks.on_update_status("creating backup")
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        backup_dir = os.path.join(
            self.config.workspace_dir, "backup",
            f"{stamp}-backup-{progress.filename_string()}")
        try:
            self._save_internal(backup_dir, progress)
            self._prune_backups()
        except Exception:
            traceback.print_exc()
            shutil.rmtree(backup_dir, ignore_errors=True)

    def _save_internal(self, backup_dir: str, progress: TrainProgress):
        os.makedirs(backup_dir, exist_ok=True)
        state = self.setup.state
        if self.config.training_method in _MODEL_BACKUP:
            # the trained weights (not the EMA), fp32, in the base's layout
            if os.path.isfile(self._source_dir):
                self.family.save_single_file(
                    self.setup, os.path.join(backup_dir, "model.safetensors"), ema=False)
            else:
                self.family.save_model(self.setup, os.path.join(backup_dir, "model"),
                                       self._source_dir, ema=False)
        tensors, meta = state_tensors(state)
        save_safetensors(os.path.join(backup_dir, "optimizer.safetensors"), tensors, meta)
        if state.ema is not None:
            save_safetensors(os.path.join(backup_dir, "ema.safetensors"), *ema_tensors(state))
        with open(os.path.join(backup_dir, "meta.json"), "w") as f:
            json.dump({"train_progress": progress.to_dict()}, f, indent=2)
        # config copies (reference: GenericTrainer.__save_backup_config)
        config_dir = os.path.join(backup_dir, "onetrainer_config")
        os.makedirs(config_dir, exist_ok=True)
        with open(os.path.join(config_dir, "args.json"), "w") as f:
            json.dump(self.config.to_settings_dict(secrets=False), f, indent=4)

    def _prune_backups(self):
        if not self.config.rolling_backup:
            return
        backups_dir = os.path.join(self.config.workspace_dir, "backup")
        if not os.path.isdir(backups_dir):
            return
        backups = sorted(
            p for p in os.listdir(backups_dir)
            if os.path.isdir(os.path.join(backups_dir, p)))
        for p in backups[:-self.config.rolling_backup_count]:
            shutil.rmtree(os.path.join(backups_dir, p), ignore_errors=True)

    def save(self, destination: str | None = None,
             raise_on_error: bool = False):
        self.callbacks.on_update_status("saving")
        destination = destination or self.config.output_model_destination
        try:
            self._save_output(destination)
        except Exception:
            # mid-training saves are best-effort like the reference's,
            # but the FINAL save must not fail silently
            if raise_on_error:
                raise
            traceback.print_exc()

    def _save_output(self, destination: str):
        """The LoRA file, the embedding file, or the fine-tuned model as a
        single file or a diffusers directory (output_model_format), with
        the EMA in place of the trained tensors when on, else, under a
        schedule-free optimizer, its eval params x, with the trained y put
        back afterwards (the reference's _export_params and _save_output,
        generic_trainer.py:334-431; OneTrainer's optimizer.eval() before a
        save). Every exported tensor is cast to output_dtype (reference:
        GenericTrainer.py:479; backups keep the train dtype and y)."""
        state = self.setup.state
        swap = nullcontext() if state is None or state.ema is not None else \
            schedule_free_eval(state.opt_state, param_groups(state.params))
        with swap:
            self._write_output(destination)

    def _write_output(self, destination: str):
        config = self.config
        save_dtype = config.output_dtype.to_save_dtype()
        if config.training_method == TrainingMethod.LORA:
            save_lora_output(self.setup, destination, self.family.lora_prefixes,
                             save_dtype=save_dtype)
        elif config.training_method == TrainingMethod.EMBEDDING:
            save_embedding_output(self.setup, destination, save_dtype=save_dtype)
        elif config.output_model_format.is_single_file():
            if not destination.endswith((".safetensors", ".ckpt")):
                destination += config.output_model_format.file_extension()
            self.family.save_single_file(self.setup, destination, save_dtype=save_dtype)
        else:
            self.family.save_model(self.setup, destination, self._source_dir,
                                   save_dtype=save_dtype)

    # -- the loop -------------------------------------------------------------------

    def train(self):
        config = self.config
        progress = self.train_progress
        generator = torch.Generator(device=self.device)

        for epoch in range(progress.epoch, config.epochs):
            self.callbacks.on_update_status(f"epoch {epoch}: caching")
            self.data_loader.ensure_cached(self.data_loader.batches_for_epoch(epoch))
            start_batch = progress.epoch_step if epoch == progress.epoch else 0

            if config.only_cache:
                progress.next_epoch()
                continue

            self.callbacks.on_update_status(f"training epoch {epoch}")
            for batch in self.data_loader.iter_epoch(epoch, start_batch):
                if self.commands.get_stop_command():
                    self._flush_pending_metrics()
                    return

                if self._needs("backup", config.backup_after,
                               config.backup_after_unit) \
                        or self.commands.get_and_reset_backup_command():
                    self._flush_pending_metrics()
                    self.backup()

                if config.save_every_unit != TimeUnit.NEVER and \
                        self._needs("save", config.save_every, config.save_every_unit) \
                        and self.single_action_elapsed(
                            "save_skip_first", config.save_skip_first,
                            config.save_every_unit, progress) \
                        or self.commands.get_and_reset_save_command():
                    dest = os.path.join(
                        config.workspace_dir, "save",
                        f"{config.save_filename_prefix}{get_string_timestamp()}-save-"
                        f"{progress.filename_string()}")
                    os.makedirs(os.path.dirname(dest), exist_ok=True)
                    self.save(dest)

                generator.manual_seed(step_seed(progress.global_step))
                metrics = self.setup.train_step(self.setup.state, batch, generator)
                # step N's loss is read here on a later iteration, after
                # step N+1 is dispatched
                self._pending_metrics.append((metrics, progress.global_step))
                self._flush_pending_metrics(keep=1)
                progress.next_step(config.batch_size)
                self.callbacks.on_update_train_progress(
                    progress, len(self.data_loader), config.epochs)

            self._flush_pending_metrics()
            progress.next_epoch()

    def _flush_pending_metrics(self, keep: int = 0):
        while len(self._pending_metrics) > keep:
            metrics, step = self._pending_metrics.pop(0)
            self._log_metrics(float(metrics["loss"]), step)

    def _log_metrics(self, loss: float, step: int):
        if self._loss_ema is None:
            self._loss_ema = loss
        decay = min(0.99, 1 - 1 / (step + 1))
        self._loss_ema = self._loss_ema * decay + loss * (1 - decay)
        if not self.tensorboard:
            return
        self.tensorboard.add_scalar("loss/train_step", loss, step)
        self.tensorboard.add_scalar("smooth_loss/train_step", self._loss_ema, step)
        for name, schedule in self.setup.group_schedules.items():
            self.tensorboard.add_scalar(f"lr/{name}", float(schedule(step)), step)

    def end(self):
        try:
            if self.config.backup_before_save:
                self.backup()
            dest = self.config.output_model_destination
            if os.path.isdir(dest) and self.config.output_model_format.is_single_file():
                # the reference drops a timestamped file INTO an existing
                # directory destination (GenericTrainer.py:780-784)
                dest = os.path.join(
                    dest, f"{self.config.save_filename_prefix}{get_string_timestamp()}"
                          f"{self.config.output_model_format.file_extension()}")
            self.save(dest, raise_on_error=True)
        finally:
            if self.tensorboard:
                self.tensorboard.close()
            self._stop_tensorboard()

