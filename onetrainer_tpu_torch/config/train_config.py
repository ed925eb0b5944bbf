"""The main training config — schema v6 with migration chain (the port's
copy of onetrainer_tpu/config/train_config.py).

JSON contract (field names, defaults, ``__version``) matches the reference
(reference: modules/util/config/TrainConfig.py:265-995) so that
training_presets/*.json and saved configs load unchanged. GPU-specific
fields (train_device, layer offload fractions, 8-bit optimizer switches)
are retained for compat; the TPU backend maps them to its own mechanisms
(sharding/remat) or treats them as no-ops.
"""

from __future__ import annotations

import json
import os
import uuid as uuid_lib
from copy import deepcopy

from onetrainer_tpu_torch.config.base_config import BaseConfig, Field
from onetrainer_tpu_torch.config.cloud_config import CloudConfig, SecretsConfig
from onetrainer_tpu_torch.config.concept_config import ConceptConfig
from onetrainer_tpu_torch.config.sample_config import SampleConfig
from onetrainer_tpu_torch.util.enums import (
    ConfigPart,
    DataType,
    EMAMode,
    GradientCheckpointingMethod,
    ImageFormat,
    AudioFormat,
    LearningRateScaler,
    LearningRateScheduler,
    LossScaler,
    LossWeight,
    ModelFormat,
    ModelType,
    NoiseScheduler,
    Optimizer,
    PeftType,
    TimestepDistribution,
    TimeUnit,
    TrainingMethod,
    VideoFormat,
)
from onetrainer_tpu_torch.util.model_names import EmbeddingName, ModelNames, ModelWeightDtypes


class TrainOptimizerConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('optimizer', Optimizer.ADAMW, Optimizer),
            Field('adam_w_mode', False, bool),
            Field('alpha', None, float, True),
            Field('amsgrad', False, bool),
            Field('beta1', None, float, True),
            Field('beta2', None, float, True),
            Field('beta3', None, float, True),
            Field('bias_correction', False, bool),
            Field('block_wise', False, bool),
            Field('capturable', False, bool),
            Field('centered', False, bool),
            Field('clip_threshold', None, float, True),
            Field('d0', None, float, True),
            Field('d_coef', None, float, True),
            Field('dampening', None, float, True),
            Field('decay_rate', None, float, True),
            Field('decouple', False, bool),
            Field('differentiable', False, bool),
            Field('eps', None, float, True),
            Field('eps2', None, float, True),
            Field('foreach', False, bool, True),
            Field('fsdp_in_use', False, bool),
            Field('fused', False, bool),
            Field('fused_back_pass', False, bool),
            Field('growth_rate', None, float, True),
            Field('initial_accumulator_value', None, int, True),
            Field('initial_accumulator', None, float, True),
            Field('is_paged', False, bool),
            Field('log_every', None, int, True),
            Field('lr_decay', None, float, True),
            Field('max_unorm', None, float, True),
            Field('maximize', False, bool),
            Field('min_8bit_size', None, int, True),
            Field('momentum', None, float, True),
            Field('nesterov', False, bool),
            Field('no_prox', False, bool),
            Field('optim_bits', None, int, True),
            Field('percentile_clipping', None, int, True),
            Field('r', None, float, True),
            Field('relative_step', False, bool),
            Field('safeguard_warmup', False, bool),
            Field('scale_parameter', False, bool),
            Field('stochastic_rounding', True, bool),
            Field('use_bias_correction', False, bool),
            Field('use_triton', False, bool),
            Field('warmup_init', False, bool),
            Field('weight_decay', None, float, True),
            Field('weight_lr_power', None, float, True),
            Field('decoupled_decay', False, bool),
            Field('fixed_decay', False, bool),
            Field('rectify', False, bool),
            Field('degenerated_to_sgd', False, bool),
            Field('k', None, int, True),
            Field('xi', None, float, True),
            Field('n_sma_threshold', None, int, True),
            Field('ams_bound', False, bool),
            Field('adanorm', False, bool),
            Field('adam_debias', False, bool),
            Field('slice_p', None, int, True),
            Field('cautious', False, bool),
            # prodigy plus schedule free
            Field('weight_decay_by_lr', True, bool),
            Field('prodigy_steps', None, int, True),
            Field('use_speed', False, bool),
            Field('split_groups', True, bool),
            Field('split_groups_mean', True, bool),
            Field('factored', True, bool),
            Field('factored_fp32', True, bool),
            Field('use_stableadamw', True, bool),
            Field('use_muon_pp', False, bool),
            Field('use_cautious', False, bool),
            Field('use_grams', False, bool),
            Field('use_adopt', False, bool),
            Field('use_focus', False, bool),
        ])


class TrainModelPartConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('model_name', '', str),
            Field('include', True, bool),
            Field('train', True, bool),
            Field('stop_training_after', None, int, True),
            Field('stop_training_after_unit', TimeUnit.NEVER, TimeUnit),
            Field('learning_rate', None, float, True),
            Field('weight_dtype', DataType.NONE, DataType),
            Field('dropout_probability', 0.0, float),
            Field('train_embedding', True, bool),
            Field('attention_mask', False, bool),
            Field('guidance_scale', 1.0, float),
        ])


class TrainEmbeddingConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('uuid', str(uuid_lib.uuid4()), str),
            Field('model_name', '', str),
            Field('placeholder', '<embedding>', str),
            Field('train', True, bool),
            Field('stop_training_after', None, int, True),
            Field('stop_training_after_unit', TimeUnit.NEVER, TimeUnit),
            Field('token_count', 1, int, True),
            Field('initial_embedding_text', '*', str),
            Field('is_output_embedding', False, bool),
        ])


def _migration_0(data: dict) -> dict:
    # optimizer_* flat keys -> optimizer sub-object + optimizer_defaults.
    # Version-less files that are already in modern shape (nested optimizer
    # or model-part dicts) skip the whole migration chain — most reference
    # presets omit __version but are current-schema.
    if isinstance(data.get('optimizer'), dict) or isinstance(data.get('unet'), dict):
        return {**data, '__version': TrainConfig.config_version}
    optimizer_settings = {}
    migrated = {}
    for key, value in data.items():
        if key == 'optimizer':
            optimizer_settings['optimizer'] = value
        elif key.startswith('optimizer') and not isinstance(value, dict):
            optimizer_settings[key.removeprefix('optimizer_')] = value
        else:
            migrated[key] = value
    if 'optimizer' in optimizer_settings:
        migrated['optimizer'] = optimizer_settings
        migrated['optimizer_defaults'] = {
            optimizer_settings['optimizer']: deepcopy(optimizer_settings)
        }
    return migrated


_MIGRATION_1_PART_KEYS = {
    'train_unet': ('unet', 'train'),
    'train_unet_epochs': ('unet', 'stop_training_after'),
    'unet_learning_rate': ('unet', 'learning_rate'),
    'unet_weight_dtype': ('unet', 'weight_dtype'),
    'train_prior': ('prior', 'train'),
    'prior_model_name': ('prior', 'model_name'),
    'train_prior_epochs': ('prior', 'stop_training_after'),
    'prior_learning_rate': ('prior', 'learning_rate'),
    'prior_weight_dtype': ('prior', 'weight_dtype'),
    'train_text_encoder': ('text_encoder', 'train'),
    'train_text_encoder_epochs': ('text_encoder', 'stop_training_after'),
    'text_encoder_learning_rate': ('text_encoder', 'learning_rate'),
    'text_encoder_weight_dtype': ('text_encoder', 'weight_dtype'),
    'train_text_encoder_2': ('text_encoder_2', 'train'),
    'train_text_encoder_2_epochs': ('text_encoder_2', 'stop_training_after'),
    'text_encoder_2_learning_rate': ('text_encoder_2', 'learning_rate'),
    'text_encoder_2_weight_dtype': ('text_encoder_2', 'weight_dtype'),
    'vae_model_name': ('vae', 'model_name'),
    'vae_weight_dtype': ('vae', 'weight_dtype'),
    'effnet_encoder_model_name': ('effnet_encoder', 'model_name'),
    'effnet_encoder_weight_dtype': ('effnet_encoder', 'weight_dtype'),
    'decoder_model_name': ('decoder', 'model_name'),
    'decoder_weight_dtype': ('decoder', 'weight_dtype'),
    'decoder_text_encoder_weight_dtype': ('decoder_text_encoder', 'weight_dtype'),
    'decoder_vqgan_weight_dtype': ('decoder_vqgan', 'weight_dtype'),
}


def _migration_1(data: dict) -> dict:
    # flat per-part keys -> nested TrainModelPartConfig dicts
    migrated: dict = {
        'unet': {}, 'prior': {}, 'text_encoder': {}, 'text_encoder_2': {},
        'vae': {}, 'effnet_encoder': {}, 'decoder': {},
        'decoder_text_encoder': {}, 'decoder_vqgan': {}, 'embeddings': [{}],
    }
    for key, value in data.items():
        if key in _MIGRATION_1_PART_KEYS:
            part, name = _MIGRATION_1_PART_KEYS[key]
            migrated[part][name] = value
            if key.endswith('_epochs'):
                migrated[part]['stop_training_after_unit'] = TimeUnit.EPOCH
        elif key == 'embedding_model_names' and len(value) > 0:
            migrated['embeddings'][0]['model_name'] = value[0]
        elif key == 'token_count':
            migrated['embeddings'][0]['token_count'] = value
        elif key == 'initial_embedding_text':
            migrated['embeddings'][0]['initial_embedding_text'] = value
        else:
            migrated[key] = value
    return migrated


def _migration_2(data: dict) -> dict:
    migrated = data.copy()
    min_snr_gamma = migrated.pop('min_snr_gamma', 0.0)
    model_type = ModelType(migrated.get('model_type', ModelType.STABLE_DIFFUSION_15))
    if min_snr_gamma:
        migrated['loss_weight_fn'] = LossWeight.MIN_SNR_GAMMA
        migrated['loss_weight_strength'] = min_snr_gamma
    elif model_type.is_wuerstchen():
        migrated['loss_weight_fn'] = LossWeight.P2
        migrated['loss_weight_strength'] = 1.0
    return migrated


def _migration_3(data: dict) -> dict:
    migrated = data.copy()
    noising_weight = migrated.pop('noising_weight', 0.0)
    noising_bias = migrated.pop('noising_bias', 0.5)
    if noising_weight != 0:
        migrated['timestep_distribution'] = TimestepDistribution.SIGMOID
        migrated['noising_weight'] = noising_weight
        migrated['noising_bias'] = noising_bias - 0.5
    else:
        migrated['timestep_distribution'] = TimestepDistribution.UNIFORM
        migrated['noising_weight'] = 0.0
        migrated['noising_bias'] = 0.0
    return migrated


def _migration_4(data: dict) -> dict:
    migrated = data.copy()
    gradient_checkpointing = migrated.pop('gradient_checkpointing', True)
    migrated['gradient_checkpointing'] = (
        GradientCheckpointingMethod.ON if gradient_checkpointing
        else GradientCheckpointingMethod.OFF
    )
    return migrated


def _migration_5(data: dict) -> dict:
    migrated = data.copy()
    if 'save_after' in migrated:
        migrated['save_every'] = migrated.pop('save_after')
    if 'save_after_unit' in migrated:
        migrated['save_every_unit'] = migrated.pop('save_after_unit')
    return migrated


class TrainConfig(BaseConfig):
    config_version = 6
    config_migrations = {
        0: _migration_0,
        1: _migration_1,
        2: _migration_2,
        3: _migration_3,
        4: _migration_4,
        5: _migration_5,
    }

    def __init__(self):
        unet = TrainModelPartConfig.default_values()
        unet.learning_rate = None

        prior = TrainModelPartConfig.default_values()
        prior.model_name = ''

        text_encoder = TrainModelPartConfig.default_values()
        text_encoder_2 = TrainModelPartConfig.default_values()
        text_encoder_3 = TrainModelPartConfig.default_values()
        text_encoder_4 = TrainModelPartConfig.default_values()

        vae = TrainModelPartConfig.default_values()
        vae.train = False

        effnet_encoder = TrainModelPartConfig.default_values()
        effnet_encoder.train = False
        decoder = TrainModelPartConfig.default_values()
        decoder.train = False
        decoder_text_encoder = TrainModelPartConfig.default_values()
        decoder_text_encoder.train = False
        decoder_vqgan = TrainModelPartConfig.default_values()
        decoder_vqgan.train = False

        super().__init__([
            Field('training_method', TrainingMethod.FINE_TUNE, TrainingMethod),
            Field('model_type', ModelType.STABLE_DIFFUSION_15, ModelType),
            Field('debug_mode', False, bool),
            Field('debug_dir', 'debug', str),
            Field('workspace_dir', 'workspace/run', str),
            Field('cache_dir', 'workspace-cache/run', str),
            Field('tensorboard', True, bool),
            Field('tensorboard_expose', False, bool),
            Field('tensorboard_port', 6006, int),
            Field('validation', False, bool),
            Field('validate_after', 1, int),
            Field('validate_after_unit', TimeUnit.EPOCH, TimeUnit),
            Field('continue_last_backup', False, bool),
            Field('include_train_config', ConfigPart.NONE, ConfigPart),
            # model
            Field('base_model_name', 'stable-diffusion-v1-5/stable-diffusion-v1-5', str),
            Field('weight_dtype', DataType.FLOAT_32, DataType),
            Field('output_dtype', DataType.FLOAT_32, DataType),
            Field('output_model_format', ModelFormat.SAFETENSORS, ModelFormat),
            Field('output_model_destination', 'models/model.safetensors', str),
            Field('gradient_checkpointing', GradientCheckpointingMethod.ON, GradientCheckpointingMethod),
            Field('enable_async_offloading', True, bool),
            Field('enable_activation_offloading', True, bool),
            Field('layer_offload_fraction', 0.0, float),
            Field('force_circular_padding', False, bool),
            # data
            Field('concept_file_name', 'training_concepts/concepts.json', str),
            Field('concepts', None, list[ConceptConfig], True),
            Field('aspect_ratio_bucketing', True, bool),
            Field('latent_caching', True, bool),
            Field('clear_cache_before_training', True, bool),
            # training
            Field('learning_rate_scheduler', LearningRateScheduler.CONSTANT, LearningRateScheduler),
            Field('custom_learning_rate_scheduler', None, str, True),
            Field('scheduler_params', [], list[dict[str, str]], True),
            Field('learning_rate', 3e-6, float),
            Field('learning_rate_warmup_steps', 200.0, float),
            Field('learning_rate_cycles', 1.0, float),
            Field('learning_rate_min_factor', 0.0, float),
            Field('epochs', 100, int),
            Field('batch_size', 1, int),
            Field('gradient_accumulation_steps', 1, int),
            Field('ema', EMAMode.OFF, EMAMode),
            Field('ema_decay', 0.999, float),
            Field('ema_update_step_interval', 5, int),
            Field('dataloader_threads', 2, int),
            Field('train_device', 'tpu', str),
            Field('temp_device', 'cpu', str),
            Field('train_dtype', DataType.FLOAT_16, DataType),
            Field('fallback_train_dtype', DataType.BFLOAT_16, DataType),
            Field('enable_autocast_cache', True, bool),
            Field('only_cache', False, bool),
            Field('resolution', '512', str),
            Field('frames', '25', str),
            Field('mse_strength', 1.0, float),
            Field('mae_strength', 0.0, float),
            Field('log_cosh_strength', 0.0, float),
            Field('vb_loss_strength', 1.0, float),
            Field('loss_weight_fn', LossWeight.CONSTANT, LossWeight),
            Field('loss_weight_strength', 5.0, float),
            Field('dropout_probability', 0.0, float),
            Field('loss_scaler', LossScaler.NONE, LossScaler),
            Field('learning_rate_scaler', LearningRateScaler.NONE, LearningRateScaler),
            Field('clip_grad_norm', 1.0, float, True),
            # noise
            Field('offset_noise_weight', 0.0, float),
            Field('perturbation_noise_weight', 0.0, float),
            Field('rescale_noise_scheduler_to_zero_terminal_snr', False, bool),
            Field('force_v_prediction', False, bool),
            Field('force_epsilon_prediction', False, bool),
            Field('min_noising_strength', 0.0, float),
            Field('max_noising_strength', 1.0, float),
            Field('timestep_distribution', TimestepDistribution.UNIFORM, TimestepDistribution),
            Field('noising_weight', 0.0, float),
            Field('noising_bias', 0.0, float),
            Field('timestep_shift', 1.0, float),
            Field('dynamic_timestep_shifting', False, bool),
            # model parts
            Field('unet', unet, TrainModelPartConfig),
            Field('prior', prior, TrainModelPartConfig),
            Field('text_encoder', text_encoder, TrainModelPartConfig),
            Field('text_encoder_layer_skip', 0, int),
            Field('text_encoder_2', text_encoder_2, TrainModelPartConfig),
            Field('text_encoder_2_layer_skip', 0, int),
            Field('text_encoder_3', text_encoder_3, TrainModelPartConfig),
            Field('text_encoder_3_layer_skip', 0, int),
            Field('text_encoder_4', text_encoder_4, TrainModelPartConfig),
            Field('text_encoder_4_layer_skip', 0, int),
            Field('vae', vae, TrainModelPartConfig),
            Field('effnet_encoder', effnet_encoder, TrainModelPartConfig),
            Field('decoder', decoder, TrainModelPartConfig),
            Field('decoder_text_encoder', decoder_text_encoder, TrainModelPartConfig),
            Field('decoder_vqgan', decoder_vqgan, TrainModelPartConfig),
            # masked training
            Field('masked_training', False, bool),
            Field('unmasked_probability', 0.1, float),
            Field('unmasked_weight', 0.1, float),
            Field('normalize_masked_area_loss', False, bool),
            Field('masked_prior_preservation_weight', 0.0, float),
            Field('custom_conditioning_image', False, bool),
            # embeddings
            Field('embedding_learning_rate', None, float, True),
            Field('preserve_embedding_norm', False, bool),
            Field('embedding', TrainEmbeddingConfig.default_values(), TrainEmbeddingConfig),
            Field('additional_embeddings', [], list[TrainEmbeddingConfig]),
            Field('embedding_weight_dtype', DataType.FLOAT_32, DataType),
            # cloud
            Field('cloud', CloudConfig.default_values(), CloudConfig),
            # peft
            Field('peft_type', PeftType.LORA, PeftType),
            Field('lora_model_name', '', str),
            Field('lora_rank', 16, int),
            Field('lora_alpha', 1.0, float),
            Field('lora_decompose', False, bool),
            Field('lora_decompose_norm_epsilon', True, bool),
            Field('lora_decompose_output_axis', False, bool),
            Field('lora_weight_dtype', DataType.FLOAT_32, DataType),
            Field('lora_layers', '', str),
            Field('lora_layer_preset', None, str, True),
            Field('bundle_additional_embeddings', True, bool),
            # optimizer
            Field('optimizer', TrainOptimizerConfig.default_values(), TrainOptimizerConfig),
            Field('optimizer_defaults', {}, dict[str, TrainOptimizerConfig]),
            # sampling
            Field('sample_definition_file_name', 'training_samples/samples.json', str),
            Field('samples', None, list[SampleConfig], True),
            Field('sample_after', 10, int),
            Field('sample_after_unit', TimeUnit.MINUTE, TimeUnit),
            Field('sample_skip_first', 0, int),
            Field('sample_image_format', ImageFormat.JPG, ImageFormat),
            Field('sample_video_format', VideoFormat.MP4, VideoFormat),
            Field('sample_audio_format', AudioFormat.MP3, AudioFormat),
            Field('samples_to_tensorboard', True, bool),
            Field('non_ema_sampling', True, bool),
            # backup
            Field('backup_after', 30, int),
            Field('backup_after_unit', TimeUnit.MINUTE, TimeUnit),
            Field('rolling_backup', False, bool),
            Field('rolling_backup_count', 3, int),
            Field('backup_before_save', True, bool),
            Field('save_every', 0, int),
            Field('save_every_unit', TimeUnit.NEVER, TimeUnit),
            Field('save_skip_first', 0, int),
            Field('save_filename_prefix', '', str),
            # secrets
            Field('secrets', SecretsConfig.default_values(), SecretsConfig),
        ])

    # -- derived views ------------------------------------------------------

    def weight_dtypes(self) -> ModelWeightDtypes:
        def part(dt: DataType) -> DataType:
            return self.weight_dtype if dt == DataType.NONE else dt

        return ModelWeightDtypes(
            self.train_dtype,
            self.fallback_train_dtype,
            part(self.unet.weight_dtype),
            part(self.prior.weight_dtype),
            part(self.text_encoder.weight_dtype),
            part(self.text_encoder_2.weight_dtype),
            part(self.text_encoder_3.weight_dtype),
            part(self.text_encoder_4.weight_dtype),
            part(self.vae.weight_dtype),
            part(self.effnet_encoder.weight_dtype),
            part(self.decoder.weight_dtype),
            part(self.decoder_text_encoder.weight_dtype),
            part(self.decoder_vqgan.weight_dtype),
            part(self.lora_weight_dtype),
            part(self.embedding_weight_dtype),
        )

    def model_names(self) -> ModelNames:
        return ModelNames(
            base_model=self.base_model_name,
            prior_model=self.prior.model_name,
            effnet_encoder_model=self.effnet_encoder.model_name,
            decoder_model=self.decoder.model_name,
            text_encoder_4=self.text_encoder_4.model_name,
            vae_model=self.vae.model_name,
            lora=self.lora_model_name,
            embedding=EmbeddingName(self.embedding.uuid, self.embedding.model_name)
            if self.training_method == TrainingMethod.EMBEDDING else None,
            additional_embeddings=[
                EmbeddingName(e.uuid, e.model_name) for e in self.additional_embeddings
            ],
            include_text_encoder=self.text_encoder.include,
            include_text_encoder_2=self.text_encoder_2.include,
            include_text_encoder_3=self.text_encoder_3.include,
            include_text_encoder_4=self.text_encoder_4.include,
        )

    def train_any_embedding(self) -> bool:
        return (
            (self.training_method == TrainingMethod.EMBEDDING and not self.embedding.is_output_embedding)
            or any(e.train and not e.is_output_embedding for e in self.additional_embeddings)
        )

    def train_any_output_embedding(self) -> bool:
        return (
            (self.training_method == TrainingMethod.EMBEDDING and self.embedding.is_output_embedding)
            or any(e.train and e.is_output_embedding for e in self.additional_embeddings)
        )

    def _train_te_or_embedding(self, te: TrainModelPartConfig) -> bool:
        return (
            (te.train and self.training_method != TrainingMethod.EMBEDDING
             and not self.embedding.is_output_embedding)
            or ((te.train_embedding or not self.model_type.has_multiple_text_encoders())
                and self.train_any_embedding())
        )

    def train_text_encoder_or_embedding(self) -> bool:
        return self._train_te_or_embedding(self.text_encoder)

    def train_text_encoder_2_or_embedding(self) -> bool:
        return self._train_te_or_embedding(self.text_encoder_2)

    def train_text_encoder_3_or_embedding(self) -> bool:
        return self._train_te_or_embedding(self.text_encoder_3)

    def train_text_encoder_4_or_embedding(self) -> bool:
        return self._train_te_or_embedding(self.text_encoder_4)

    def all_embedding_configs(self) -> list[TrainEmbeddingConfig]:
        if self.training_method == TrainingMethod.EMBEDDING:
            return self.additional_embeddings + [self.embedding]
        return list(self.additional_embeddings)

    def get_last_backup_path(self) -> str | None:
        backups_path = os.path.join(self.workspace_dir, 'backup')
        if os.path.exists(backups_path):
            backup_paths = sorted(
                (p for p in os.listdir(backups_path)
                 if os.path.isdir(os.path.join(backups_path, p))),
                reverse=True,
            )
            for p in backup_paths:
                return os.path.join(backups_path, p)
        return None

    # -- packed / settings forms ---------------------------------------------

    def to_settings_dict(self, secrets: bool) -> dict:
        config = TrainConfig.default_values().from_dict(self.to_dict())
        config.concepts = None
        config.samples = None
        config_dict = config.to_dict()
        if not secrets:
            config_dict.pop('secrets', None)
        return config_dict

    def to_pack_dict(self, secrets: bool) -> dict:
        config = TrainConfig.default_values().from_dict(self.to_dict())
        if config.concepts is None:
            with open(config.concept_file_name) as f:
                config.concepts = [
                    ConceptConfig.default_values().from_dict(c) for c in json.load(f)
                ]
        if config.samples is None:
            with open(config.sample_definition_file_name) as f:
                config.samples = [
                    SampleConfig.default_values().from_dict(s) for s in json.load(f)
                ]
        config_dict = config.to_dict()
        if not secrets:
            config_dict.pop('secrets', None)
        return config_dict

    def to_unpacked_config(self) -> "TrainConfig":
        config = TrainConfig.default_values().from_dict(self.to_dict())
        config.concepts = None
        config.samples = None
        return config
