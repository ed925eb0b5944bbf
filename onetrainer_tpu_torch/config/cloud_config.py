"""Cloud / secrets config (reference: modules/util/config/CloudConfig.py,
SecretsConfig.py). Field names form the JSON contract. The port's copy of
onetrainer_tpu/config/cloud_config.py."""

from onetrainer_tpu_torch.config.base_config import BaseConfig, Field
from onetrainer_tpu_torch.util.enums import CloudAction, CloudFileSync, CloudType


class CloudSecretsConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('api_key', '', str),
            Field('id', '', str),
            Field('host', '', str),
            # reference declares (port, 0, str) — int default for a str field;
            # we normalize the default to '0' so to_dict/from_dict is stable
            Field('port', '0', str),
            Field('user', 'root', str),
        ])


class CloudConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('enabled', False, bool),
            Field('type', CloudType.RUNPOD, CloudType),
            Field('file_sync', CloudFileSync.NATIVE_SCP, CloudFileSync),
            Field('create', True, bool),
            Field('name', 'OneTrainer', str),
            Field('tensorboard_tunnel', True, bool),
            Field('sub_type', '', str),
            Field('gpu_type', '', str),
            Field('volume_size', 100, int),
            Field('min_download', 0, int),
            Field('remote_dir', '/workspace', str),
            Field('huggingface_cache_dir', '/workspace/huggingface_cache', str),
            Field('onetrainer_dir', '/workspace/OneTrainer', str),
            Field('install_cmd', 'git clone https://github.com/Nerogar/OneTrainer', str),
            Field('install_onetrainer', True, bool),
            Field('update_onetrainer', True, bool),
            Field('detach_trainer', False, bool),
            Field('run_id', 'job1', str),
            Field('download_samples', True, bool),
            Field('download_output_model', True, bool),
            Field('download_saves', True, bool),
            Field('download_backups', False, bool),
            Field('download_tensorboard', False, bool),
            Field('delete_workspace', False, bool),
            Field('on_finish', CloudAction.NONE, CloudAction),
            Field('on_error', CloudAction.NONE, CloudAction),
            Field('on_detached_finish', CloudAction.NONE, CloudAction),
            Field('on_detached_error', CloudAction.NONE, CloudAction),
        ])


class SecretsConfig(BaseConfig):
    def __init__(self):
        super().__init__([
            Field('huggingface_token', '', str),
            Field('cloud', CloudSecretsConfig.default_values(), CloudSecretsConfig),
        ])
