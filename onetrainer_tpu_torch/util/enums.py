"""All framework enums: the port's own copy of onetrainer_tpu/util/enums.py.

Member names and values are the reference's (the JSON-config contract
shared with OneTrainer, reference: modules/util/enum/*.py), so configs
load unchanged on both sides. DataType maps onto torch dtypes here
(`to_torch_dtype`) where the JAX package maps onto JAX dtypes.
"""

from enum import Enum

import torch


class _StrEnum(Enum):
    def __str__(self) -> str:
        return self.value

    @classmethod
    def _missing_(cls, value):
        # the reference serializes a few members in mixed case (e.g.
        # Optimizer.AdEMAMix = 'AdEMAMix', reference
        # modules/util/enum/Optimizer.py:21-22) — accept any casing so
        # its configs load unchanged (tests/test_reference_goldens_
        # optimizer_defaults.py::test_every_reference_enum_value_parses)
        if isinstance(value, str):
            upper = value.upper()
            for member in cls:
                if member.value.upper() == upper:
                    return member
        return None


class ModelType(_StrEnum):
    STABLE_DIFFUSION_15 = 'STABLE_DIFFUSION_15'
    STABLE_DIFFUSION_15_INPAINTING = 'STABLE_DIFFUSION_15_INPAINTING'
    STABLE_DIFFUSION_20 = 'STABLE_DIFFUSION_20'
    STABLE_DIFFUSION_20_BASE = 'STABLE_DIFFUSION_20_BASE'
    STABLE_DIFFUSION_20_INPAINTING = 'STABLE_DIFFUSION_20_INPAINTING'
    STABLE_DIFFUSION_20_DEPTH = 'STABLE_DIFFUSION_20_DEPTH'
    STABLE_DIFFUSION_21 = 'STABLE_DIFFUSION_21'
    STABLE_DIFFUSION_21_BASE = 'STABLE_DIFFUSION_21_BASE'
    STABLE_DIFFUSION_3 = 'STABLE_DIFFUSION_3'
    STABLE_DIFFUSION_35 = 'STABLE_DIFFUSION_35'
    STABLE_DIFFUSION_XL_10_BASE = 'STABLE_DIFFUSION_XL_10_BASE'
    STABLE_DIFFUSION_XL_10_BASE_INPAINTING = 'STABLE_DIFFUSION_XL_10_BASE_INPAINTING'
    WUERSTCHEN_2 = 'WUERSTCHEN_2'
    STABLE_CASCADE_1 = 'STABLE_CASCADE_1'
    PIXART_ALPHA = 'PIXART_ALPHA'
    PIXART_SIGMA = 'PIXART_SIGMA'
    FLUX_DEV_1 = 'FLUX_DEV_1'
    FLUX_FILL_DEV_1 = 'FLUX_FILL_DEV_1'
    SANA = 'SANA'
    HUNYUAN_VIDEO = 'HUNYUAN_VIDEO'
    HI_DREAM_FULL = 'HI_DREAM_FULL'
    LORA = 'LORA'
    LOHA = 'LOHA'

    def is_stable_diffusion(self) -> bool:
        return self in (
            ModelType.STABLE_DIFFUSION_15,
            ModelType.STABLE_DIFFUSION_15_INPAINTING,
            ModelType.STABLE_DIFFUSION_20,
            ModelType.STABLE_DIFFUSION_20_BASE,
            ModelType.STABLE_DIFFUSION_20_INPAINTING,
            ModelType.STABLE_DIFFUSION_20_DEPTH,
            ModelType.STABLE_DIFFUSION_21,
            ModelType.STABLE_DIFFUSION_21_BASE,
        )

    def is_stable_diffusion_xl(self) -> bool:
        return self in (
            ModelType.STABLE_DIFFUSION_XL_10_BASE,
            ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING,
        )

    def is_stable_diffusion_3(self) -> bool:
        return self in (ModelType.STABLE_DIFFUSION_3, ModelType.STABLE_DIFFUSION_35)

    def is_stable_diffusion_3_5(self) -> bool:
        return self == ModelType.STABLE_DIFFUSION_35

    def is_wuerstchen(self) -> bool:
        return self in (ModelType.WUERSTCHEN_2, ModelType.STABLE_CASCADE_1)

    def is_wuerstchen_v2(self) -> bool:
        return self == ModelType.WUERSTCHEN_2

    def is_stable_cascade(self) -> bool:
        return self == ModelType.STABLE_CASCADE_1

    def is_pixart(self) -> bool:
        return self in (ModelType.PIXART_ALPHA, ModelType.PIXART_SIGMA)

    def is_pixart_alpha(self) -> bool:
        return self == ModelType.PIXART_ALPHA

    def is_pixart_sigma(self) -> bool:
        return self == ModelType.PIXART_SIGMA

    def is_flux(self) -> bool:
        return self in (ModelType.FLUX_DEV_1, ModelType.FLUX_FILL_DEV_1)

    def is_sana(self) -> bool:
        return self == ModelType.SANA

    def is_hunyuan_video(self) -> bool:
        return self == ModelType.HUNYUAN_VIDEO

    def is_hi_dream(self) -> bool:
        return self == ModelType.HI_DREAM_FULL

    def has_mask_input(self) -> bool:
        return self in (
            ModelType.STABLE_DIFFUSION_15_INPAINTING,
            ModelType.STABLE_DIFFUSION_20_INPAINTING,
            ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING,
            ModelType.FLUX_FILL_DEV_1,
        )

    def has_conditioning_image_input(self) -> bool:
        return self in (
            ModelType.STABLE_DIFFUSION_15_INPAINTING,
            ModelType.STABLE_DIFFUSION_20_INPAINTING,
            ModelType.STABLE_DIFFUSION_XL_10_BASE_INPAINTING,
            ModelType.FLUX_FILL_DEV_1,
        )

    def has_depth_input(self) -> bool:
        return self == ModelType.STABLE_DIFFUSION_20_DEPTH

    def has_multiple_text_encoders(self) -> bool:
        return (
            self.is_stable_diffusion_3()
            or self.is_stable_diffusion_xl()
            or self.is_flux()
            or self.is_hunyuan_video()
            or self.is_hi_dream()
        )

    def is_sd_v1(self) -> bool:
        return self in (
            ModelType.STABLE_DIFFUSION_15,
            ModelType.STABLE_DIFFUSION_15_INPAINTING,
        )

    def is_sd_v2(self) -> bool:
        return self in (
            ModelType.STABLE_DIFFUSION_20,
            ModelType.STABLE_DIFFUSION_20_BASE,
            ModelType.STABLE_DIFFUSION_20_INPAINTING,
            ModelType.STABLE_DIFFUSION_20_DEPTH,
            ModelType.STABLE_DIFFUSION_21,
            ModelType.STABLE_DIFFUSION_21_BASE,
        )


class PeftType(_StrEnum):
    LORA = 'LORA'
    LOHA = 'LOHA'


class TrainingMethod(_StrEnum):
    FINE_TUNE = 'FINE_TUNE'
    LORA = 'LORA'
    EMBEDDING = 'EMBEDDING'
    FINE_TUNE_VAE = 'FINE_TUNE_VAE'


class ModelFormat(_StrEnum):
    DIFFUSERS = 'DIFFUSERS'
    CKPT = 'CKPT'
    SAFETENSORS = 'SAFETENSORS'
    LEGACY_SAFETENSORS = 'LEGACY_SAFETENSORS'
    INTERNAL = 'INTERNAL'

    def file_extension(self) -> str:
        if self == ModelFormat.CKPT:
            return '.ckpt'
        if self in (ModelFormat.SAFETENSORS, ModelFormat.LEGACY_SAFETENSORS):
            return '.safetensors'
        return ''

    def is_single_file(self) -> bool:
        return self in (ModelFormat.CKPT, ModelFormat.SAFETENSORS, ModelFormat.LEGACY_SAFETENSORS)


class DataType(_StrEnum):
    NONE = 'NONE'
    FLOAT_8 = 'FLOAT_8'
    FLOAT_16 = 'FLOAT_16'
    FLOAT_32 = 'FLOAT_32'
    BFLOAT_16 = 'BFLOAT_16'
    TFLOAT_32 = 'TFLOAT_32'
    INT_8 = 'INT_8'
    NFLOAT_4 = 'NFLOAT_4'

    def to_torch_dtype(self) -> torch.dtype | None:
        """Map to a torch dtype. Quantized types return their storage
        dtype; TF32 (a CUDA matmul mode, not a storage dtype) maps to
        float32."""
        return {
            DataType.NONE: None,
            DataType.FLOAT_8: torch.float8_e4m3fn,
            DataType.FLOAT_16: torch.float16,
            DataType.FLOAT_32: torch.float32,
            DataType.BFLOAT_16: torch.bfloat16,
            DataType.TFLOAT_32: torch.float32,
            DataType.INT_8: torch.int8,
            DataType.NFLOAT_4: torch.uint8,
        }[self]

    def to_save_dtype(self) -> torch.dtype | None:
        """Save-time cast of every exported float tensor (the reference's
        `output_dtype`); NONE keeps each tensor's own dtype, the quantized
        types save at fp32 as the reference's."""
        return {
            DataType.NONE: None,
            DataType.FLOAT_8: torch.float8_e4m3fn,
            DataType.FLOAT_16: torch.float16,
            DataType.FLOAT_32: torch.float32,
            DataType.BFLOAT_16: torch.bfloat16,
            DataType.TFLOAT_32: torch.float32,
        }.get(self, torch.float32)

    def to_compute_dtype(self) -> torch.dtype | None:
        """Compute dtype of a `train_dtype`: fp16 maps to bf16, as the
        reference's policy."""
        dt = self.to_torch_dtype()
        return torch.bfloat16 if dt == torch.float16 else dt

    def is_quantized(self) -> bool:
        return self in (DataType.FLOAT_8, DataType.INT_8, DataType.NFLOAT_4)

    def to_load_dtype(self) -> torch.dtype | None:
        """Load-cast dtype of a part. Quantized types load at bf16 and are
        quantized by the setup afterwards (setup/quantize.py): casting raw
        weights to the storage dtype would truncate them (no absmax
        scale). fp16 maps to bf16, as the reference's compute dtype does."""
        if self.is_quantized():
            return torch.bfloat16
        dt = self.to_torch_dtype()
        return torch.bfloat16 if dt == torch.float16 else dt

    def enable_loss_scaling(self) -> bool:
        # fp16 needs loss scaling; bf16/fp32 never do. On TPU the default
        # train dtype is bf16 so this is normally False.
        return self == DataType.FLOAT_16


class EMAMode(_StrEnum):
    OFF = 'OFF'
    GPU = 'GPU'   # kept for config compat: EMA params stay on device (HBM)
    CPU = 'CPU'   # EMA params held on host memory


class GradientCheckpointingMethod(_StrEnum):
    OFF = 'OFF'
    ON = 'ON'
    CPU_OFFLOADED = 'CPU_OFFLOADED'

    def enabled(self) -> bool:
        return self != GradientCheckpointingMethod.OFF

    def offload(self) -> bool:
        return self == GradientCheckpointingMethod.CPU_OFFLOADED


class LearningRateScheduler(_StrEnum):
    CONSTANT = 'CONSTANT'
    LINEAR = 'LINEAR'
    COSINE = 'COSINE'
    COSINE_WITH_RESTARTS = 'COSINE_WITH_RESTARTS'
    COSINE_WITH_HARD_RESTARTS = 'COSINE_WITH_HARD_RESTARTS'
    REX = 'REX'
    ADAFACTOR = 'ADAFACTOR'
    CUSTOM = 'CUSTOM'


class LearningRateScaler(_StrEnum):
    NONE = 'NONE'
    BATCH = 'BATCH'
    GRADIENT_ACCUMULATION = 'GRADIENT_ACCUMULATION'
    BOTH = 'BOTH'


class LossScaler(_StrEnum):
    NONE = 'NONE'
    BATCH = 'BATCH'
    GRADIENT_ACCUMULATION = 'GRADIENT_ACCUMULATION'
    BOTH = 'BOTH'


class LossWeight(_StrEnum):
    CONSTANT = 'CONSTANT'
    P2 = 'P2'
    MIN_SNR_GAMMA = 'MIN_SNR_GAMMA'
    DEBIASED_ESTIMATION = 'DEBIASED_ESTIMATION'
    SIGMA = 'SIGMA'


class TimestepDistribution(_StrEnum):
    UNIFORM = 'UNIFORM'
    SIGMOID = 'SIGMOID'
    LOGIT_NORMAL = 'LOGIT_NORMAL'
    HEAVY_TAIL = 'HEAVY_TAIL'
    COS_MAP = 'COS_MAP'

    def is_continuous(self) -> bool:
        return self in (
            TimestepDistribution.UNIFORM,
            TimestepDistribution.LOGIT_NORMAL,
            TimestepDistribution.HEAVY_TAIL,
        )


class NoiseScheduler(_StrEnum):
    DDIM = 'DDIM'
    EULER = 'EULER'
    EULER_A = 'EULER_A'
    DPMPP = 'DPMPP'
    DPMPP_SDE = 'DPMPP_SDE'
    UNIPC = 'UNIPC'
    EULER_KARRAS = 'EULER_KARRAS'
    DPMPP_KARRAS = 'DPMPP_KARRAS'
    DPMPP_SDE_KARRAS = 'DPMPP_SDE_KARRAS'
    UNIPC_KARRAS = 'UNIPC_KARRAS'

    def is_karras(self) -> bool:
        return self in (
            NoiseScheduler.EULER_KARRAS,
            NoiseScheduler.DPMPP_KARRAS,
            NoiseScheduler.DPMPP_SDE_KARRAS,
            NoiseScheduler.UNIPC_KARRAS,
        )


class Optimizer(_StrEnum):
    ADAGRAD = 'ADAGRAD'
    ADAGRAD_8BIT = 'ADAGRAD_8BIT'
    ADAM = 'ADAM'
    ADAM_8BIT = 'ADAM_8BIT'
    ADAMW = 'ADAMW'
    ADAMW_8BIT = 'ADAMW_8BIT'
    ADEMAMIX = 'ADEMAMIX'
    ADEMAMIX_8BIT = 'ADEMAMIX_8BIT'
    ADOPT = 'ADOPT'
    LAMB = 'LAMB'
    LAMB_8BIT = 'LAMB_8BIT'
    LARS = 'LARS'
    LARS_8BIT = 'LARS_8BIT'
    LION = 'LION'
    LION_8BIT = 'LION_8BIT'
    RMSPROP = 'RMSPROP'
    RMSPROP_8BIT = 'RMSPROP_8BIT'
    SGD = 'SGD'
    SGD_8BIT = 'SGD_8BIT'
    SCHEDULE_FREE_ADAMW = 'SCHEDULE_FREE_ADAMW'
    SCHEDULE_FREE_SGD = 'SCHEDULE_FREE_SGD'
    DADAPT_ADA_GRAD = 'DADAPT_ADA_GRAD'
    DADAPT_ADAM = 'DADAPT_ADAM'
    DADAPT_ADAN = 'DADAPT_ADAN'
    DADAPT_LION = 'DADAPT_LION'
    DADAPT_SGD = 'DADAPT_SGD'
    PRODIGY = 'PRODIGY'
    PRODIGY_PLUS_SCHEDULE_FREE = 'PRODIGY_PLUS_SCHEDULE_FREE'
    ADAFACTOR = 'ADAFACTOR'
    CAME = 'CAME'
    ADABELIEF = 'ADABELIEF'
    TIGER = 'TIGER'
    AIDA = 'AIDA'
    YOGI = 'YOGI'

    def is_adaptive(self) -> bool:
        return self in (
            Optimizer.DADAPT_SGD,
            Optimizer.DADAPT_ADAM,
            Optimizer.DADAPT_ADAN,
            Optimizer.DADAPT_ADA_GRAD,
            Optimizer.DADAPT_LION,
            Optimizer.PRODIGY,
            Optimizer.PRODIGY_PLUS_SCHEDULE_FREE,
        )

    def is_schedule_free(self) -> bool:
        return self in (
            Optimizer.SCHEDULE_FREE_ADAMW,
            Optimizer.SCHEDULE_FREE_SGD,
            Optimizer.PRODIGY_PLUS_SCHEDULE_FREE,
        )

    def supports_fused_back_pass(self) -> bool:
        # On TPU/XLA the optimizer update is fused into the jitted train step
        # already; this flag is accepted for config compat and is a no-op
        # (reference: modules/util/enum/Optimizer.py supports_fused_back_pass).
        return self in (
            Optimizer.ADAFACTOR,
            Optimizer.CAME,
            Optimizer.ADAM,
            Optimizer.ADAMW,
            Optimizer.PRODIGY_PLUS_SCHEDULE_FREE,
        )


class TimeUnit(_StrEnum):
    EPOCH = 'EPOCH'
    STEP = 'STEP'
    SECOND = 'SECOND'
    MINUTE = 'MINUTE'
    HOUR = 'HOUR'
    NEVER = 'NEVER'
    ALWAYS = 'ALWAYS'

    def is_time_unit(self) -> bool:
        return self in (TimeUnit.SECOND, TimeUnit.MINUTE, TimeUnit.HOUR)


class BalancingStrategy(_StrEnum):
    REPEATS = 'REPEATS'
    SAMPLES = 'SAMPLES'


class ConceptType(_StrEnum):
    STANDARD = 'STANDARD'
    VALIDATION = 'VALIDATION'
    PRIOR_PREDICTION = 'PRIOR_PREDICTION'


class ConfigPart(_StrEnum):
    NONE = 'NONE'
    SETTINGS = 'SETTINGS'
    ALL = 'ALL'


class ImageFormat(_StrEnum):
    PNG = 'PNG'
    JPG = 'JPG'

    def extension(self) -> str:
        return {'PNG': '.png', 'JPG': '.jpg'}[self.value]

    def pil_format(self) -> str:
        return {'PNG': 'PNG', 'JPG': 'JPEG'}[self.value]


class VideoFormat(_StrEnum):
    PNG_IMAGE_SEQUENCE = 'PNG_IMAGE_SEQUENCE'
    JPG_IMAGE_SEQUENCE = 'JPG_IMAGE_SEQUENCE'
    MP4 = 'MP4'

    def extension(self) -> str:
        return {'PNG_IMAGE_SEQUENCE': '', 'JPG_IMAGE_SEQUENCE': '', 'MP4': '.mp4'}[self.value]


class AudioFormat(_StrEnum):
    MP3 = 'MP3'

    def extension(self) -> str:
        return '.mp3'


class FileType(_StrEnum):
    IMAGE = 'IMAGE'
    VIDEO = 'VIDEO'
    AUDIO = 'AUDIO'


class CloudType(_StrEnum):
    RUNPOD = 'RUNPOD'
    LINUX = 'LINUX'


class CloudAction(_StrEnum):
    NONE = 'NONE'
    STOP = 'STOP'
    DELETE = 'DELETE'


class CloudFileSync(_StrEnum):
    FABRIC_SFTP = 'FABRIC_SFTP'
    NATIVE_SCP = 'NATIVE_SCP'


class GenerateCaptionsModel(_StrEnum):
    BLIP = 'BLIP'
    BLIP2 = 'BLIP2'
    WD14_VIT_2 = 'WD14_VIT_2'


class GenerateMasksModel(_StrEnum):
    CLIPSEG = 'CLIPSEG'
    REMBG = 'REMBG'
    REMBG_HUMAN = 'REMBG_HUMAN'
    COLOR = 'COLOR'


def to_torch_dtype(data_type: DataType) -> torch.dtype | None:
    """Storage dtype of `data_type` (quantized types: their storage)."""
    return data_type.to_torch_dtype()
