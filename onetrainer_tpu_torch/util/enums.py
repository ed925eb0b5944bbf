"""The reference's enums (framework-free, reused as is) plus the torch
dtype map that `DataType.to_jnp_dtype` gives the JAX package."""

import torch

from onetrainer_tpu.util.enums import (
    DataType, ModelType, NoiseScheduler, TrainingMethod,
)

__all__ = ["DataType", "ModelType", "NoiseScheduler", "TrainingMethod",
           "to_torch_dtype"]

_TORCH_DTYPES = {
    DataType.NONE: None,
    DataType.FLOAT_8: torch.float8_e4m3fn,
    DataType.FLOAT_16: torch.float16,
    DataType.FLOAT_32: torch.float32,
    DataType.BFLOAT_16: torch.bfloat16,
    DataType.TFLOAT_32: torch.float32,   # a matmul mode, stored as fp32
    DataType.INT_8: torch.int8,
    DataType.NFLOAT_4: torch.uint8,      # packed storage
}


def to_torch_dtype(data_type: DataType) -> torch.dtype | None:
    """Storage dtype of `data_type` (quantized types: their storage)."""
    return _TORCH_DTYPES[data_type]
