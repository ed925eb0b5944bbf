"""Model name / weight-dtype aggregates (reference: modules/util/ModelNames.py,
modules/util/ModelWeightDtypes.py); the port's copy of
onetrainer_tpu/util/model_names.py."""

from dataclasses import dataclass, field

from onetrainer_tpu_torch.util.enums import DataType


@dataclass
class EmbeddingName:
    uuid: str
    model_name: str


@dataclass
class ModelNames:
    base_model: str = ""
    prior_model: str = ""
    effnet_encoder_model: str = ""
    decoder_model: str = ""
    text_encoder_4: str = ""
    vae_model: str = ""
    lora: str = ""
    embedding: EmbeddingName | None = None
    additional_embeddings: list[EmbeddingName] = field(default_factory=list)
    include_text_encoder: bool = True
    include_text_encoder_2: bool = True
    include_text_encoder_3: bool = True
    include_text_encoder_4: bool = True

    def all_embedding(self) -> list[EmbeddingName]:
        return self.additional_embeddings + ([self.embedding] if self.embedding is not None else [])


@dataclass
class ModelWeightDtypes:
    train_dtype: DataType
    fallback_train_dtype: DataType
    unet: DataType
    prior: DataType
    text_encoder: DataType
    text_encoder_2: DataType
    text_encoder_3: DataType
    text_encoder_4: DataType
    vae: DataType
    effnet_encoder: DataType
    decoder: DataType
    decoder_text_encoder: DataType
    decoder_vqgan: DataType
    lora: DataType
    embedding: DataType

    def all_dtypes(self) -> list[DataType]:
        return [
            self.unet, self.prior, self.text_encoder, self.text_encoder_2,
            self.text_encoder_3, self.text_encoder_4, self.vae,
            self.effnet_encoder, self.decoder, self.decoder_text_encoder,
            self.decoder_vqgan, self.lora, self.embedding,
        ]

    @staticmethod
    def from_single_dtype(dtype: DataType) -> "ModelWeightDtypes":
        return ModelWeightDtypes(*([dtype] * 15))
