"""Model and decode configuration of the port.

A copy of the serving-relevant part of ``handwritten_math_ocr_api_tpu/
core/config.py`` (the port imports nothing of the JAX package): the special
token ids, ``SwinConfig``, ``ResNetConfig``, ``ModelConfig``,
``DecodeConfig`` with the same fields and defaults, ``DataConfig``'s paths
and batch size, plus the loader for the
``model_config.json`` that a serving artifact (such as ``serving_model_r4/``)
carries.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

PAD_TOKEN = "<pad>"
SOS_TOKEN = "<sos>"
EOS_TOKEN = "<eos>"
UNK_TOKEN = "<unk>"
SPECIAL_TOKENS = (PAD_TOKEN, SOS_TOKEN, EOS_TOKEN, UNK_TOKEN)
PAD_ID, SOS_ID, EOS_ID, UNK_ID = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin-Tiny hyperparameters (torchvision swin_t topology)."""

    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    patch_size: int = 4
    in_channels: int = 1
    dropout: float = 0.0
    attn_dropout: float = 0.0
    stochastic_depth: float = 0.2

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ResNet-18 encoder hyperparameters (not ported yet; kept so that a
    ``model_config.json`` round-trips)."""

    in_channels: int = 1
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    stage_blocks: Tuple[int, ...] = (2, 2, 2, 2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full image->LaTeX model configuration (same fields as the JAX one)."""

    img_h: int = 96
    img_w: int = 320
    d_model: int = 256
    nhead: int = 8
    dim_feedforward: int = 512
    dropout: float = 0.2
    num_decoder_layers: int = 8
    max_seq_len: int = 150
    vocab_size: int = 544
    encoder: str = "swin_t"
    num_encoder_layers: int = 8
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    resnet: ResNetConfig = dataclasses.field(default_factory=ResNetConfig)
    dtype: str = "bfloat16"
    memory_norm: bool = False
    nhead_kv: "int | None" = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.nhead

    @property
    def kv_heads(self) -> int:
        return self.nhead_kv if self.nhead_kv is not None else self.nhead

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def encoder_len(self) -> int:
        """Number of encoder output tokens fed to cross-attention."""
        stride = self.swin.patch_size * 2 ** (len(self.swin.depths) - 1)
        return (self.img_h // stride) * (self.img_w // stride)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Where a split lies and the test loader's batch size:
    ``{split}_labels.csv`` with columns ``image_filename, latex_label``,
    images under ``{split}_formulas/``. Only the test loader is ported, so
    the JAX config's worker, shuffling and augmentation settings are not
    here."""

    data_root: str = os.environ.get("MATHOCR_DATA_ROOT", "data")
    batch_size: int = 64

    def img_dir(self, split: str) -> str:
        return os.path.join(self.data_root, f"{split}_formulas")

    def label_path(self, split: str) -> str:
        return os.path.join(self.data_root, f"{split}_labels.csv")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Autoregressive decode settings: the longest output, the beam width
    and the batch buckets a request batch is padded up to."""

    max_seq_len: int = 150
    beam_size: int = 5
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def model_config_from_dict(raw: dict) -> ModelConfig:
    """A ``ModelConfig`` from the JSON dict that ``dataclasses.asdict``
    wrote (the serving artifact's ``model_config.json``)."""
    raw = dict(raw)
    raw["swin"] = SwinConfig(**{**raw["swin"],
                                "depths": tuple(raw["swin"]["depths"]),
                                "num_heads": tuple(raw["swin"]["num_heads"])})
    raw["resnet"] = ResNetConfig(**{
        **raw["resnet"],
        "stage_channels": tuple(raw["resnet"]["stage_channels"]),
        "stage_blocks": tuple(raw["resnet"]["stage_blocks"])})
    return ModelConfig(**raw)


def load_model_config(directory: str) -> ModelConfig:
    """Read ``<directory>/model_config.json``."""
    with open(os.path.join(directory, "model_config.json")) as f:
        return model_config_from_dict(json.load(f))
