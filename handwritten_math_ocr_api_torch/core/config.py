"""Configuration of the port.

A copy of ``handwritten_math_ocr_api_tpu/core/config.py`` (the port imports
nothing of the JAX package): the special token ids, ``SwinConfig``,
``ResNetConfig``, ``ModelConfig``, ``DataConfig``, ``TrainConfig``,
``DecodeConfig``, ``ServeConfig`` (with ``from_env`` reading the same
environment variables) and the ``Config`` bundle, with the same fields and
defaults, plus the loader for the ``model_config.json`` that a serving
artifact (such as ``serving_model_r4/``) carries.
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
    """ResNet-18 encoder hyperparameters (``models/resnet.py``)."""

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
        """Number of encoder output tokens fed to cross-attention: the
        Swin trunk's stride-32 grid (30 at 96x320), or the W/32 columns
        that the ResNet encoders keep after pooling the height (10)."""
        if self.encoder == "swin_t":
            stride = self.swin.patch_size * 2 ** (len(self.swin.depths) - 1)
            return (self.img_h // stride) * (self.img_w // stride)
        return self.img_w // 32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and loader settings: ``{split}_labels.csv`` with
    columns ``image_filename, latex_label``, images under
    ``{split}_formulas/``; the training loader's threads and shuffle seed,
    and the affine augmentation the train step applies on the device."""

    data_root: str = os.environ.get("MATHOCR_DATA_ROOT", "data")
    batch_size: int = 64
    num_workers: int = 4
    shuffle_seed: int = 0
    aug_degrees: float = 2.0
    aug_shear: float = 2.0
    aug_scale: Tuple[float, float] = (0.95, 1.05)

    def img_dir(self, split: str) -> str:
        return os.path.join(self.data_root, f"{split}_formulas")

    def label_path(self, split: str) -> str:
        return os.path.join(self.data_root, f"{split}_labels.csv")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters, every field and default as the JAX
    package's. ``data_axis`` and ``tensor_axis`` shape the ('data',
    'tensor') mesh that ``train/loop.train_model`` builds over the ranks of
    a ``torch.distributed`` run (``-1``: every rank the tensor axis
    leaves)."""

    learning_rate: float = 3e-4
    epochs: int = 20
    label_smoothing: float = 0.1
    # linear learning-rate warmup steps (0 = off)
    warmup_steps: int = 0
    grad_clip_norm: float = 1.0
    # the plateau scheduler on the val loss
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    early_stop_patience: int = 5
    checkpoint_every: int = 5
    checkpoint_dir: str = os.environ.get("MATHOCR_CKPT_DIR", "checkpoints")
    seed: int = 0
    data_axis: int = -1
    tensor_axis: int = 1
    # recompute the encoder in the backward pass instead of keeping its
    # activations
    remat: bool = False
    # decay of an exponential moving average of the params (0 = off); when
    # on, the val pass and the exported weights use the average
    ema_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Autoregressive decode settings: the longest output, the beam width
    and the batch buckets a request batch is padded up to."""

    max_seq_len: int = 150
    beam_size: int = 5
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def _env_flag(env, name: str, default: bool) -> bool:
    return env.get(name, "1" if default else "0") in ("1", "true", "True")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving config, env-overridable (``from_env``); every field and
    default as the JAX package's. ``mesh_data_axis > 1`` shards the
    continuous pool over that many devices, with host admission
    (``serve/app.py``)."""

    host: str = "0.0.0.0"
    port: int = 8080
    api_title: str = "Handwritten Math Formula Recognition API"
    api_description: str = (
        "Convert handwritten mathematical formulas to LaTeX using deep learning"
    )
    api_version: str = "1.0.0"
    model_dir: str = "trained-model"
    api_key: str = ""
    cors_origins: Tuple[str, ...] = ("*",)
    trusted_hosts: Tuple[str, ...] = ("*",)
    max_file_size: int = 10 * 1024 * 1024
    allowed_extensions: Tuple[str, ...] = (
        ".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".webp",
    )
    # fixed-window rate limits per client
    rate_limit_per_minute: int = 20
    rate_limit_per_hour: int = 200
    rate_limit_per_day: int = 1000
    rate_limit_anonymous_daily: int = 100
    max_concurrent_requests: int = 10
    redis_url: str = ""
    # "dynamic": coalesce arrivals into one bucketed decode a dispatch;
    # "continuous": the slot pool of decode/continuous.py
    batching_mode: str = "dynamic"
    max_batch_size: int = 64
    # dynamic batching linger: 0 = drain-and-go, > 0 = wait this long
    # after the first request for company
    batch_timeout_ms: float = 0.0
    max_batch_images: int = 10  # per /predict/batch request
    # continuous mode: slots, steps between admissions, segments in
    # flight, report threads (0 = 1), the fused route's segment ring
    num_slots: int = 63
    segment_steps: int = 16
    pipeline_depth: int = 4
    harvest_threads: int = 0
    segment_ring: bool = True
    # continuous mode over a data-axis mesh of this many devices (1 = off)
    mesh_data_axis: int = 1
    # serving deadline per prediction (seconds; 0 = off): 504, and the
    # request's device work cancelled as for a client disconnect
    request_timeout_s: float = 0.0
    # how long a recycling worker waits for in-flight predictions
    drain_timeout_s: float = 120.0
    # after this many prediction requests the worker drains and exits 0
    # for its supervisor to restart it (0 = off)
    max_requests: int = 0
    # continuous admission: "host" (segment-boundary inserts) or "device"
    # (served as "host" by the port)
    admission: str = "host"
    # confidence calibration: "auto" (<model_dir>/calibration.json when
    # present), "off", or a JSON path
    calibration: str = "auto"
    # the fused route: every greedy step one fused decoder-step launch
    use_fused_decode: bool = False
    # int8 decoder weights
    quantize_decode: bool = False
    # the whole-block Swin kernel in the encoder
    pallas_encoder_block: bool = False
    # decode batch sizes run once at startup (SERVING_WARMUP, "0" = none;
    # from_env defaults to (1,))
    warmup_batch_sizes: Tuple[int, ...] = ()
    # greedy decoding under the LaTeX pushdown mask (decode/constrain.py)
    constrained_decode: bool = False
    # ship uint8 pixels and normalize on the device
    uint8_transfer: bool = True

    @classmethod
    def from_env(cls) -> "ServeConfig":
        env = os.environ
        defaults = cls()

        def _split(name: str, default: Tuple[str, ...]) -> Tuple[str, ...]:
            raw = env.get(name)
            if not raw:
                return default
            return tuple(s.strip() for s in raw.split(",") if s.strip())

        return cls(
            host=env.get("HOST", defaults.host),
            port=int(env.get("PORT", defaults.port)),
            model_dir=env.get("MODEL_DIR", defaults.model_dir),
            api_key=env.get("MODEL_API_KEY", defaults.api_key),
            cors_origins=_split("CORS_ORIGINS", defaults.cors_origins),
            trusted_hosts=_split("TRUSTED_HOSTS", defaults.trusted_hosts),
            rate_limit_per_minute=int(env.get(
                "RATE_LIMIT_PER_MINUTE", defaults.rate_limit_per_minute)),
            rate_limit_per_hour=int(env.get(
                "RATE_LIMIT_PER_HOUR", defaults.rate_limit_per_hour)),
            rate_limit_per_day=int(env.get(
                "RATE_LIMIT_PER_DAY", defaults.rate_limit_per_day)),
            rate_limit_anonymous_daily=int(env.get(
                "RATE_LIMIT_ANON_DAILY",
                defaults.rate_limit_anonymous_daily)),
            max_concurrent_requests=int(env.get(
                "MAX_CONCURRENT_REQUESTS", defaults.max_concurrent_requests)),
            redis_url=env.get("REDIS_URL", defaults.redis_url),
            max_batch_size=int(env.get("MAX_BATCH_SIZE",
                                       defaults.max_batch_size)),
            batch_timeout_ms=float(env.get("BATCH_TIMEOUT_MS",
                                           defaults.batch_timeout_ms)),
            batching_mode=env.get("SERVING_BATCH_MODE",
                                  defaults.batching_mode),
            num_slots=int(env.get("SERVING_NUM_SLOTS", defaults.num_slots)),
            segment_steps=int(env.get("SERVING_SEGMENT_STEPS",
                                      defaults.segment_steps)),
            pipeline_depth=int(env.get("SERVING_PIPELINE_DEPTH",
                                       defaults.pipeline_depth)),
            harvest_threads=int(env.get("SERVING_HARVEST_THREADS",
                                        defaults.harvest_threads)),
            segment_ring=_env_flag(env, "SERVING_SEGMENT_RING",
                                   defaults.segment_ring),
            warmup_batch_sizes=tuple(
                int(s) for s in env.get("SERVING_WARMUP", "1").split(",")
                if s.strip() and int(s) > 0),
            mesh_data_axis=int(env.get("SERVING_MESH_DATA",
                                       defaults.mesh_data_axis)),
            calibration=env.get("SERVING_CALIBRATION", defaults.calibration),
            admission=env.get("SERVING_ADMISSION", defaults.admission),
            request_timeout_s=float(env.get("SERVING_REQUEST_TIMEOUT",
                                            defaults.request_timeout_s)),
            drain_timeout_s=float(env.get("SERVING_DRAIN_TIMEOUT",
                                          defaults.drain_timeout_s)),
            max_requests=int(env.get("SERVING_MAX_REQUESTS",
                                     defaults.max_requests)),
            use_fused_decode=_env_flag(env, "SERVING_USE_FUSED",
                                       defaults.use_fused_decode),
            quantize_decode=_env_flag(env, "SERVING_QUANTIZE",
                                      defaults.quantize_decode),
            pallas_encoder_block=_env_flag(env, "SERVING_PALLAS_ENCODER",
                                           defaults.pallas_encoder_block),
            uint8_transfer=_env_flag(env, "SERVING_UINT8_TRANSFER",
                                     defaults.uint8_transfer),
            constrained_decode=_env_flag(env, "SERVING_CONSTRAINED",
                                         defaults.constrained_decode),
        )


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level bundle."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)


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
