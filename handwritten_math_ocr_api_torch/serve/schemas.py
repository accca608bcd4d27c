"""Request and response schemas of the serving API, as dataclasses.

The port of ``handwritten_math_ocr_api_tpu/serve/schemas.py`` without
pydantic: the same classes, fields, defaults and constraints.
Fields are keyword-only, so that a required one may follow one with a
default, as in pydantic. ``to_dict()`` gives what pydantic's
``model_dump()`` gives (fields in declaration order, ``None`` defaults
included), and each class keeps, in
``JSON_SCHEMA``, the literal schema that pydantic v2's
``model_json_schema`` generates for the JAX model, so that
``/openapi.json`` needs no pydantic. A value outside a constraint raises
``ValueError``, as pydantic's validation error (a ``ValueError``) does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

MAX_BATCH_IMAGES = 10


def _check_number(name: str, value, lo=None, hi=None,
                  optional: bool = False) -> None:
    if value is None and optional:
        return
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{name}: a number is required, got {value!r}")
    if (lo is not None and value < lo) or (hi is not None and value > hi):
        raise ValueError(f"{name}: {value} outside [{lo}, {hi}]")


class _Schema:
    JSON_SCHEMA: Dict[str, Any] = {}

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(kw_only=True)
class PredictionRequest(_Schema):
    image_data: Optional[str] = None

    JSON_SCHEMA = {
        "properties": {"image_data": {
            "anyOf": [{"type": "string"}, {"type": "null"}],
            "default": None, "description": "Base64 encoded image data",
            "title": "Image Data"}},
        "title": "PredictionRequest", "type": "object"}


@dataclasses.dataclass(kw_only=True)
class PredictionResponse(_Schema):
    formula: str
    confidence: Optional[float] = None
    processing_time: float
    timestamp: str

    JSON_SCHEMA = {
        "properties": {
            "formula": {"description": "Predicted LaTeX formula",
                        "title": "Formula", "type": "string"},
            "confidence": {"anyOf": [{"maximum": 1.0, "minimum": 0.0,
                                      "type": "number"},
                                     {"type": "null"}],
                           "default": None, "title": "Confidence"},
            "processing_time": {"minimum": 0.0, "title": "Processing Time",
                                "type": "number"},
            "timestamp": {"title": "Timestamp", "type": "string"}},
        "required": ["formula", "processing_time", "timestamp"],
        "title": "PredictionResponse", "type": "object"}

    def __post_init__(self):
        _check_number("confidence", self.confidence, 0.0, 1.0, optional=True)
        _check_number("processing_time", self.processing_time, 0.0)


@dataclasses.dataclass(kw_only=True)
class BatchPredictionRequest(_Schema):
    images: List[str]

    JSON_SCHEMA = {
        "properties": {"images": {"items": {"type": "string"},
                                  "maxItems": MAX_BATCH_IMAGES,
                                  "minItems": 1, "title": "Images",
                                  "type": "array"}},
        "required": ["images"], "title": "BatchPredictionRequest",
        "type": "object"}

    def __post_init__(self):
        if not isinstance(self.images, list) or not all(
                isinstance(s, str) for s in self.images):
            raise ValueError("images: a list of strings is required")
        if len(self.images) < 1:
            raise ValueError("images: at least 1 image is required")
        if len(self.images) > MAX_BATCH_IMAGES:
            raise ValueError(
                f"Maximum {MAX_BATCH_IMAGES} images allowed per batch")

    @classmethod
    def from_dict(cls, body) -> "BatchPredictionRequest":
        """From a JSON body; other keys are ignored, as pydantic ignores
        them."""
        if not isinstance(body, dict) or "images" not in body:
            raise ValueError("images: field required")
        return cls(images=body["images"])


@dataclasses.dataclass(kw_only=True)
class BatchPredictionResponse(_Schema):
    results: List[Dict[str, Any]]
    total_images: int
    successful_predictions: int
    processing_time: float
    timestamp: str

    JSON_SCHEMA = {
        "properties": {
            "results": {"items": {"additionalProperties": True,
                                  "type": "object"},
                        "title": "Results", "type": "array"},
            "total_images": {"title": "Total Images", "type": "integer"},
            "successful_predictions": {"title": "Successful Predictions",
                                       "type": "integer"},
            "processing_time": {"title": "Processing Time",
                                "type": "number"},
            "timestamp": {"title": "Timestamp", "type": "string"}},
        "required": ["results", "total_images", "successful_predictions",
                     "processing_time", "timestamp"],
        "title": "BatchPredictionResponse", "type": "object"}


@dataclasses.dataclass(kw_only=True)
class StatusResponse(_Schema):
    status: str
    api_version: str
    model_loaded: bool
    vocab_loaded: bool
    device: str
    model_load_time: Optional[float] = None
    total_predictions: int
    uptime: float

    JSON_SCHEMA = {
        "properties": {
            "status": {"title": "Status", "type": "string"},
            "api_version": {"title": "Api Version", "type": "string"},
            "model_loaded": {"title": "Model Loaded", "type": "boolean"},
            "vocab_loaded": {"title": "Vocab Loaded", "type": "boolean"},
            "device": {"title": "Device", "type": "string"},
            "model_load_time": {"anyOf": [{"type": "number"},
                                          {"type": "null"}],
                                "default": None,
                                "title": "Model Load Time"},
            "total_predictions": {"title": "Total Predictions",
                                  "type": "integer"},
            "uptime": {"title": "Uptime", "type": "number"}},
        "required": ["status", "api_version", "model_loaded", "vocab_loaded",
                     "device", "total_predictions", "uptime"],
        "title": "StatusResponse", "type": "object"}


@dataclasses.dataclass(kw_only=True)
class HealthResponse(_Schema):
    healthy: bool
    checks: Dict[str, Any]
    timestamp: str

    JSON_SCHEMA = {
        "properties": {
            "healthy": {"title": "Healthy", "type": "boolean"},
            "checks": {"additionalProperties": True, "title": "Checks",
                       "type": "object"},
            "timestamp": {"title": "Timestamp", "type": "string"}},
        "required": ["healthy", "checks", "timestamp"],
        "title": "HealthResponse", "type": "object"}


@dataclasses.dataclass(kw_only=True)
class ErrorResponse(_Schema):
    error: str
    detail: str
    timestamp: str

    JSON_SCHEMA = {
        "properties": {
            "error": {"title": "Error", "type": "string"},
            "detail": {"title": "Detail", "type": "string"},
            "timestamp": {"title": "Timestamp", "type": "string"}},
        "required": ["error", "detail", "timestamp"],
        "title": "ErrorResponse", "type": "object"}
