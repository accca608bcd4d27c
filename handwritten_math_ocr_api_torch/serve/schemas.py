"""Request and response schemas of the serving API, on pydantic v2.

The port of ``handwritten_math_ocr_api_tpu/serve/schemas.py``: the same
classes, fields, defaults, constraints and validator, so that
``model_dump()``, ``model_json_schema()`` and the ``ValidationError`` of a
bad body are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field, field_validator

MAX_BATCH_IMAGES = 10


class PredictionRequest(BaseModel):
    image_data: Optional[str] = Field(
        None, description="Base64 encoded image data")


class PredictionResponse(BaseModel):
    formula: str = Field(..., description="Predicted LaTeX formula")
    confidence: Optional[float] = Field(None, ge=0.0, le=1.0)
    processing_time: float = Field(..., ge=0.0)
    timestamp: str


class BatchPredictionRequest(BaseModel):
    images: List[str] = Field(..., min_length=1,
                              max_length=MAX_BATCH_IMAGES)

    @field_validator("images")
    @classmethod
    def validate_images(cls, v):
        if len(v) > MAX_BATCH_IMAGES:
            raise ValueError(
                f"Maximum {MAX_BATCH_IMAGES} images allowed per batch")
        return v


class BatchPredictionResponse(BaseModel):
    results: List[Dict[str, Any]]
    total_images: int
    successful_predictions: int
    processing_time: float
    timestamp: str


class StatusResponse(BaseModel):
    status: str
    api_version: str
    model_loaded: bool
    vocab_loaded: bool
    device: str
    model_load_time: Optional[float] = None
    total_predictions: int
    uptime: float


class HealthResponse(BaseModel):
    healthy: bool
    checks: Dict[str, Any]
    timestamp: str


class ErrorResponse(BaseModel):
    error: str
    detail: str
    timestamp: str
