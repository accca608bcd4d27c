"""OpenAPI spec + docs pages of the serving API.

The port of ``handwritten_math_ocr_api_tpu/serve/openapi.py``: the same
spec, assembled from the pydantic schemas of ``serve/schemas.py``, and the
same Swagger UI and ReDoc pages, served at ``/openapi.json``, ``/docs`` and
``/redoc``.
"""

from __future__ import annotations

from typing import Dict

from .schemas import (
    BatchPredictionRequest, BatchPredictionResponse, ErrorResponse,
    HealthResponse, PredictionResponse, StatusResponse,
)


def build_spec(title: str, version: str, description: str) -> Dict:
    def ref(model):
        return {"$ref": f"#/components/schemas/{model.__name__}"}

    schemas = {}
    for model in (PredictionResponse, BatchPredictionRequest,
                  BatchPredictionResponse, StatusResponse, HealthResponse,
                  ErrorResponse):
        schema = model.model_json_schema(
            ref_template="#/components/schemas/{model}")
        schemas.update(schema.pop("$defs", {}))
        schemas[model.__name__] = schema

    def responses(model, desc="OK"):
        return {
            "200": {"description": desc,
                    "content": {"application/json": {"schema": ref(model)}}},
            "429": {"description": "Rate limit exceeded"},
        }

    return {
        "openapi": "3.1.0",
        "info": {"title": title, "version": version,
                 "description": description},
        "paths": {
            "/predict": {"post": {
                "summary": "Predict LaTeX from one image "
                           "(multipart 'file' or JSON {'image_data': b64}); "
                           "optional ?beam_size=N or sampled decode via "
                           "?temperature=&top_k=&top_p=&seed=. confidence "
                           "is calibrated when the model dir ships "
                           "calibration.json (SERVING_CALIBRATION)",
                "parameters": [
                    {"name": "beam_size", "in": "query", "required": False,
                     "schema": {"type": "integer", "minimum": 1,
                                "maximum": 16}},
                    {"name": "temperature", "in": "query", "required": False,
                     "schema": {"type": "number", "exclusiveMinimum": 0,
                                "maximum": 10}},
                    {"name": "top_k", "in": "query", "required": False,
                     "schema": {"type": "integer", "minimum": 0,
                                "maximum": 1024}},
                    {"name": "top_p", "in": "query", "required": False,
                     "schema": {"type": "number", "exclusiveMinimum": 0,
                                "maximum": 1}},
                    {"name": "seed", "in": "query", "required": False,
                     "schema": {"type": "integer"}},
                ],
                "responses": responses(PredictionResponse),
            }},
            "/predict/stream": {"post": {
                "summary": "Streaming decode (server-sent events): token "
                           "events as each decode segment lands, final "
                           "event carries formula+confidence; same input "
                           "contract as /predict",
                "parameters": [
                    {"name": "segment_steps", "in": "query",
                     "required": False,
                     "schema": {"type": "integer", "minimum": 1,
                                "maximum": 64, "default": 8}},
                ],
                "responses": {"200": {"description":
                                      "text/event-stream of JSON events"},
                              "429": {"description": "Rate limit exceeded"}},
            }},
            "/predict/batch": {"post": {
                # the JAX package's spec word for word (the served spec is
                # the same document whichever package serves it)
                "summary": "Predict LaTeX for 1-10 base64 images (batched "
                           "on the TPU)",
                "requestBody": {"content": {"application/json": {
                    "schema": ref(BatchPredictionRequest)}}},
                "responses": responses(BatchPredictionResponse),
            }},
            "/status": {"get": {"summary": "System status",
                                "responses": responses(StatusResponse)}},
            "/health": {"get": {"summary": "Health checks",
                                "responses": responses(HealthResponse)}},
            "/model/info": {"get": {"summary": "Model configuration",
                                    "responses": {"200": {"description": "OK"}}}},
            "/metrics": {"get": {"summary": "Service metrics",
                                 "responses": {"200": {"description": "OK"}}}},
            "/rate-limit/status": {"get": {
                "summary": "Caller's rate-limit usage",
                "responses": {"200": {"description": "OK"}}}},
        },
        "components": {"schemas": schemas},
    }


DOCS_HTML = """<!DOCTYPE html>
<html>
  <head>
    <title>{title} — docs</title>
    <link rel="stylesheet"
          href="https://unpkg.com/swagger-ui-dist@5/swagger-ui.css">
  </head>
  <body>
    <div id="swagger-ui">
      <p>Loading Swagger UI… If this page stays blank (no internet),
         the raw spec is at <a href="/openapi.json">/openapi.json</a>.</p>
    </div>
    <script src="https://unpkg.com/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
    <script>
      window.onload = () => {{
        if (window.SwaggerUIBundle)
          SwaggerUIBundle({{url: "/openapi.json", dom_id: "#swagger-ui"}});
      }};
    </script>
  </body>
</html>"""


REDOC_HTML = """<!DOCTYPE html>
<html>
  <head>
    <title>{title} — ReDoc</title>
    <meta charset="utf-8"/>
    <meta name="viewport" content="width=device-width, initial-scale=1">
    <style>body {{ margin: 0; padding: 0; }}</style>
  </head>
  <body>
    <noscript>ReDoc requires Javascript. The raw spec is at
      <a href="/openapi.json">/openapi.json</a>.</noscript>
    <redoc spec-url="/openapi.json"></redoc>
    <script src="https://cdn.redoc.ly/redoc/latest/bundles/redoc.standalone.js"></script>
  </body>
</html>"""
