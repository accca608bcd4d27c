"""Logging setup with optional Google Cloud Logging shipping.

The port of ``handwritten_math_ocr_api_tpu/utils/logging.py``: stdout
logging always; if ``ENABLE_CLOUD_LOGGING=true`` and the
``google-cloud-logging`` client is importable (it is imported inside
``setup_logging``, and the port needs it nowhere else), logs also ship to
Cloud Logging.
"""

from __future__ import annotations

import logging
import os
import sys


def setup_logging(level: int = logging.INFO,
                  enable_cloud: bool | None = None) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)

    if enable_cloud is None:
        enable_cloud = os.environ.get(
            "ENABLE_CLOUD_LOGGING", "").lower() in ("1", "true", "yes")
    if enable_cloud:
        try:
            import google.cloud.logging as gcl  # type: ignore

            client = gcl.Client()
            client.setup_logging(log_level=level)
            logging.getLogger(__name__).info("cloud logging enabled")
        except ImportError:
            logging.getLogger(__name__).warning(
                "ENABLE_CLOUD_LOGGING set but google-cloud-logging is not "
                "installed; logging to stdout only")
    return root
