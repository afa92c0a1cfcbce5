"""Stdlib logging setup honoring LOG_LEVEL and LOG_FORMAT; port of
``githubrepostorag_tpu/utils/logging.py``.  ``json`` (the default) routes
through the trace-stamped JSON formatter (``obs/logging.py``) so every
line carries trace_id/span_id; ``plain`` keeps the human-format lines."""

from __future__ import annotations

import logging
import os

_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.getenv("LOG_LEVEL", "INFO").upper()
        if os.getenv("LOG_FORMAT", "json").strip().lower() == "json":
            from githubrepostorag_tpu_torch.obs.logging import configure_json_logging

            configure_json_logging(level)
        else:
            logging.basicConfig(
                level=level,
                format="%(asctime)s %(levelname)s %(name)s: %(message)s",
            )
        _configured = True
    return logging.getLogger(name)
