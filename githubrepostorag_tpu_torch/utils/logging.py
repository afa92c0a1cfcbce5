"""Stdlib logging setup honoring LOG_LEVEL; port of
``githubrepostorag_tpu/utils/logging.py``.  The JAX package's default
``LOG_FORMAT=json`` formatter stamps trace ids from its observability
layer, which comes to the port with that layer (ROADMAP queue 1 item 6);
until then every line has the plain format."""

from __future__ import annotations

import logging
import os

_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        logging.basicConfig(
            level=os.getenv("LOG_LEVEL", "INFO").upper(),
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
        _configured = True
    return logging.getLogger(name)
