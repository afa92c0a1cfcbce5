"""Structured JSON logging stamped with the active trace; a copy of
``githubrepostorag_tpu/obs/logging.py``.

One line per record: ``{"ts", "level", "logger", "msg", "trace_id?",
"span_id?", "exc?"}`` — grep a trace_id from ``/debug/traces`` straight
into the service logs and every line a job emitted lines up with its
span timeline.  The trace lookup is a contextvar read per record, and
records logged outside any trace simply omit the fields.

Selected by ``LOG_FORMAT=json`` (the default — ``LOG_FORMAT=plain``
restores the human-format lines) via ``utils.logging.get_logger``, which
every module already uses; nothing logs through print().
"""

from __future__ import annotations

import io
import json
import logging
import time


class TraceJsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, object] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # lazy: logging is configured before the obs package is needed
        from githubrepostorag_tpu_torch.obs.trace import current_context, current_span

        ctx = current_context()
        if ctx is not None and ctx.trace_id:
            payload["trace_id"] = ctx.trace_id
        sp = current_span()
        if sp is not None:
            payload["span_id"] = sp.span_id
        if record.exc_info:
            buf = io.StringIO()
            buf.write(self.formatException(record.exc_info))
            payload["exc"] = buf.getvalue()
        return json.dumps(payload, default=str)


def configure_json_logging(level: str = "INFO") -> None:
    """Install the trace-stamped JSON formatter on the root logger
    (idempotent — reuses the existing handler on reconfigure)."""
    root = logging.getLogger()
    root.setLevel(level.upper())
    for handler in root.handlers:
        if isinstance(handler.formatter, TraceJsonFormatter):
            return
    handler = logging.StreamHandler()
    handler.setFormatter(TraceJsonFormatter())
    root.addHandler(handler)
