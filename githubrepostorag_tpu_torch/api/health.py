"""Deep /health probe, Spring-Actuator-shaped; a copy of
``githubrepostorag_tpu/api/health.py``.

Rebuild of rest_api/src/app/health.py:22-142: aggregate UP/DOWN with
components for the vector store (connectivity + index presence), the LLM
backend, and system stats (psutil cpu/mem/disk + uptime); HTTP 503 when any
required component is DOWN.
"""

from __future__ import annotations

import time

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_START_TIME = time.monotonic()


def format_uptime(seconds: float) -> str:
    seconds = int(seconds)
    days, rem = divmod(seconds, 86400)
    hours, rem = divmod(rem, 3600)
    minutes, secs = divmod(rem, 60)
    parts = []
    if days:
        parts.append(f"{days}d")
    if hours or days:
        parts.append(f"{hours}h")
    if minutes or hours or days:
        parts.append(f"{minutes}m")
    parts.append(f"{secs}s")
    return " ".join(parts)


def _store_component() -> dict:
    try:
        from githubrepostorag_tpu_torch.store import get_store

        health = get_store().health()
        tables = health.get("tables", {})
        chunk_table = get_settings().embeddings_table_chunk
        indexed = tables.get(chunk_table, 0)
        detail = {
            "status": health.get("status", "DOWN"),
            "details": {
                "backend": get_settings().store_backend,
                "tables": tables,
                "vector_index": "ready" if indexed else "empty",
            },
        }
        return detail
    except Exception as exc:  # noqa: BLE001
        return {"status": "DOWN", "details": {"error": str(exc)}}


def _llm_component() -> dict:
    s = get_settings()
    backend = s.llm_backend.lower()
    try:
        if backend == "http":
            import requests

            resp = requests.get(f"{s.qwen_endpoint.rstrip('/')}/health", timeout=5)
            ok = resp.status_code == 200
            return {
                "status": "UP" if ok else "DOWN",
                "details": {"backend": "http", "endpoint": s.qwen_endpoint,
                            "http_status": resp.status_code},
            }
        if backend == "fake":
            return {"status": "UP", "details": {"backend": "fake"}}
        # inprocess: report engine stats when one is wired
        from githubrepostorag_tpu_torch.llm import _llm  # noqa: PLC0415

        details: dict = {"backend": "inprocess"}
        engine = getattr(_llm, "engine", None)
        if engine is not None:
            details.update(engine.stats())
        return {"status": "UP", "details": details}
    except Exception as exc:  # noqa: BLE001
        return {"status": "DOWN", "details": {"backend": backend, "error": str(exc)}}


def _system_component() -> dict:
    try:
        import psutil

        vm = psutil.virtual_memory()
        disk = psutil.disk_usage("/")
        return {
            "status": "UP",
            "details": {
                "cpu_percent": psutil.cpu_percent(interval=None),
                "memory_percent": vm.percent,
                "disk_percent": disk.percent,
                "uptime": format_uptime(time.monotonic() - _START_TIME),
            },
        }
    except Exception as exc:  # noqa: BLE001
        return {"status": "UP", "details": {"error": str(exc)}}


def _resilience_component(queue_depth: int | None) -> dict:
    """Breaker states, queue depth, and in-flight jobs.  DOWN while any
    circuit is open: the pod is refusing work on that dependency, so load
    balancers should steer traffic elsewhere until the breaker half-opens."""
    try:
        from githubrepostorag_tpu_torch.metrics import JOBS_IN_FLIGHT, counter_value
        from githubrepostorag_tpu_torch.resilience.policy import breaker_states

        breakers = breaker_states()
        any_open = any(b["state"] == "open" for b in breakers.values())
        details: dict = {
            "breakers": breakers,
            "jobs_in_flight": int(counter_value(JOBS_IN_FLIGHT)),
        }
        if queue_depth is not None:
            details["queue_depth"] = queue_depth
        return {"status": "DOWN" if any_open else "UP", "details": details}
    except Exception as exc:  # noqa: BLE001
        return {"status": "UP", "details": {"error": str(exc)}}


def health_report(queue_depth: int | None = None) -> tuple[dict, int]:
    """-> (payload, http_status).  503 when store, LLM, or resilience (an
    open circuit breaker) is DOWN."""
    components = {
        "vectorStore": _store_component(),
        "llm": _llm_component(),
        "system": _system_component(),
        "resilience": _resilience_component(queue_depth),
    }
    required = ("vectorStore", "llm", "resilience")
    overall = "UP" if all(components[c]["status"] == "UP" for c in required) else "DOWN"
    return {"status": overall, "components": components}, (200 if overall == "UP" else 503)
