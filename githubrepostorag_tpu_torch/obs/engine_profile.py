"""Engine phase spans; port of ``record_engine_spans`` of
``githubrepostorag_tpu/obs/engine_profile.py``.  The rest of that module
(the step profiler and its compile watchdog) comes with ROADMAP queue 1
item 6: the port's ``AsyncEngine`` has no ``profiler`` yet."""

from __future__ import annotations

import time
from typing import Any

from githubrepostorag_tpu_torch.obs.trace import TraceContext, record_span


def record_engine_spans(result: Any, parent: TraceContext | None) -> None:
    """Turn a ``GenerationResult``'s monotonic phase stamps into
    queue-wait / prefill / decode spans under ``parent``.  Tolerates
    partial timings (errored or reaped requests may never prefill)."""
    timings = getattr(result, "timings", None)
    if not timings or parent is None or not parent.sampled:
        return
    submit = timings.get("submit_t")
    pstart = timings.get("prefill_start_t")
    ftok = timings.get("first_token_t")
    done = timings.get("done_t", time.monotonic())
    attrs = {"request_id": getattr(result, "request_id", "")}
    if submit is not None and pstart is not None:
        record_span("engine.queue_wait", submit, pstart, parent=parent, attrs=attrs)
    if pstart is not None and ftok is not None:
        psp = record_span("engine.prefill", pstart, ftok, parent=parent, attrs={
            **attrs, "prompt_tokens": len(getattr(result, "prompt_tokens", ()) or ()),
        })
        if psp is not None:
            # KV tiering: prefix pages this admission swapped in from the
            # host tier instead of recomputing
            faulted = getattr(result, "faulted_pages", 0)
            if faulted:
                psp.add_event("kv_fault_in", pages=faulted)
    if ftok is not None and done > ftok:
        sp = record_span("engine.decode", ftok, done, parent=parent, attrs={
            **attrs, "output_tokens": len(getattr(result, "output_tokens", ()) or ()),
            "finish_reason": getattr(result, "finish_reason", ""),
        })
        if sp is not None:
            # speculative-decoding outcome as events on the decode span
            proposed = getattr(result, "spec_proposed", 0)
            if proposed:
                sp.add_event(
                    "spec", proposed=proposed,
                    accepted=getattr(result, "spec_accepted", 0),
                    acceptance=round(
                        getattr(result, "spec_accepted", 0) / proposed, 4),
                )
            fallback = getattr(result, "spec_fallback", None)
            if fallback:
                sp.add_event("spec_fallback", reason=fallback)
