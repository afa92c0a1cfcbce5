"""LLM client layer: one protocol, three backends; port of
``githubrepostorag_tpu/llm.py``.

The reference has two divergent QwenLLM clients (worker's
rag_worker/src/worker/services/qwen_llm.py and ingest's
ingest/src/app/llm_init.py) with drifting behavior.  Here one protocol
serves both callers, with the load-bearing behaviors preserved:
  - errors travel as text, never raise (qwen_llm.py:146-148) — the agent
    loop's robustness depends on it
  - chain-of-thought sanitization (<think> blocks, role markers, chatty
    prefixes — llm_init.py:36-48)
  - selector-prompt cleanup with the malformed-JSON choice cascade
    (qwen_llm.py:54-102)

Backends:
  - ``InProcessLLM`` — the port's own engine (``serving.AsyncEngine`` over
    ``Engine``, on the card), no HTTP hop (single-pod).
  - ``HTTPLLM`` — OpenAI-compatible endpoint (QWEN_ENDPOINT), for split
    deployments against the port's model server
    (``python -m githubrepostorag_tpu_torch.serving``); on ``urllib``, where
    the JAX package uses ``requests``.
  - ``FakeLLM`` — scripted/deterministic responses for tests (the
    scripted-JSON plan/judge fake SURVEY.md §4 calls for).
"""

from __future__ import annotations

import asyncio
import json
import re
import threading
import time
from typing import Callable, Iterator, Protocol, Sequence

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.resilience.faults import fire_sync
from githubrepostorag_tpu_torch.resilience.policy import current_deadline, get_breaker
from githubrepostorag_tpu_torch.utils.json_utils import extract_choice, sanitize_llm_text, strip_fences
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_SELECTOR_RE = re.compile(r"respond with (?:only )?(?:the )?(?:number|choice)", re.IGNORECASE)


def _is_selector_prompt(prompt: str) -> bool:
    return bool(_SELECTOR_RE.search(prompt)) or "Select the best option" in prompt


def postprocess_completion(prompt: str, text: str) -> str:
    """The one completion post-processing pipeline (fence strip, CoT/role
    sanitize, selector extraction) — used by every ``complete`` impl, and by
    callers that assemble text from a raw token stream so streamed and
    non-streamed answers can't drift."""
    text = sanitize_llm_text(strip_fences(text).strip()).strip()
    if _is_selector_prompt(prompt):
        return extract_choice(text)
    return text


_postprocess = postprocess_completion


def _llm_preamble() -> str | None:
    """Shared entry gate for every backend's ``complete``: the
    ``llm.complete`` fault seam plus the deadline check.  Returns error
    text (the "errors travel as text, never raise" contract) when the call
    must not proceed; InjectedFault from an ``error`` action propagates so
    callers exercise their real exception paths."""
    if fire_sync("llm.complete"):
        return "Error: injected drop at llm.complete"
    deadline = current_deadline()
    if deadline is not None and deadline.expired:
        return "Error: deadline exceeded before LLM call"
    return None


class LLM(Protocol):
    def complete(
        self,
        prompt: str,
        *,
        system: str | None = None,
        max_tokens: int | None = None,
        temperature: float | None = None,
    ) -> str: ...

    def stream_complete(
        self,
        prompt: str,
        *,
        system: str | None = None,
        max_tokens: int | None = None,
        temperature: float | None = None,
        on_text: Callable[[str], None] | None = None,
    ) -> Iterator[str]:
        """Yield text deltas; callers that don't care iterate to exhaustion."""
        ...


class FakeLLM:
    """Deterministic scripted LLM.  ``script`` maps a regex (matched against
    the prompt) to a response or callable; unmatched prompts get
    ``default``.  Records every call for assertions."""

    def __init__(self, script: dict[str, str | Callable[[str], str]] | None = None,
                 default: str = "FAKE_ANSWER") -> None:
        self.script = script or {}
        self.default = default
        self.calls: list[dict] = []

    def complete(self, prompt, *, system=None, max_tokens=None, temperature=None) -> str:
        self.calls.append({"prompt": prompt, "system": system,
                           "max_tokens": max_tokens, "temperature": temperature})
        gate = _llm_preamble()
        if gate is not None:
            return gate
        for pattern, response in self.script.items():
            if re.search(pattern, prompt, re.DOTALL | re.IGNORECASE):
                text = response(prompt) if callable(response) else response
                return _postprocess(prompt, text)
        return _postprocess(prompt, self.default)

    def stream_complete(self, prompt, *, system=None, max_tokens=None,
                        temperature=None, on_text=None) -> Iterator[str]:
        text = self.complete(prompt, system=system, max_tokens=max_tokens,
                             temperature=temperature)
        # stream in word-ish chunks so consumers exercise their delta paths
        for piece in re.findall(r"\S+\s*|\s+", text):
            if on_text:
                on_text(piece)
            yield piece

    def complete_batch(self, prompts: Sequence[str], *, system=None,
                       max_tokens=None, temperature=None) -> list[str]:
        return [self.complete(p, system=system, max_tokens=max_tokens,
                              temperature=temperature) for p in prompts]


class InProcessLLM:
    """Directly drives the port's AsyncEngine from sync callers (the agent
    loop and ingest run in worker threads; the engine's asyncio loop lives
    in a dedicated background thread here, beside the engine's own driver
    thread).  A call abandoned by its caller (its wait timed out) cancels
    its coroutine, and the engine's stream then cancels the row, so its KV
    pages come back."""

    def __init__(self, async_engine, tokenizer, *,
                 default_max_tokens: int | None = None,
                 default_temperature: float | None = None,
                 context_window: int | None = None) -> None:
        s = get_settings()
        self.engine = async_engine
        self.tokenizer = tokenizer
        self.default_max_tokens = default_max_tokens or s.qwen_max_output
        self.default_temperature = (
            s.qwen_temperature if default_temperature is None else default_temperature
        )
        self.context_window = context_window or s.context_window
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._loop_ready = threading.Event()
        # concurrent first calls (the worker's jobs start together) must
        # share one loop: the JAX version checks and starts without a lock,
        # so two callers can start two loops, and the AsyncEngine then
        # delivers one caller's events onto the other's loop, where the
        # waiting coroutine never wakes
        self._loop_lock = threading.Lock()

    # -- background asyncio loop ------------------------------------------

    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        with self._loop_lock:
            if self._loop is None:
                def run() -> None:
                    loop = asyncio.new_event_loop()
                    asyncio.set_event_loop(loop)
                    self._loop = loop
                    self._loop_ready.set()
                    loop.run_forever()

                self._loop_thread = threading.Thread(target=run, name="llm-loop", daemon=True)
                self._loop_thread.start()
                self._loop_ready.wait()
            return self._loop

    def close(self) -> None:
        """Stop the engine driver and the background asyncio loop.  Without
        this, short-lived instances (bench items, tests) leak a daemon
        drive thread whose closure keeps the Engine — and its device page
        pools — alive past ``del``."""
        with self._loop_lock:
            self._close()

    def _close(self) -> None:
        if self._loop is None:
            return
        try:
            asyncio.run_coroutine_threadsafe(
                self.engine.stop(), self._loop
            ).result(timeout=10)
        except Exception:  # noqa: BLE001 - best-effort shutdown
            logger.warning("InProcessLLM.close: engine stop failed", exc_info=True)
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
        self._loop.close()  # release the selector fd, not just the reference
        self._loop = None
        self._loop_thread = None
        # a later call may start a fresh loop (AsyncEngine supports
        # stop() -> start() relaunch); the ready Event must re-arm or
        # _ensure_loop would return before the new thread assigns _loop
        self._loop_ready.clear()

    def _messages(self, prompt: str, system: str | None) -> list[dict]:
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        return messages

    def _prompt_ids(self, prompt: str, system: str | None) -> list[int]:
        ids = self.tokenizer.encode_chat(self._messages(prompt, system))
        # context budget: keep the tail (the reference truncates inputs
        # upstream; this is the final guard)
        budget = self.context_window - 64
        return ids[-budget:] if len(ids) > budget else ids

    def _sampling(self, max_tokens, temperature):
        from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

        s = get_settings()
        return SamplingParams(
            temperature=self.default_temperature if temperature is None else temperature,
            top_p=s.qwen_top_p,
            max_tokens=max_tokens or self.default_max_tokens,
            stop_token_ids=(self.tokenizer.eos_token_id,),
        )

    @staticmethod
    def _priority_class() -> str | None:
        """The job's SLO class off the thread-local scope the worker set
        (None lets the engine apply its configured default)."""
        from githubrepostorag_tpu_torch.resilience.policy import current_priority

        return current_priority()

    @staticmethod
    def _deadline_budget() -> tuple[float | None, float]:
        """-> (engine deadline_s, caller-side timeout).  The engine gets an
        absolute monotonic deadline so it can reap the row itself at a step
        boundary (freeing KV pages); the thread-side fut.result timeout is
        the remaining budget plus slack — a backstop, never the primary
        enforcement, so expired requests normally come back as a reaped
        result instead of an abandoned engine row."""
        timeout = float(get_settings().job_timeout_seconds)
        deadline = current_deadline()
        if deadline is None:
            return None, timeout
        remaining = deadline.remaining()
        return time.monotonic() + remaining, min(timeout, remaining + 5.0)

    def complete(self, prompt, *, system=None, max_tokens=None, temperature=None) -> str:
        from githubrepostorag_tpu_torch.obs.engine_profile import record_engine_spans
        from githubrepostorag_tpu_torch.obs.trace import NOOP_SPAN
        from githubrepostorag_tpu_torch.obs.trace import span as trace_span

        gate = _llm_preamble()
        if gate is not None:
            return gate
        loop = self._ensure_loop()
        deadline_s, timeout = self._deadline_budget()
        with trace_span("llm.generate") as sp:
            # registered spans receive xla_compile events if this request's
            # steps trigger a fresh compilation (obs/engine_profile.py)
            profiler = getattr(self.engine, "profiler", None)
            live = sp is not NOOP_SPAN and profiler is not None
            if live:
                profiler.register(sp)
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    self.engine.generate(self._prompt_ids(prompt, system),
                                         self._sampling(max_tokens, temperature),
                                         deadline_s=deadline_s,
                                         priority=self._priority_class()),
                    loop,
                )
                result = fut.result(timeout=timeout)
            except Exception as exc:  # noqa: BLE001 - errors travel as text
                fut.cancel()  # an abandoned wait must not leave its row decoding
                logger.error("InProcessLLM error: %s", exc)
                sp.set_status(f"error: {type(exc).__name__}")
                return f"Error: {exc}"
            finally:
                if live:
                    profiler.unregister(sp)
            record_engine_spans(result, parent=sp.context)
            sp.set_attr("finish_reason", result.finish_reason)
            if result.finish_reason == "error":
                sp.set_status("error: engine")
                return f"Error: {result.error}"
            if result.finish_reason == "deadline":
                sp.set_status("error: deadline")
                return "Error: deadline exceeded (engine reaped the request)"
            return _postprocess(prompt, self.tokenizer.decode(result.output_tokens))

    def complete_batch(self, prompts: Sequence[str], *, system=None,
                       max_tokens=None, temperature=None) -> list[str]:
        """Submit every prompt at once — the engine's continuous batching
        runs them together (prefill-heavy TPU inference for the ingest
        extractors, BASELINE config #4), instead of one round-trip each."""
        loop = self._ensure_loop()
        sampling = self._sampling(max_tokens, temperature)
        deadline_s, base_timeout = self._deadline_budget()

        priority = self._priority_class()

        async def run_all():
            return await asyncio.gather(
                *(self.engine.generate(self._prompt_ids(p, system), sampling,
                                       deadline_s=deadline_s,
                                       priority=priority) for p in prompts),
                return_exceptions=True,
            )

        fut = asyncio.run_coroutine_threadsafe(run_all(), loop)
        # budget scales with batch size (continuous batching overlaps them,
        # but a loaded engine still serializes some decode time); a live
        # deadline overrides — the batch shares the request's one budget
        timeout = base_timeout if deadline_s is not None else (
            get_settings().job_timeout_seconds * max(1, -(-len(prompts) // 8))
        )
        try:
            results = fut.result(timeout=timeout)
        except Exception as exc:  # noqa: BLE001
            fut.cancel()  # stop the still-running batch from competing with the next stage
            logger.error("InProcessLLM batch error: %s", exc)
            return [f"Error: {exc}"] * len(prompts)
        out = []
        for prompt, res in zip(prompts, results):
            if isinstance(res, Exception):
                out.append(f"Error: {res}")
            elif res.finish_reason == "error":
                out.append(f"Error: {res.error}")
            elif res.finish_reason == "deadline":
                out.append("Error: deadline exceeded (engine reaped the request)")
            else:
                out.append(_postprocess(prompt, self.tokenizer.decode(res.output_tokens)))
        return out

    def stream_complete(self, prompt, *, system=None, max_tokens=None,
                        temperature=None, on_text=None) -> Iterator[str]:
        from githubrepostorag_tpu_torch.serving.tokenizer import StreamingDetokenizer

        from githubrepostorag_tpu_torch.obs.engine_profile import record_engine_spans
        from githubrepostorag_tpu_torch.obs.trace import Span, current_context

        gate = _llm_preamble()
        if gate is not None:
            if on_text:
                on_text(gate)
            yield gate
            return
        loop = self._ensure_loop()
        deadline_s, _ = self._deadline_budget()
        # manual span: the generator body runs on the consumer's schedule
        # and the engine result surfaces on the pump (llm-loop) thread, so
        # the trace context is captured here and threaded in explicitly.
        # Registered with the driver's step profiler, the span receives an
        # ``xla_compile`` event if live traffic meets an unwarmed shape
        ctx = current_context()
        sp = Span("llm.generate", ctx) if ctx is not None and ctx.sampled else None
        profiler = getattr(self.engine, "profiler", None)
        if sp is not None and profiler is not None:
            profiler.register(sp)

        priority = self._priority_class()

        async def pump():
            detok = StreamingDetokenizer(self.tokenizer)
            try:
                async for event in self.engine.stream(self._prompt_ids(prompt, system),
                                                      self._sampling(max_tokens, temperature),
                                                      deadline_s=deadline_s,
                                                      priority=priority):
                    if event.type == "token":
                        delta = detok.push(event.token_id)
                        if delta:
                            sync_q.put(delta)
                    elif event.type == "final":
                        tail = detok.flush()
                        if tail:
                            sync_q.put(tail)
                        if sp is not None and event.result is not None:
                            record_engine_spans(event.result, parent=sp.context)
                            sp.set_attr("finish_reason", event.result.finish_reason)
            except Exception as exc:  # noqa: BLE001 - errors travel as text
                # (the JAX pump has no handler: a refused submission, such
                # as a dead driver's, left the consumer waiting forever)
                logger.error("InProcessLLM stream error: %s", exc)
                sync_q.put(f"Error: {exc}")
            finally:
                sync_q.put(None)

        import queue as _queue

        sync_q: "_queue.Queue[str | None]" = _queue.Queue()
        asyncio.run_coroutine_threadsafe(pump(), loop)
        try:
            while True:
                delta = sync_q.get()
                if delta is None:
                    return
                if on_text:
                    on_text(delta)
                yield delta
        finally:
            if sp is not None:
                if profiler is not None:
                    profiler.unregister(sp)
                sp.finish()


class HTTPLLM:
    """OpenAI-compatible HTTP client (split deployments; also exactly what
    the reference's two clients did, unified), on ``urllib``: the same
    payloads, breaker and error texts as the JAX client's ``requests``
    calls."""

    def __init__(self, endpoint: str | None = None, model: str | None = None,
                 timeout: float = 60.0) -> None:
        s = get_settings()
        self.endpoint = (endpoint or s.qwen_endpoint).rstrip("/")
        self.model = model or s.qwen_model
        self.timeout = timeout

    def _payload(self, prompt, system, max_tokens, temperature, stream: bool) -> dict:
        from githubrepostorag_tpu_torch.resilience.policy import current_priority

        s = get_settings()
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        payload = {
            "model": self.model,
            "messages": messages,
            "max_completion_tokens": max_tokens or s.qwen_max_output,
            "temperature": s.qwen_temperature if temperature is None else temperature,
            "top_p": s.qwen_top_p,
        }
        if stream:
            payload["stream"] = True
        if current_priority():
            payload["priority"] = current_priority()
        return payload

    def _post(self, payload: dict):
        """POST the payload to /v1/chat/completions; raises on a non-2xx
        status, as ``requests``' ``raise_for_status`` does."""
        import urllib.request

        req = urllib.request.Request(
            f"{self.endpoint}/v1/chat/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    def complete(self, prompt, *, system=None, max_tokens=None, temperature=None) -> str:
        gate = _llm_preamble()
        if gate is not None:
            return gate
        # per-dependency breaker: a flapping endpoint fails fast (and shows
        # DOWN in /health) instead of stacking request timeouts
        breaker = get_breaker("llm.http")
        if not breaker.allow():
            return "Error: circuit llm.http is open (endpoint failing; backing off)"
        payload = self._payload(prompt, system, max_tokens, temperature, stream=False)
        try:
            with self._post(payload) as resp:
                text = json.loads(resp.read())["choices"][0]["message"]["content"]
        except Exception as exc:  # noqa: BLE001 - errors travel as text
            breaker.record_failure()
            logger.error("HTTPLLM error: %s", exc)
            return f"Error: {exc}"
        breaker.record_success()
        return _postprocess(prompt, text)

    def stream_complete(self, prompt, *, system=None, max_tokens=None,
                        temperature=None, on_text=None) -> Iterator[str]:
        payload = self._payload(prompt, system, max_tokens, temperature, stream=True)
        try:
            with self._post(payload) as resp:
                for raw in resp:
                    line = raw.decode("utf-8").strip()
                    if not line or not line.startswith("data: "):
                        continue
                    data = line[len("data: "):]
                    if data == "[DONE]":
                        return
                    delta = json.loads(data)["choices"][0].get("delta", {}).get("content")
                    if delta:
                        if on_text:
                            on_text(delta)
                        yield delta
        except Exception as exc:  # noqa: BLE001
            logger.error("HTTPLLM stream error: %s", exc)
            yield f"Error: {exc}"

    def complete_batch(self, prompts: Sequence[str], *, system=None,
                       max_tokens=None, temperature=None) -> list[str]:
        """Concurrent fan-out so split deployments keep the server's
        continuous batch full instead of serializing per-chunk requests."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(16, max(1, len(prompts)))) as pool:
            return list(
                pool.map(
                    lambda p: self.complete(p, system=system, max_tokens=max_tokens,
                                            temperature=temperature),
                    prompts,
                )
            )


def get_llm(on_build: Callable[[], tuple] | None = None) -> LLM:
    """Build the configured backend (LLM_BACKEND: inprocess | http | fake).

    ``inprocess`` needs an engine+tokenizer; deployments construct those at
    startup and call set_llm().  This factory covers http/fake and raises a
    clear error otherwise."""
    backend = get_settings().llm_backend.lower()
    if backend == "fake":
        return FakeLLM()
    if backend == "http":
        return HTTPLLM()
    raise RuntimeError(
        "LLM_BACKEND=inprocess requires explicit wiring (engine + tokenizer); "
        "call set_llm(InProcessLLM(...)) at service startup"
    )


_llm: LLM | None = None


def get_shared_llm() -> LLM:
    global _llm
    if _llm is None:
        _llm = get_llm()
    return _llm


def set_llm(llm: LLM | None) -> None:
    global _llm
    _llm = llm
