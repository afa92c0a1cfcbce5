"""Prometheus metrics shared across the API, worker and retrieval path;
port of ``githubrepostorag_tpu/metrics.py`` on the standard library.

The JAX package registers its series with ``prometheus_client``.  The port
keeps its own ``Counter`` / ``Gauge`` / ``Histogram`` with the same
``labels(...)``, ``inc`` / ``dec`` / ``set`` / ``observe`` surface, and
``render()`` writes them in the Prometheus text format (version 0.0.4)
for ``GET /metrics``, the families and samples ``prometheus_client``
writes for the same series (its ``_created`` samples left out).  The series
are the ones the port's layers touch -- the API, worker, resilience,
LLM and retrieval series -- with the JAX package's names, label names,
help text and buckets.  Of the engine-owned series, the speculative,
preemption and KV-tier ones are here (``serving/async_engine.py`` exports
them), and the two that ``MeteredLLM`` observes with ``replica="api"``;
the engine driver's own (running / waiting, TTFT, TPOT, decode tokens)
and the observability planes' (compiles, stall, ledger, SLO, page
observatory, profiler samples, timeline) are here too, and the fleet's
(router decisions, lifecycle and role gauges, controller actions, the
prefill / decode handoffs), and the MoE block's assignment and drop
counts (``models/moe.py``, ``MOE_DROP_STATS=1``).  ``counter_value`` and ``histogram_stats``
read the series back (tests, the health report, the chip script).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Iterator

# prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75, 1.0, 2.5, 5.0, 7.5, 10.0)


class _Value:
    """One labelled child: a float under the metric's lock."""

    __slots__ = ("_metric", "value")

    def __init__(self, metric: "_Metric") -> None:
        self._metric = metric
        self.value = 0.0


class _CounterChild(_Value):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._metric._lock:
            self.value += amount


class _GaugeChild(_Value):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._metric._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._metric._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._metric._lock:
            self.value -= amount


class _HistogramChild:
    __slots__ = ("_metric", "counts", "sum", "count")

    def __init__(self, metric: "Histogram") -> None:
        self._metric = metric
        self.counts = [0] * (len(metric.buckets) + 1)  # the last is +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._metric.buckets, value)
        with self._metric._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


REGISTRY: list["_Metric"] = []


class _Metric:
    _child = _Value
    kind = "untyped"

    def __init__(self, name: str, documentation: str, labelnames=()) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        REGISTRY.append(self)

    def labels(self, *values, **labels):
        """The child of one label set, by position or by name."""
        if values:
            if labels or len(values) != len(self.labelnames):
                raise ValueError(f"{self.name}: labels {values} != {list(self.labelnames)}")
            labels = dict(zip(self.labelnames, values))
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != {list(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child(self)
        return child

    def children(self, **labels) -> list:
        """Every child whose labels include ``labels``."""
        want = {k: str(v) for k, v in labels.items()}
        with self._lock:
            items = list(self._children.items())
        return [c for key, c in items
                if all(dict(zip(self.labelnames, key)).get(k) == v for k, v in want.items())]

    def _unlabelled(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {list(self.labelnames)}: use labels()")
        return self.labels()

    def samples(self) -> list[tuple[str, tuple[tuple[str, str], ...], float]]:
        """(sample name, labels, value) in exposition order.  A metric
        without labels always has its one sample, as prometheus_client
        writes it."""
        if not self.labelnames:
            self._unlabelled()
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for key, child in items:
            out.extend(self._child_samples(tuple(zip(self.labelnames, key)), child))
        return out

    def _child_samples(self, labels, child):
        return [(self.name, labels, child.value)]


class Counter(_Metric):
    _child = _CounterChild
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)


class Gauge(_Metric):
    _child = _GaugeChild
    kind = "gauge"

    def set(self, value: float) -> None:
        self._unlabelled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabelled().dec(amount)


class Histogram(_Metric):
    """Bucket counts (upper bounds ``buckets``, then +Inf), sum and count."""

    _child = _HistogramChild
    kind = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 buckets=DEFAULT_BUCKETS) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, documentation, labelnames)

    def observe(self, value: float) -> None:
        self._unlabelled().observe(value)

    def _child_samples(self, labels, child):
        out, total = [], 0
        for bound, n in zip(self.buckets + (math.inf,), child.counts):
            total += n
            out.append((self.name + "_bucket", labels + (("le", _number(bound)),), total))
        out.append((self.name + "_count", labels, child.count))
        out.append((self.name + "_sum", labels, child.sum))
        return out


def _number(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    return repr(float(value))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def render() -> bytes:
    """Every series in the Prometheus text format."""
    lines = []
    for metric in REGISTRY:
        family = metric.name
        doc = metric.documentation.replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {family} {doc}")
        lines.append(f"# TYPE {family} {metric.kind}")
        for name, labels, value in metric.samples():
            label_text = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
            lines.append(f"{name}{{{label_text}}} {_number(value)}" if labels
                         else f"{name} {_number(value)}")
    return ("\n".join(lines) + "\n").encode("utf-8")


def counter_value(metric: _Metric, **labels) -> float:
    """A Counter's or Gauge's value summed over every label set that
    includes ``labels`` (a partial label set aggregates the rest)."""
    return sum(c.value for c in metric.children(**labels))


def histogram_stats(metric: Histogram, **labels) -> dict:
    """``{"count", "sum"}`` of a Histogram over the matching label sets."""
    kids = metric.children(**labels)
    return {"count": sum(c.count for c in kids), "sum": sum(c.sum for c in kids)}


HTTP_REQUESTS = Counter(
    "rag_api_requests_total", "API requests", ["method", "path", "status"]
)
HTTP_LATENCY = Histogram(
    "rag_api_request_seconds", "API request latency", ["method", "path"]
)
JOBS_TOTAL = Counter("rag_jobs_total", "RAG jobs processed", ["status"])
JOB_DURATION = Histogram(
    "rag_job_seconds", "RAG job wall-clock",
    buckets=(0.5, 1, 2, 5, 10, 30, 60, 120, 300),
)
LLM_CALLS = Counter("rag_llm_calls_total", "LLM completions", ["status"])
LLM_LATENCY = Histogram("rag_llm_call_seconds", "LLM completion latency")
RETRIEVAL_HITS = Histogram(
    "rag_retrieval_hits", "Docs returned per retrieval",
    buckets=(0, 1, 2, 3, 5, 8, 10, 20),
)
RETRIEVAL_SECONDS = Histogram(
    "rag_retrieval_seconds",
    "Per-request retrieval latency through the coalescer (queue + encode + search)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
)
RETRIEVAL_WAVE_SIZE = Histogram(
    "rag_retrieval_wave_size",
    "Queries coalesced into one encoder forward + search dispatch",
    buckets=(1, 2, 4, 8, 16, 32),
)
DEVICE_INDEX_SEARCHES = Counter(
    "rag_device_index_searches_total",
    "Vector searches by execution path (device = fused on-accelerator top-k, "
    "fallback = host store outside the warmed bucket contract)",
    ["path"],
)
# --- Live device index (ingest/stream.py + retrieval/live_index.py +
# retrieval/device_index.py): fragmentation gauges the background
# compactor triggers on, watermark/lag gauges the apply loop publishes,
# and the full-sync counter tests pin at zero on the churn hot path.
INDEX_LIVE_ROWS = Gauge(
    "rag_index_live_rows",
    "Live (non-tombstoned) rows mirrored per device-index table",
    ["table"],
)
INDEX_HOLES = Gauge(
    "rag_index_tombstoned_holes",
    "Tombstoned hole rows awaiting compaction per device-index table",
    ["table"],
)
INDEX_CAPACITY = Gauge(
    "rag_index_capacity_rows",
    "Allocated capacity-bucket rows per device-index table",
    ["table"],
)
INDEX_COMPACTIONS = Counter(
    "rag_index_compactions_total",
    "In-place hole-reclaim compactions per device-index table "
    "(warmed gather repack, same capacity bucket)",
    ["table"],
)
INDEX_FULL_SYNCS = Counter(
    "rag_index_full_syncs_total",
    "Whole-table transpose re-puts of a device-index corpus (initial "
    "seeding and capacity growth; must NOT happen on the churn hot path)",
    ["table"],
)
INDEX_WATERMARK = Gauge(
    "rag_index_watermark",
    "Mutation-stream watermark by scope: kind=appended is the producers' "
    "log head, kind=applied is the seq the live index has absorbed",
    ["scope", "kind"],
)
INDEX_APPLY_LAG = Gauge(
    "rag_index_apply_lag_ops",
    "Appended-minus-applied mutation ops per scope (stream backlog)",
    ["scope"],
)
INDEX_OPS_APPLIED = Counter(
    "rag_index_ops_applied_total",
    "Mutation ops the live-index apply loop drained into the store",
    ["table", "kind"],
)
# MeteredLLM's API-side observations (replica="api") and the engine
# driver's (its replica)
TTFT = Histogram(
    "rag_ttft_seconds", "Time to first generated token", ["replica"],
    buckets=(0.1, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0),
)
DECODE_TOKENS = Counter("rag_decode_tokens_total", "Generated tokens", ["replica"])
# the engine's speculative, preemption and host-tier series, exported by
# serving/async_engine.py after each step
SPEC_PROPOSED = Counter(
    "rag_spec_draft_tokens_total", "Speculative draft tokens proposed", ["replica"])
SPEC_ACCEPTED = Counter(
    "rag_spec_accepted_tokens_total",
    "Speculative draft tokens the model accepted and committed",
    ["replica"],
)
SPEC_PROPOSED_TOTAL = Counter(
    "rag_spec_proposed_total",
    "Draft tokens proposed by the speculative decoder (n-gram or draft model)",
    ["replica"],
)
SPEC_ACCEPTED_TOTAL = Counter(
    "rag_spec_accepted_total",
    "Proposed draft tokens the target model accepted and committed",
    ["replica"],
)
SPEC_FALLBACKS = Counter(
    "rag_spec_fallbacks_total",
    "Requests the adaptive controller demoted from speculative to plain "
    "decode, by reason (acceptance collapse / deadline pressure)",
    ["replica", "reason"],
)
SPEC_ACCEPTANCE = Histogram(
    "rag_spec_acceptance_ratio",
    "Per-request draft acceptance ratio (accepted / proposed) at completion",
    ["replica"],
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
)
ENGINE_PREEMPTIONS = Counter(
    "rag_engine_preemptions_total",
    "Batch-class victims parked to the KV host tier so protected-class "
    "admission could proceed (serving/engine.py preempt-to-host)",
    ["replica"],
)
ENGINE_PREEMPT_RESUMES = Counter(
    "rag_engine_preempt_resumes_total",
    "Parked victims re-admitted via prefix share + fault-in (decode "
    "continues token-identically, no recomputed prompt prefill)",
    ["replica"],
)
KV_TIER_DEVICE_PAGES = Gauge(
    "rag_kv_tier_device_free_pages",
    "Allocatable device KV pages (free list + evictable cached pages)",
    ["replica"],
)
KV_TIER_HOST_PAGES = Gauge(
    "rag_kv_tier_host_pages",
    "KV pages resident in the host-RAM swap tier (by chain hash)",
    ["replica"],
)
KV_FAULT_INS = Counter(
    "rag_kv_tier_fault_ins_total",
    "Prefix pages re-admitted host->device instead of recomputed",
    ["replica"],
)
KV_WRITEBACKS = Counter(
    "rag_kv_tier_writebacks_total",
    "Cold device pages saved device->host at step boundaries",
    ["replica"],
)
KV_DEDUP_HITS = Counter(
    "rag_kv_tier_dedup_hits_total",
    "share() hits on pages other concurrent requests actively hold "
    "(cross-user prefix-page dedup)",
    ["replica"],
)
KV_DEDUP_HOLDS = Counter(
    "rag_kv_tier_dedup_holds_total",
    "Admissions held one registration for an identical prefix mid-prefill "
    "instead of duplicating its footprint",
    ["replica"],
)
KV_MIGRATION_SECONDS = Histogram(
    "rag_kv_tier_migration_seconds",
    "Per-step host time spent planning/dispatching/landing page migration "
    "(writeback gathers + fault-in scatters)",
    ["replica"],
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1),
)
WORKER_DEQUEUE_ERRORS = Counter(
    "rag_worker_dequeue_errors_total",
    "queue.dequeue() failures survived by the worker's backoff loop",
)
JOBS_SHED = Counter(
    "rag_jobs_shed_total",
    "Jobs rejected with 429 by the bounded-queue admission check",
)
JOBS_IN_FLIGHT = Gauge("rag_jobs_in_flight", "Jobs currently executing in this worker")
EVENT_EMIT_DROPS = Counter(
    "rag_bus_emit_drops_total",
    "Progress events dropped after the supervised emit exhausted retries",
    ["event"],
)
BUS_RECONNECTS = Counter(
    "rag_bus_reconnects_total",
    "SSE subscriber re-subscribes after a bus connection loss",
)
FAULTS_INJECTED = Counter(
    "rag_faults_injected_total",
    "Faults fired by the FAULTS injection registry",
    ["site", "action"],
)
BREAKER_TRANSITIONS = Counter(
    "rag_breaker_transitions_total",
    "Circuit breaker state transitions",
    ["dep", "to_state"],
)
ADMISSION_FAILOPEN = Counter(
    "rag_admission_failopen_total",
    "Admission decisions that failed open (the SLO-plane provider raised "
    "or returned garbage; the request was accepted anyway)",
)

# the engine driver's own series and the observability planes' (obs/):
# the step profiler, the token ledger, the SLO monitor, the page
# observatory, the continuous profiler and the timeline
XLA_COMPILES = Counter(
    "rag_xla_compiles_total",
    "Work the card ran for the first time during live engine stepping: a "
    "kernel build or load, a new kernel launch plan, a dispatch shape warmup "
    "did not run (warmup should make this zero; see obs/engine_profile.py)",
    ["replica"],
)
ENGINE_RUNNING = Gauge("rag_engine_running_seqs", "Sequences in the decode batch", ["replica"])
ENGINE_WAITING = Gauge("rag_engine_waiting_seqs", "Queued requests", ["replica"])
PREFIX_CACHE_HITS = Counter(
    "rag_prefix_cache_hit_tokens_total",
    "Prompt tokens served from the KV prefix cache instead of prefill",
    ["replica"],
)
ENGINE_WAITING = Gauge("rag_engine_waiting_seqs", "Queued requests", ["replica"])
PREFIX_CACHE_HITS = Counter(
    "rag_prefix_cache_hit_tokens_total",
    "Prompt tokens served from the KV prefix cache instead of prefill",
    ["replica"],
)
TPOT = Histogram(
    "rag_engine_tpot_seconds",
    "Time per output token after the first (decode seconds / decode tokens)",
    ["replica"],
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)
SCHED_STALL = Gauge(
    "rag_engine_sched_stall_seconds",
    "Gap between consecutive engine steps while work exists "
    "(scheduler stall; 0 when idle)",
    ["replica"],
)
LEDGER_GOODPUT = Gauge(
    "rag_engine_goodput_tokens_per_s",
    "Rolling committed-token throughput over the ledger window",
    ["replica"],
)
LEDGER_MFU = Gauge(
    "rag_engine_mfu_ratio",
    "Rolling model FLOPs utilization: (committed+prefill tokens) x "
    "flops/token over elapsed x peak chip FLOPs",
    ["replica"],
)
LEDGER_LIMITER = Gauge(
    "rag_engine_limiter",
    "One-hot windowed bottleneck attribution "
    "(hbm_pages | stall | compile | swap_wait | kv_transfer | none)",
    ["replica", "limiter"],
)
LEDGER_STEP_SECONDS = Counter(
    "rag_engine_step_seconds_total",
    "Engine step wall time classified into phase buckets (prefill | decode "
    "| spec_verify | kv_migration | kv_transfer | sched_stall | compile)",
    ["replica", "bucket"],
)
LEDGER_TOKENS = Counter(
    "rag_engine_tokens_total",
    "Token outcomes: committed | spec_rejected | deadline_reaped",
    ["replica", "outcome"],
)
ENGINE_FUSED_STEPS = Counter(
    "rag_engine_fused_steps_total",
    "Engine steps served by the single-dispatch fused program "
    "(packed prefill + mixed spec/plain decode — serving/fused_step.py)",
    ["replica"],
)
ENGINE_STEP_DISPATCHES = Gauge(
    "rag_engine_step_dispatches",
    "Rolling main-model programs dispatched per engine step (1.0 = every "
    "step fused into one program; the unfused mixed path issues 2+)",
    ["replica"],
)
SLO_BURN = Gauge(
    "rag_slo_burn_rate",
    "Error-budget burn rate per objective/class over each rolling window",
    ["replica", "objective", "klass", "window"],
)
SLO_STATE = Gauge(
    "rag_slo_state",
    "SLO state machine per objective/class: 0=ok 1=warn 2=critical",
    ["replica", "objective", "klass"],
)
SLO_TRANSITIONS = Counter(
    "rag_slo_state_transitions_total",
    "SLO state machine transitions, labeled by the state entered",
    ["replica", "objective", "klass", "state"],
)
HBM_HELD_PAGES = Gauge(
    "rag_hbm_held_pages",
    "Refcount claims currently held on device pages per replica (each "
    "block-table listing is one claim; the page observatory integrates "
    "this over time into page-seconds)",
    ["replica"],
)
HBM_PAGE_SECONDS = Counter(
    "rag_hbm_page_seconds_total",
    "Page-seconds attributed to finished requests per replica and "
    "priority class (the memory analogue of the token ledger)",
    ["replica", "priority"],
)
PROFILE_SAMPLES = Counter(
    "rag_profile_samples_total",
    "Continuous-profiler step samples captured into the ring per replica",
    ["replica"],
)
TIMELINE_EXPORTS = Counter(
    "rag_timeline_exports_total",
    "Perfetto timeline builds served (/debug/timeline + bench dumps)",
)
TIMELINE_EVENTS_DROPPED = Counter(
    "rag_timeline_events_dropped_total",
    "Trace events dropped by the timeline_max_events cap across exports",
)
# the fleet: the router (serving/multi_engine.py), the controller
# (serving/controller.py) and the prefill / decode split (serving/disagg.py)
ROUTER_DECISIONS = Counter(
    "rag_router_decisions_total",
    "Fleet router outcomes: affinity_hit / affinity_miss / "
    "skipped_breaker_open / skipped_limiter",
    ["decision"],
)
ROUTER_PREFIX_PAGES = Counter(
    "rag_router_prefix_pages_total",
    "Prefix pages the router matched against the chosen replica's digest, "
    "by tier the match came from",
    ["replica", "tier"],
)
ROUTER_ROUTED = Counter(
    "rag_router_routed_total",
    "Requests routed to each replica",
    ["replica"],
)
FLEET_LIFECYCLE = Gauge(
    "rag_fleet_replica_lifecycle",
    "Replica lifecycle: 0=active 1=draining 2=drained 3=spare",
    ["replica"],
)
CTRL_ACTIONS = Counter(
    "rag_ctrl_actions_total",
    "Fleet-controller remediation actions executed, by action ladder rung "
    "(failover / grow_host_pool / spec_k_down / spread_affinity) and the "
    "sensed reason that justified it",
    ["action", "reason"],
)
CTRL_FAILOPEN = Counter(
    "rag_ctrl_failopen_total",
    "Controller-internal exceptions survived by failing open (the tick or "
    "action was abandoned, the fleet kept serving; a rising rate means the "
    "controller is observe-only in practice)",
)
CTRL_SUPPRESSED = Counter(
    "rag_ctrl_suppressed_total",
    "Controller decisions withheld by a guard: hysteresis (ticks not yet "
    "agreeing), cooldown, action-window budget, or an in-flight action on "
    "the same replica",
    ["guard"],
)
FLEET_ROLE = Gauge(
    "rag_fleet_replica_role",
    "Replica serving role under disaggregation: 0=fused 1=prefill 2=decode",
    ["replica"],
)
DISAGG_HANDOFFS = Counter(
    "rag_disagg_handoffs_total",
    "Prefill->decode handoff attempts by outcome: shipped (KV landed on a "
    "decode replica and the request resumed there) or fallback_<reason> "
    "(finished fused on the prefill replica)",
    ["outcome"],
)
DISAGG_PAGES = Counter(
    "rag_disagg_pages_total",
    "KV pages on the handoff path: shipped (packed + transferred) or "
    "deduped (decode replica already held the content hash — zero bytes "
    "moved)",
    ["kind"],
)
DISAGG_TRANSFER_SECONDS = Counter(
    "rag_disagg_transfer_seconds_total",
    "Host wall time packing/unpacking handoff payloads per replica "
    "(the ledger charges the same time to its kv_transfer bucket)",
    ["replica"],
)

MOE_ASSIGNMENTS = Counter(
    "rag_moe_expert_assignments_total",
    "MoE router token->expert assignments offered (MOE_DROP_STATS=1)",
)
MOE_DROPPED = Counter(
    "rag_moe_dropped_assignments_total",
    "MoE assignments dropped by expert capacity (MOE_DROP_STATS=1)",
)


class MeteredLLM:
    """LLM wrapper recording call counts + latency (worker.py:73-88), and a
    ``llm.complete``/``llm.stream`` span per call when a trace is active."""

    def __init__(self, inner) -> None:
        self._inner = inner

    def complete(self, prompt, **kw) -> str:
        from githubrepostorag_tpu_torch.obs.trace import span as trace_span

        with trace_span("llm.complete", prompt_chars=len(prompt)) as sp:
            start = time.monotonic()
            text = self._inner.complete(prompt, **kw)
            LLM_LATENCY.observe(time.monotonic() - start)
            status = "error" if text.startswith("Error:") else "ok"
            LLM_CALLS.labels(status=status).inc()
            if status != "ok":
                sp.set_status("error: llm")
            sp.set_attr("completion_chars", len(text))
        return text

    def complete_batch(self, prompts, **kw) -> list[str]:
        from githubrepostorag_tpu_torch.obs.trace import span as trace_span

        batch = getattr(self._inner, "complete_batch", None)
        with trace_span("llm.complete_batch", batch_size=len(prompts)) as sp:
            start = time.monotonic()
            if callable(batch):
                out = batch(prompts, **kw)
            else:
                out = [self._inner.complete(p, **kw) for p in prompts]
            LLM_LATENCY.observe(time.monotonic() - start)
            errors = 0
            for text in out:
                bad = text.startswith("Error:")
                errors += bad
                LLM_CALLS.labels(status="error" if bad else "ok").inc()
            if errors:
                sp.set_status("error: llm")
                sp.set_attr("errors", errors)
        return out

    def stream_complete(self, prompt, **kw) -> Iterator[str]:
        from githubrepostorag_tpu_torch.obs.trace import current_context
        from githubrepostorag_tpu_torch.obs.trace import Span as TraceSpan

        # a generator's body runs lazily on the consumer's schedule, so the
        # span is managed by hand (opened under the caller's context at
        # first pull) instead of via the contextmanager
        ctx = current_context()
        sp = TraceSpan("llm.stream", ctx) if ctx is not None and ctx.sampled else None
        start = time.monotonic()
        first = True
        status = "ok"
        deltas = 0
        try:
            for delta in self._inner.stream_complete(prompt, **kw):
                if first:
                    TTFT.labels(replica="api").observe(time.monotonic() - start)
                    first = False
                if delta.startswith("Error:"):
                    # backends yield errors as text, never raise -- an
                    # "Error:" delta IS the failure signal
                    status = "error"
                deltas += 1
                DECODE_TOKENS.labels(replica="api").inc()
                yield delta
        except GeneratorExit:
            status = "cancelled"  # consumer closed the stream early
            raise
        except BaseException:
            status = "error"
            raise
        finally:
            LLM_LATENCY.observe(time.monotonic() - start)
            LLM_CALLS.labels(status=status).inc()
            if sp is not None:
                sp.set_attr("deltas", deltas)
                if status != "ok":
                    sp.set_status(f"error: stream {status}")
                sp.finish()
