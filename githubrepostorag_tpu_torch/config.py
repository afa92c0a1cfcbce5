"""Settings of the port's model server, retrieval path and RAG service;
port of the matching parts of ``githubrepostorag_tpu/config.py``.

The fields are the ones the port reads: ``serving/__main__.py``
(checkpoint, engine geometry and options, the MoE expert capacity),
``serving/openai_api.py``
(the default priority class), ``serving/tokenizer.py`` (the tokenizer
backend), the retrieval path: ``embedding.py`` (the encoder),
``store/factory.py`` (the store chain and its backends), ``retrieval/retrievers.py`` (the
scope tables), and the question-answering loop: ``llm.py`` (the backend
and its sampling defaults), ``agent/`` (the loop's budgets),
``events/``, ``worker/`` and ``api/`` (jobs, queue bound, SSE, the Redis
URL of the split deployment, the worker pod's metrics port),
``resilience/`` (retries, breakers, ``FAULTS``), ``obs/`` (traces,
the log format, the step profiler's ring, the SLO objectives and burn
rates, the ledger's window and MFU denominator, the timeline), ``ingest/`` (GitHub, branch and collection, DEV_MODE,
the Pushgateway, ``EXTENSION_TO_LANGUAGE``) and the fleet (``MESH_SHAPE``'s
axes, the router's ``ROUTE_*``, ``FLEET_SPARES``, the controller's
``CTRL_*``, the prefill / decode split's ``DISAGG_*``), and the
sequence-parallel ring (``SP_PREFILL_THRESHOLD``, ``SP_RING_*``).  Each
reads the same environment variable, with the same default and parser, as
the JAX package's field of the same name, so a pod spec carries over
unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return str(val).strip().lower() in {"1", "true", "t", "yes", "y", "on"}


def _parse_quant_bits() -> int:
    """QUANTIZE_WEIGHTS -> bit width (0 = off).  Raises on typos rather
    than silently loading full-precision weights."""
    raw = os.environ.get("QUANTIZE_WEIGHTS", "")
    val = str(raw).strip().lower()
    if val in {"", "0", "false", "f", "no", "n", "off"}:
        return 0
    if val in {"1", "true", "t", "yes", "y", "on", "int8", "8"}:
        return 8
    if val in {"int4", "4", "awq"}:
        return 4
    raise ValueError(
        f"QUANTIZE_WEIGHTS={raw!r} not understood; use int4, int8, or a boolean"
    )


def _parse_kv_quant() -> int:
    """KV_QUANT -> page bit width (0 = full precision, 8 = int8, 4 = int4
    nibble-packed pages).  Typos raise rather than silently serving
    full-precision pages."""
    raw = os.environ.get("KV_QUANT", "")
    val = str(raw).strip().lower()
    if val in {"", "0", "false", "f", "no", "n", "off"}:
        return 0
    if val in {"1", "true", "t", "yes", "y", "on", "int8", "8"}:
        return 8
    if val in {"int4", "4"}:
        return 4
    raise ValueError(
        f"KV_QUANT={raw!r} not understood; use int4, int8, or a boolean"
    )


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env(name: str, default: str):
    return field(default_factory=lambda: os.getenv(name, default))


def _int(name: str, default: int):
    return field(default_factory=lambda: _env_int(name, default))


def _float(name: str, default: float):
    return field(default_factory=lambda: _env_float(name, default))


def _bool(name: str, default: bool):
    return field(default_factory=lambda: _env_bool(name, default))


@dataclass(frozen=True)
class Settings:
    """The model server's knobs, read from the environment when built."""

    log_level: str = _env("LOG_LEVEL", "INFO")
    # json (trace-stamped structured lines) | plain (human format)
    log_format: str = _env("LOG_FORMAT", "json")

    # --- event bus and job queue (events/, worker/, api/) ---
    # the split deployment's bus, cancel flags and queue (api --redis, worker)
    redis_url: str = _env("REDIS_URL", "redis://redis-master:6379/0")
    sse_ping_seconds: int = _int("SSE_PING_SECONDS", 15)
    # API-side SSE heartbeat: a ``: heartbeat`` comment whenever the bus
    # stream stays silent this long
    sse_heartbeat_seconds: float = _float("SSE_HEARTBEAT_SECONDS", 15.0)
    # POST /rag/jobs sheds with 429 + Retry-After at this many queued jobs
    job_queue_max_depth: int = _int("JOB_QUEUE_MAX_DEPTH", 256)
    default_namespace: str = _env("DEFAULT_NAMESPACE", "default")
    # the worker pod's /metrics (python -m githubrepostorag_tpu_torch.worker)
    metrics_port: int = _int("METRICS_PORT", 9000)
    worker_max_jobs: int = _int("WORKER_MAX_JOBS", 10)
    job_timeout_seconds: int = _int("JOB_TIMEOUT_SECONDS", 300)
    keep_result_seconds: int = _int("KEEP_RESULT_SECONDS", 3600)

    # --- resilience (resilience/) ---
    # jittered exponential backoff: delay(n) = uniform(d/2, d),
    # d = min(cap, base * 2^n)
    retry_max_attempts: int = _int("RETRY_MAX_ATTEMPTS", 4)
    retry_base_seconds: float = _float("RETRY_BASE_SECONDS", 0.05)
    retry_cap_seconds: float = _float("RETRY_CAP_SECONDS", 2.0)
    # per-dependency breakers: open after N consecutive failures, probe
    # again after reset_seconds
    breaker_failure_threshold: int = _int("BREAKER_FAILURE_THRESHOLD", 5)
    breaker_reset_seconds: float = _float("BREAKER_RESET_SECONDS", 30.0)
    # fault injection spec, e.g. "llm.complete:delay=2;bus.emit:drop@3"
    faults: str = _env("FAULTS", "")
    faults_seed: int = _int("FAULTS_SEED", 0)

    # --- the agent loop (agent/) ---
    max_rag_attempts: int = _int("MAX_RAG_ATTEMPTS", 3)
    router_top_k: int = _int("ROUTER_TOP_K", 5)
    # architecture-class questions read the assembled repo as one prompt
    agent_longctx: bool = _bool("AGENT_LONGCTX", True)
    # 0 = the context window minus QWEN_MAX_OUTPUT (retrieval/assembler.py)
    longctx_token_budget: int = _int("LONGCTX_TOKEN_BUDGET", 0)

    # --- the LLM backend (llm.py) ---
    llm_backend: str = _env("LLM_BACKEND", "inprocess")  # inprocess|http|fake
    qwen_endpoint: str = _env("QWEN_ENDPOINT", "http://qwen:8000")  # LLM_BACKEND=http
    qwen_max_output: int = _int("QWEN_MAX_OUTPUT", 4096)
    qwen_temperature: float = _float("QWEN_TEMPERATURE", 0.7)
    qwen_top_p: float = _float("QWEN_TOP_P", 0.9)

    # --- traces (obs/) ---
    # sampling rate [0, 1]; 0 creates no root span at all
    trace_sample: float = _float("TRACE_SAMPLE", 1.0)
    # the flight recorder's ring bounds
    trace_max_traces: int = _int("TRACE_MAX_TRACES", 256)
    trace_max_spans: int = _int("TRACE_MAX_SPANS", 128)

    # --- checkpoint and the served model ---
    qwen_model: str = _env("QWEN_MODEL", "Qwen/Qwen2.5-3B-Instruct")  # /v1/models id
    model_weights_path: str = _env("MODEL_WEIGHTS_PATH", "")  # local HF checkpoint dir
    # weight-only quantization at load: 0 off, 8 int8, 4 int4 (AWQ class)
    quantize_weights: int = field(default_factory=_parse_quant_bits)
    # "native" = the in-tree byte-level BPE (serving/bpe_native.py) when the
    # checkpoint has a tokenizer.json; "hf" = transformers AutoTokenizer
    tokenizer_backend: str = _env("TOKENIZER_BACKEND", "native")

    # --- engine geometry (page_size x num_pages = KV token capacity) ---
    context_window: int = _int("CONTEXT_WINDOW", 11712)
    kv_page_size: int = _int("KV_PAGE_SIZE", 128)
    kv_num_pages: int = _int("KV_NUM_PAGES", 256)
    max_num_seqs: int = _int("MAX_NUM_SEQS", 64)
    prefill_chunk: int = _int("PREFILL_CHUNK", 512)
    # >0: token-budget packed prefill (Engine.prefill_token_budget); 0 padded
    prefill_token_budget: int = _int("PREFILL_TOKEN_BUDGET", 0)
    prefix_caching: bool = _bool("PREFIX_CACHING", True)
    # quantized KV pages: 0 full precision, 8 int8, 4 int4
    kv_quant: int = field(default_factory=_parse_kv_quant)

    # --- priority classes ---
    # SLO class stamped on requests that arrive unlabeled
    priority_default_class: str = _env("PRIORITY_DEFAULT_CLASS", "interactive")
    # the class headroom reservations and preemption act for
    priority_protected_class: str = _env("PRIORITY_PROTECTED_CLASS", "interactive")

    # --- engine modes ---
    prefill_widths: int = _int("PREFILL_WIDTHS", 1)
    prefill_priority: bool = _bool("PREFILL_PRIORITY", False)
    # prompts at least this long prefill sequence-parallel over the mesh's
    # sp axis (serving/long_prefill.py).  An explicit 0 disables; unset, the
    # server derives a threshold whenever sp > 1
    # (serving/engine.derive_sp_prefill_threshold), so whether the variable
    # is set rides sp_prefill_threshold_set
    sp_prefill_threshold: int = _int("SP_PREFILL_THRESHOLD", 0)
    sp_prefill_threshold_set: bool = field(
        default_factory=lambda: os.environ.get("SP_PREFILL_THRESHOLD") is not None)
    # segment-packed ring prefill (one ring pass carries every waiting long
    # prompt that fits); off = one sequence a pass
    sp_ring_pack: bool = _bool("SP_RING_PACK", True)
    # ring widths kept in the ladder, widest down; 0 = the whole ladder
    sp_ring_buckets: int = _int("SP_RING_BUCKETS", 0)
    spec_ngram_k: int = _int("SPEC_NGRAM_K", 0)
    spec_burst_iters: int = _int("SPEC_BURST_ITERS", 0)
    fused_step: bool = _bool("FUSED_STEP", False)
    spec_k: int = _int("SPEC_K", 4)
    spec_iters: int = _int("SPEC_ITERS", 4)
    spec_accept_floor: float = _float("SPEC_ACCEPT_FLOOR", 0.35)
    spec_deadline_margin_s: float = _float("SPEC_DEADLINE_MARGIN_S", 0.25)
    kv_tier: str = _env("KV_TIER", "auto")
    kv_host_pool_pages: int = _int("KV_HOST_POOL_PAGES", 0)
    kv_migrate_burst: int = _int("KV_MIGRATE_BURST", 8)
    preempt: str = _env("PREEMPT", "auto")
    preempt_headroom_pages: int = _int("PREEMPT_HEADROOM_PAGES", 0)
    # MoE expert capacity = ceil(K*T/E * factor); overflow assignments drop
    # that expert's contribution (models/moe.py; MOE_DROP_STATS=1 counts
    # them).  0 = exact no-drop dispatch, capacity T
    moe_capacity_factor: float = _float("MOE_CAPACITY_FACTOR", 2.0)

    # draft-model speculation: the draft's checkpoint dir (SPEC_K,
    # SPEC_ITERS, SPEC_ACCEPT_FLOOR, SPEC_DEADLINE_MARGIN_S tune it)
    spec_draft_model: str = _env("SPEC_DRAFT_MODEL", "")

    # --- observability planes (obs/) ---
    # continuous profiler: every Nth driver step lands in a bounded ring
    # (0 = off); PROFILE_RING samples are kept per replica
    profile_sample_every: int = _int("PROFILE_SAMPLE_EVERY", 32)
    profile_ring: int = _int("PROFILE_RING", 512)
    # /debug/timeline's default window and its event cap
    timeline_window_s: float = _float("TIMELINE_WINDOW_S", 120.0)
    timeline_max_events: int = _int("TIMELINE_MAX_EVENTS", 20000)
    # SLO objectives (ms) per priority class, and the longctx class's own
    slo_ttft_p50_ms: float = _float("SLO_TTFT_P50_MS", 1500.0)
    slo_ttft_p99_ms: float = _float("SLO_TTFT_P99_MS", 5000.0)
    slo_tpot_ms: float = _float("SLO_TPOT_MS", 100.0)
    slo_deadline_miss_budget: float = _float("SLO_DEADLINE_MISS_BUDGET", 0.05)
    slo_longctx_ttft_p50_ms: float = _float("SLO_LONGCTX_TTFT_P50_MS", 15000.0)
    slo_longctx_ttft_p99_ms: float = _float("SLO_LONGCTX_TTFT_P99_MS", 45000.0)
    slo_longctx_tpot_ms: float = _float("SLO_LONGCTX_TPOT_MS", 150.0)
    # "short,long" burn-rate windows (s) and the warn / critical burn rates
    slo_windows: str = _env("SLO_WINDOWS", "60,300")
    slo_burn_warn: float = _float("SLO_BURN_WARN", 6.0)
    slo_burn_critical: float = _float("SLO_BURN_CRITICAL", 14.4)
    # the token ledger's rolling window (goodput, MFU, limiter)
    slo_ledger_window_s: float = _float("SLO_LEDGER_WINDOW_S", 60.0)
    # FLOPs a token for MFU; 0 = ~2x the parameter count of the config
    model_flops_per_token: float = _float("MODEL_FLOPS_PER_TOKEN", 0.0)
    # the MFU denominator: the card's dense bf16 peak, 989 TFLOP/s on an
    # NVIDIA H100 80GB HBM3 at 700 W (the JAX package's default is a
    # TPU's, 197)
    chip_peak_tflops: float = _float("CHIP_PEAK_TFLOPS", 989.0)

    # --- the fleet (serving/multi_engine.py, controller.py, disagg.py) ---
    # "dp:N" serves N engine replicas on the card; a tp / sp / ep / pp
    # axis above 1 needs the parallel layers __main__ refuses
    mesh_shape: str = _env("MESH_SHAPE", "")
    # the router: auto = affinity when any replica caches prefixes, on =
    # always score prefixes, off = weighted least-loaded
    route_affinity: str = _env("ROUTE_AFFINITY", "auto")
    # least interval between a replica's chain-digest rebuilds
    route_digest_interval_s: float = _float("ROUTE_DIGEST_INTERVAL_S", 0.25)
    # the shortest matched prefix run (pages) that counts as a hit
    route_min_prefix_pages: int = _int("ROUTE_MIN_PREFIX_PAGES", 1)
    # trailing replicas that start as warm spares (clamped by __main__)
    fleet_spares: int = _int("FLEET_SPARES", 0)
    # "on" runs the self-healing controller over a fleet of dp > 1
    ctrl: str = _env("CTRL", "off")
    ctrl_tick_s: float = _float("CTRL_TICK_S", 1.0)
    # consecutive agreeing ticks before a decision acts
    ctrl_hysteresis_ticks: int = _int("CTRL_HYSTERESIS_TICKS", 2)
    # quiet period a (replica, action) after it acted
    ctrl_cooldown_s: float = _float("CTRL_COOLDOWN_S", 30.0)
    # at most this many actions a sliding window
    ctrl_max_actions: int = _int("CTRL_MAX_ACTIONS", 4)
    ctrl_action_window_s: float = _float("CTRL_ACTION_WINDOW_S", 300.0)
    # a driver heartbeat older than this marks its replica wedged
    ctrl_liveness_timeout_s: float = _float("CTRL_LIVENESS_TIMEOUT_S", 5.0)
    # hbm_pages remedy: host-pool growth factor and cap (0 = 8x the pool)
    ctrl_host_pool_grow: float = _float("CTRL_HOST_POOL_GROW", 1.5)
    ctrl_host_pool_max_pages: int = _int("CTRL_HOST_POOL_MAX_PAGES", 0)
    # the JAX stats() wait on a driver lock; the port's stats() takes no
    # lock, so this is read by nothing but kept for the pod spec
    ctrl_stats_timeout_s: float = _float("CTRL_STATS_TIMEOUT_S", 0.25)
    # the index snapshots a warm spare restores before it activates
    ctrl_snapshot_dir: str = _env("CTRL_SNAPSHOT_DIR", "")
    # "on" splits a tiered fleet of >= 2 into prefill and decode replicas
    disagg: str = _env("DISAGG", "off")
    disagg_prefill_replicas: int = _int("DISAGG_PREFILL_REPLICAS", 1)
    # pages a transport chunk of one handoff
    disagg_transfer_burst: int = _int("DISAGG_TRANSFER_BURST", 32)

    # --- store and retrieval (store/factory.py, embedding.py, retrieval/) ---
    store_backend: str = _env("STORE_BACKEND", "memory")  # memory|native|cassandra
    store_path: str = _env("STORE_PATH", "")  # persistence dir of the memory / native store
    # STORE_BACKEND=cassandra: one contact point, plain-text auth, the keyspace
    cassandra_host: str = _env("CASSANDRA_HOST", "localhost")
    cassandra_port: int = _int("CASSANDRA_PORT", 9042)
    cassandra_username: str = _env("CASSANDRA_USERNAME", "cassandra")
    cassandra_password: str = _env("CASSANDRA_PASSWORD", "cassandra")
    cassandra_keyspace: str = _env("CASSANDRA_KEYSPACE", "vector_store")
    # the five-level hierarchy's tables
    embeddings_table_catalog: str = _env("EMBEDDINGS_TABLE_CATALOG", "embeddings_catalog")
    embeddings_table_repo: str = _env("EMBEDDINGS_TABLE_REPO", "embeddings_repo")
    embeddings_table_module: str = _env("EMBEDDINGS_TABLE_MODULE", "embeddings_module")
    embeddings_table_file: str = _env("EMBEDDINGS_TABLE_FILE", "embeddings_file")
    embeddings_table_chunk: str = field(
        default_factory=lambda: os.getenv("EMBEDDINGS_TABLE_CHUNK",
                                          os.getenv("EMBEDDINGS_TABLE", "embeddings")))
    # a local BERT checkpoint dir; anything else -> the hashing encoder
    embed_model: str = _env("EMBED_MODEL", "intfloat/e5-small-v2")
    embed_dim: int = _int("EMBED_DIM", 384)
    # "auto" and "on" wrap the store in the device index on the card (the
    # JAX package's "auto" wraps on TPU only); "off" keeps the host store
    device_index: str = _env("DEVICE_INDEX", "auto")
    # concurrent retrieve() calls share one encode + one search per wave
    retrieval_coalesce: bool = _bool("RETRIEVAL_COALESCE", True)
    # max queries a wave, and the top query bucket the device index warms
    retrieval_max_wave: int = _int("RETRIEVAL_MAX_WAVE", 16)
    # the index's static k; larger k goes to the host store, counted
    device_index_k_bucket: int = _int("DEVICE_INDEX_K_BUCKET", 16)
    # "on": writes go through the mutation log, a daemon applies them
    live_index: str = _env("LIVE_INDEX", "off")
    # durable JSONL file of the log; empty = memory only
    # (DATA_DIR/mutation_log.jsonl when DATA_DIR is set)
    live_index_log_path: str = _env("LIVE_INDEX_LOG_PATH", "")
    live_index_apply_batch: int = _int("LIVE_INDEX_APPLY_BATCH", 64)
    # the compactor's idle scan period and its two hole triggers
    index_compact_interval_s: float = _float("INDEX_COMPACT_INTERVAL_S", 5.0)
    index_compact_min_holes: int = _int("INDEX_COMPACT_MIN_HOLES", 64)
    index_compact_max_hole_fraction: float = _float("INDEX_COMPACT_MAX_HOLE_FRACTION", 0.25)
    data_dir: str = _env("DATA_DIR", "")

    # --- ingest (ingest/) ---
    github_token: str = _env("GITHUB_TOKEN", "")
    github_user: str = _env("GITHUB_USER", "")
    default_branch: str = _env("DEFAULT_BRANCH", "main")
    default_collection: str = _env("DEFAULT_COLLECTION", "misc")
    dev_force_standalone: bool = _bool("DEV_MODE", False)
    # stage gauges go to this Pushgateway when set (ingest/controller.py)
    pushgateway_url: str = _env("PUSHGATEWAY_URL", "")

    @property
    def scope_tables(self) -> dict[str, str]:
        """scope name -> table name, the 5-level hierarchy."""
        return {
            "catalog": self.embeddings_table_catalog,
            "repo": self.embeddings_table_repo,
            "module": self.embeddings_table_module,
            "file": self.embeddings_table_file,
            "chunk": self.embeddings_table_chunk,
        }


# file extension -> language name for the chunker and preprocess
# (ingest/src/app/config.py:50-84 in the reference)
EXTENSION_TO_LANGUAGE: dict[str, str] = {
    ".js": "javascript",
    ".jsx": "javascript",
    ".ts": "typescript",
    ".tsx": "typescript",
    ".py": "python",
    ".java": "java",
    ".cpp": "cpp",
    ".cc": "cpp",
    ".cxx": "cpp",
    ".c": "c",
    ".h": "c",
    ".cs": "c_sharp",
    ".php": "php",
    ".rb": "ruby",
    ".go": "go",
    ".rs": "rust",
    ".swift": "swift",
    ".kt": "kotlin",
    ".scala": "scala",
    ".sh": "bash",
    ".bash": "bash",
    ".sql": "sql",
    ".html": "html",
    ".htm": "html",
    ".css": "css",
    ".json": "json",
    ".xml": "xml",
    ".yaml": "yaml",
    ".yml": "yaml",
    ".toml": "toml",
    ".md": "markdown",
    ".dockerfile": "dockerfile",
}


_settings: Settings | None = None


def get_settings() -> Settings:
    """Process-wide settings (environment read once, at first use)."""
    global _settings
    if _settings is None:
        _settings = Settings()
    return _settings


def reload_settings() -> Settings:
    """Re-read the environment."""
    global _settings
    _settings = Settings()
    return _settings
