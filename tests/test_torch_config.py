"""The port's model-server, retrieval and RAG-service settings against
the JAX package's: for each environment below, every field of
``githubrepostorag_tpu_torch.config.Settings`` equals the JAX ``Settings``
field of the same name (same variable, default and parser), and a typo
raises on both sides."""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

import pytest

from githubrepostorag_tpu import config as j_config
from githubrepostorag_tpu_torch import config

# every environment variable the port's settings read
ENV_NAMES = sorted(set(re.findall(r'"([A-Z][A-Z0-9_]{2,})"', Path(config.__file__).read_text())))

ENVIRONMENTS = {
    "defaults": {},
    "int4_weights": {"QUANTIZE_WEIGHTS": "int4"},
    "int8_pages": {"KV_QUANT": "8"},
    "packed_prefill": {"PREFILL_TOKEN_BUDGET": "2048", "MAX_NUM_SEQS": "8"},
    "no_prefix_cache": {"PREFIX_CACHING": "0", "PRIORITY_DEFAULT_CLASS": "batch"},
    "unported_modes": {"KV_TIER": "on", "SPEC_K": "8", "PRIORITY_PROTECTED_CLASS": "batch",
                       "MESH_SHAPE": "tp:2", "CTRL": "on"},
    "retrieval": {"DEVICE_INDEX": "off", "RETRIEVAL_COALESCE": "0", "RETRIEVAL_MAX_WAVE": "4",
                  "DEVICE_INDEX_K_BUCKET": "32", "LIVE_INDEX": "on", "DATA_DIR": "/data",
                  "LIVE_INDEX_APPLY_BATCH": "16", "INDEX_COMPACT_MIN_HOLES": "8",
                  "INDEX_COMPACT_MAX_HOLE_FRACTION": "0.5", "INDEX_COMPACT_INTERVAL_S": "0.5",
                  "EMBED_MODEL": "/models/e5", "EMBED_DIM": "768", "STORE_PATH": "/store",
                  "EMBEDDINGS_TABLE": "chunks", "EMBEDDINGS_TABLE_REPO": "repos"},
    "rag_service": {"LLM_BACKEND": "http", "QWEN_ENDPOINT": "http://model:8000",
                    "QWEN_MAX_OUTPUT": "64", "QWEN_TEMPERATURE": "0", "QWEN_TOP_P": "0.5",
                    "JOB_TIMEOUT_SECONDS": "30", "JOB_QUEUE_MAX_DEPTH": "4",
                    "WORKER_MAX_JOBS": "2", "KEEP_RESULT_SECONDS": "60",
                    "SSE_PING_SECONDS": "3", "SSE_HEARTBEAT_SECONDS": "0.5",
                    "FAULTS": "llm.complete:drop@3", "FAULTS_SEED": "7",
                    "RETRY_MAX_ATTEMPTS": "2", "RETRY_BASE_SECONDS": "0.01",
                    "RETRY_CAP_SECONDS": "0.1", "BREAKER_FAILURE_THRESHOLD": "2",
                    "BREAKER_RESET_SECONDS": "1", "TRACE_SAMPLE": "0.5",
                    "TRACE_MAX_TRACES": "8", "TRACE_MAX_SPANS": "16", "LOG_FORMAT": "plain",
                    "MAX_RAG_ATTEMPTS": "2", "ROUTER_TOP_K": "3", "AGENT_LONGCTX": "0",
                    "LONGCTX_TOKEN_BUDGET": "2048", "DEFAULT_NAMESPACE": "team"},
    "ingest": {"GITHUB_TOKEN": "t0k", "GITHUB_USER": "octo", "DEFAULT_BRANCH": "trunk",
               "DEFAULT_COLLECTION": "tools", "DEV_MODE": "yes",
               "PUSHGATEWAY_URL": "http://pushgw:9091", "DATA_DIR": "/data"},
    "ingest_dev_mode_off": {"DEV_MODE": "0"},
    "split_deployment": {"REDIS_URL": "redis://:s3cret@redis:6380/2", "METRICS_PORT": "9100",
                         "STORE_BACKEND": "cassandra", "CASSANDRA_HOST": "cassandra-0",
                         "CASSANDRA_PORT": "19042", "CASSANDRA_USERNAME": "rag",
                         "CASSANDRA_PASSWORD": "pw", "CASSANDRA_KEYSPACE": "vectors"},
    "split_deployment_bad_ports": {"METRICS_PORT": "nine", "CASSANDRA_PORT": ""},
    "draft_and_obs": {"SPEC_DRAFT_MODEL": "/models/draft", "SPEC_K": "2", "SPEC_ITERS": "3",
                      "SPEC_ACCEPT_FLOOR": "0.2", "SPEC_DEADLINE_MARGIN_S": "1.5",
                      "PROFILE_SAMPLE_EVERY": "4", "PROFILE_RING": "16",
                      "TIMELINE_WINDOW_S": "30", "TIMELINE_MAX_EVENTS": "100",
                      "SLO_TTFT_P50_MS": "800", "SLO_TTFT_P99_MS": "2000", "SLO_TPOT_MS": "40",
                      "SLO_DEADLINE_MISS_BUDGET": "0.1", "SLO_LONGCTX_TTFT_P50_MS": "9000",
                      "SLO_LONGCTX_TTFT_P99_MS": "20000", "SLO_LONGCTX_TPOT_MS": "90",
                      "SLO_WINDOWS": "5,30", "SLO_BURN_WARN": "2", "SLO_BURN_CRITICAL": "4",
                      "SLO_LEDGER_WINDOW_S": "10", "MODEL_FLOPS_PER_TOKEN": "1.5e10"},
    "fleet": {"MESH_SHAPE": "dp:3", "ROUTE_AFFINITY": "on", "ROUTE_DIGEST_INTERVAL_S": "0",
              "ROUTE_MIN_PREFIX_PAGES": "2", "FLEET_SPARES": "1", "CTRL": "on",
              "CTRL_TICK_S": "0.05", "CTRL_HYSTERESIS_TICKS": "3", "CTRL_COOLDOWN_S": "0.1",
              "CTRL_MAX_ACTIONS": "2", "CTRL_ACTION_WINDOW_S": "60",
              "CTRL_LIVENESS_TIMEOUT_S": "30", "CTRL_HOST_POOL_GROW": "2",
              "CTRL_HOST_POOL_MAX_PAGES": "64", "CTRL_STATS_TIMEOUT_S": "0.1",
              "CTRL_SNAPSHOT_DIR": "/snapshots", "DISAGG": "on",
              "DISAGG_PREFILL_REPLICAS": "2", "DISAGG_TRANSFER_BURST": "8"},
    "fleet_bad_numbers": {"FLEET_SPARES": "one", "CTRL_TICK_S": "fast",
                          "ROUTE_DIGEST_INTERVAL_S": ""},
    "moe": {"MOE_CAPACITY_FACTOR": "1.25"},
    "moe_bad_factor": {"MOE_CAPACITY_FACTOR": "wide"},
}


@pytest.fixture
def env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)

    def apply(values: dict[str, str]):
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        return config.reload_settings(), j_config.reload_settings()

    yield apply
    monkeypatch.undo()
    config.reload_settings()


def test_env_names_found():
    assert {"MODEL_WEIGHTS_PATH", "QUANTIZE_WEIGHTS", "KV_QUANT", "CONTEXT_WINDOW"} <= set(ENV_NAMES)


# divergences by design: the field and the port's default (the JAX
# package's is a TPU's figure); the variable and its parser stay the same
PORT_DEFAULTS = {"chip_peak_tflops": 989.0}

# JAX settings the port has no field for yet, each with its reason
PENDING = {
    # read by nothing in the JAX package
    "dtype", "min_source_nodes",
}


@pytest.mark.parametrize("name", list(ENVIRONMENTS))
def test_fields_equal_jax(env, name):
    """Every port field equals the JAX field of its name, and every JAX
    field exists in the port but the ``PENDING`` ones."""
    port, jax_side = env(ENVIRONMENTS[name])
    for f in dataclasses.fields(port):
        if f.name in PORT_DEFAULTS:
            assert getattr(port, f.name) == PORT_DEFAULTS[f.name], f.name
            continue
        assert getattr(port, f.name) == getattr(jax_side, f.name), f.name
    port_fields = {f.name for f in dataclasses.fields(port)}
    jax_fields = {f.name for f in dataclasses.fields(jax_side)}
    assert jax_fields - port_fields == PENDING
    assert port.scope_tables == jax_side.scope_tables
    assert config.get_settings() is port


@pytest.mark.parametrize("var,value", [("QUANTIZE_WEIGHTS", "int5"), ("KV_QUANT", "fp8")])
def test_typo_raises_on_both_sides(env, var, value):
    with pytest.raises(ValueError, match=var):
        env({var: value})
    with pytest.raises(ValueError, match=var):
        j_config.reload_settings()


def test_extension_languages_equal_jax():
    assert config.EXTENSION_TO_LANGUAGE == j_config.EXTENSION_TO_LANGUAGE
    assert list(config.EXTENSION_TO_LANGUAGE) == list(j_config.EXTENSION_TO_LANGUAGE)


def test_chip_peak_is_the_cards(env):
    """CHIP_PEAK_TFLOPS, the ledger's MFU denominator, defaults to the
    card's dense bf16 peak (989 TFLOP/s, NVIDIA H100 80GB HBM3 at 700 W),
    not the JAX package's TPU figure; set, it parses as the JAX field
    does."""
    port, jax_side = env({})
    assert port.chip_peak_tflops == 989.0 != jax_side.chip_peak_tflops
    port, jax_side = env({"CHIP_PEAK_TFLOPS": "500"})
    assert port.chip_peak_tflops == jax_side.chip_peak_tflops == 500.0
    port, jax_side = env({"CHIP_PEAK_TFLOPS": "fast"})
    assert port.chip_peak_tflops == 989.0


def test_ctrl_stats_timeout_is_parsed_and_inert(env):
    """CTRL_STATS_TIMEOUT_S parses as the JAX field does (the pod spec
    sets it) but nothing of the port reads it: the port's ``stats()``
    takes no lock to wait on (ROADMAP queue 3 item 18)."""
    port, jax_side = env({"CTRL_STATS_TIMEOUT_S": "0.5"})
    assert port.ctrl_stats_timeout_s == jax_side.ctrl_stats_timeout_s == 0.5
    package = Path(config.__file__).parent
    readers = []
    for path in sorted(package.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Attribute) and node.attr == "ctrl_stats_timeout_s") or (
                    isinstance(node, ast.Constant) and node.value in (
                        "ctrl_stats_timeout_s", "CTRL_STATS_TIMEOUT_S")):
                readers.append(f"{path.relative_to(package)}:{node.lineno}")
    # only the field's own parser names it
    assert [r.split(":")[0] for r in readers] == ["config.py"], readers
