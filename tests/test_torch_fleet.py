"""The port's fleet against the JAX package's (CPU, float32): the router
(``serving/routing.py``, ``multi_engine.py``), the replica lifecycle, the
prefill / decode split (``serving/disagg.py``) and the fleet's chaos cases
run the cases of ``tests/test_multi_engine.py``, ``test_fleet_router.py``,
``test_disagg.py`` and the fleet cases of ``test_chaos.py`` on both
packages, each over the same numpy-seeded tiny Qwen2 (JAX on the CPU, the
port on ``device="cpu"``), and compare greedy tokens, the replica each
request lands on, the decision counters, pages shipped and deduped,
fallback reasons and the ``/debug/fleet`` payload.  Every compared value
must be equal; the exceptions, each stated where it is compared, are the
ledger's timings (host wall time) and the divergences by design: dp
replicas share one device where JAX refuses
(``test_dp_replicas_share_one_device_where_jax_refuses``) and a wedged
driver's stats row stays live (``test_stats_never_wait_on_a_wedged_driver``).
Also: ``dp_devices``' plan, the server with ``MESH_SHAPE=dp:2`` over a tiny
checkpoint with drain / activate over a socket, the fleet's metric series
and the kernels' counter buffer under two threads."""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import githubrepostorag_tpu.config as j_config
import githubrepostorag_tpu.metrics as j_metrics
import githubrepostorag_tpu.obs.ledger as j_ledger
import githubrepostorag_tpu.obs.timeline as j_timeline
import githubrepostorag_tpu.resilience.faults as j_faults
import githubrepostorag_tpu.resilience.policy as j_policy
import githubrepostorag_tpu.serving.disagg as j_disagg
import githubrepostorag_tpu.serving.multi_engine as j_multi
import githubrepostorag_tpu.serving.routing as j_routing
from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu.serving.async_engine import StreamEvent as JStreamEvent
from githubrepostorag_tpu.serving.chain_hash import chain_hashes as j_chain_hashes
from githubrepostorag_tpu.serving.openai_api import OpenAIServer as JOpenAIServer
from githubrepostorag_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer
from githubrepostorag_tpu_torch import config as t_config
from githubrepostorag_tpu_torch import metrics as t_metrics
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.obs import continuous as t_continuous
from githubrepostorag_tpu_torch.obs import hbm as t_hbm
from githubrepostorag_tpu_torch.obs import ledger as t_ledger
from githubrepostorag_tpu_torch.obs import slo as t_slo
from githubrepostorag_tpu_torch.obs import timeline as t_timeline
from githubrepostorag_tpu_torch.ops import paged_decode
from githubrepostorag_tpu_torch.resilience import faults as t_faults
from githubrepostorag_tpu_torch.resilience import policy as t_policy
from githubrepostorag_tpu_torch.serving import Engine, SamplingParams
from githubrepostorag_tpu_torch.serving import disagg as t_disagg
from githubrepostorag_tpu_torch.serving import multi_engine as t_multi
from githubrepostorag_tpu_torch.serving import routing as t_routing
from githubrepostorag_tpu_torch.serving.async_engine import StreamEvent
from githubrepostorag_tpu_torch.serving.chain_hash import chain_hashes
from githubrepostorag_tpu_torch.serving.kv_cache import page_hashes
from githubrepostorag_tpu_torch.serving.openai_api import OpenAIServer
from githubrepostorag_tpu_torch.serving.tokenizer import ByteTokenizer

SEED = 0
# the JAX fleet tests' geometry: 32 pages of 4 tokens, 2 rows
GEOM = dict(max_num_seqs=2, num_pages=32, page_size=4, max_seq_len=64, decode_burst=8)
TIER = dict(kv_tier="on", kv_host_pool_pages=64)


def reset_port() -> None:
    """The port's process-wide planes, registries and settings (the JAX
    package's are reset by tests/conftest.py)."""
    t_config.reload_settings()
    t_slo.reset_slo_plane()
    t_hbm.reset_hbm_plane()
    t_continuous.reset_profilers()
    t_timeline.reset_fleet_events_provider()
    t_faults.reset_faults()
    t_policy.reset_breakers()


@pytest.fixture(autouse=True)
def _port_state():
    reset_port()
    yield
    reset_port()


def model_tree(jcfg: JConfig) -> dict:
    """The tiny Qwen2's weights from a numpy generator: every matrix and
    bias normal(0, 0.35) (wide enough that greedy tokens move), the norms
    ones; one tree for both packages."""
    rng = np.random.default_rng(SEED)
    tree = jax.tree.map(np.asarray, j_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return jax.tree.map(
        lambda x: x if x.ndim < 2 or np.all(x == 1) else
        rng.normal(0, 0.35, x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def sides() -> dict[str, SimpleNamespace]:
    """Each package's engine factory and fleet modules, over one tree."""
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    tree = model_tree(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, cfg, device="cpu")

    def j_engine(**kw):
        return JEngine(jp, jcfg, kv_dtype=jnp.float32, **{**GEOM, **kw})

    def t_engine(**kw):
        return Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **kw})

    return {
        "jax": SimpleNamespace(name="jax", engine=j_engine, SP=JSamplingParams, multi=j_multi,
                               routing=j_routing, disagg=j_disagg, policy=j_policy,
                               ledger=j_ledger, metrics=j_metrics, timeline=j_timeline,
                               StreamEvent=JStreamEvent, server=JOpenAIServer,
                               tokenizer=JByteTokenizer),
        "port": SimpleNamespace(name="port", engine=t_engine, SP=SamplingParams, multi=t_multi,
                                routing=t_routing, disagg=t_disagg, policy=t_policy,
                                ledger=t_ledger, metrics=t_metrics, timeline=t_timeline,
                                StreamEvent=StreamEvent, server=OpenAIServer,
                                tokenizer=ByteTokenizer),
    }


def greedy(side, max_tokens: int = 8):
    return side.SP(max_tokens=max_tokens, temperature=0.0, stop_token_ids=())


def prompts(n: int, seed: int = 11, base: int = 12) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, base + i).tolist() for i in range(n)]


def set_env(monkeypatch, **env: str) -> None:
    """Set ``env`` and rebuild both packages' settings and fault registries."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    j_config.reload_settings()
    t_config.reload_settings()
    j_faults.reset_faults()
    t_faults.reset_faults()


def fleet(side, n: int = 2, spares: int = 0, policy: str | None = None, **kw):
    return side.multi.MultiAsyncEngine([side.engine(**kw) for _ in range(n)], spares=spares,
                                       policy=policy)


def record_picks(multi) -> list[str]:
    """The replica of every ``_pick`` / ``_pick_decode``, in order."""
    picks: list[str] = []
    for name in ("_pick", "_pick_decode"):
        orig = getattr(multi, name)

        def wrapped(*a, _orig=orig, **k):
            target, granted = _orig(*a, **k)
            picks.append(None if target is None else target.replica)
            return target, granted

        setattr(multi, name, wrapped)
    return picks


async def on_both(sides, fn) -> dict:
    """``await fn(side)`` on each package, one after the other."""
    return {name: await fn(side) for name, side in sides.items()}


def same(out: dict):
    assert out["port"] == out["jax"]
    return out["port"]


def expected_tokens(side, ps, max_tokens: int = 8, **kw) -> list[list[int]]:
    return [r.output_tokens for r in side.engine(**kw).generate(ps, greedy(side, max_tokens))]


# ------------------------------------------------------------ dp devices --


def test_dp_devices_map_replicas_to_devices():
    """Replica i gets devices[i % len(devices)]: disjoint while there are
    enough, one each, in order (the plan ``dp_submeshes`` makes for dp
    groups of one device)."""
    devs = t_multi.dp_devices(4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    assert devs == [torch.device(f"cuda:{i}") for i in range(4)]
    assert t_multi.dp_devices(2, ["cuda:0", "cuda:1", "cuda:2"]) == [
        torch.device("cuda:0"), torch.device("cuda:1")]
    assert t_multi.dp_devices(1, ["cpu"]) == [torch.device("cpu")]
    # the default is every visible card, else the CPU (this machine: CPU)
    assert t_multi.dp_devices(3) == [torch.device("cpu")] * 3
    for bad in (0, -1):
        with pytest.raises(ValueError, match="dp must be at least 1"):
            t_multi.dp_devices(bad)


def test_dp_replicas_share_one_device_where_jax_refuses():
    """The divergence by design: JAX refuses more dp groups than devices
    (``test_dp_submeshes_rejects_oversubscription``); the port's target is
    one card, so three replicas share it, and two cards take replicas
    round-robin."""
    from githubrepostorag_tpu.parallel import MeshPlan

    with pytest.raises(ValueError, match="devices"):
        j_multi.dp_submeshes(MeshPlan(tp=8, dp=2))
    with pytest.raises(ValueError, match="devices"):
        j_multi.dp_submeshes(MeshPlan(dp=3), devices=jax.devices()[:1])
    assert t_multi.dp_devices(3, ["cuda:0"]) == [torch.device("cuda:0")] * 3
    assert t_multi.dp_devices(3, ["cuda:0", "cuda:1"]) == [
        torch.device("cuda:0"), torch.device("cuda:1"), torch.device("cuda:0")]


# ----------------------------------------------- multi engine (JAX tests) --


async def test_multi_engine_token_identical_and_balanced_as_jax(sides):
    ps = prompts(4)

    async def run(side):
        want = expected_tokens(side, ps)
        multi = fleet(side)
        picks = record_picks(multi)
        try:
            results = await asyncio.gather(*(multi.generate(p, greedy(side)) for p in ps))
            stats = multi.stats()
            admitted = [s["requests_admitted"] for s in stats["per_replica"]]
            assert [r.output_tokens for r in results] == want
            assert all(a > 0 for a in admitted), admitted
            # the first two picks only: a later concurrent pick races the
            # JAX drivers, whose admission blocks the loop on a step
            return {"tokens": want, "picks": picks[:2], "replicas": stats["replicas"],
                    "total": stats["requests_admitted"]}
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert out["total"] == 4 and out["picks"] == ["r0", "r1"]


async def test_multi_engine_cancel_routes_to_owner_as_jax(sides):
    async def run(side):
        multi = fleet(side)
        try:
            got, final = 0, None
            async for event in multi.stream(prompts(1)[0], greedy(side, 50), request_id="kill-me"):
                if event.type == "token":
                    got += 1
                    await multi.cancel("kill-me")
                if event.type == "final":
                    final = event.result.finish_reason
                    break
            return {"final": final, "some_tokens": got >= 1}
        finally:
            await multi.stop()

    assert same(await on_both(sides, run)) == {"final": "cancelled", "some_tokens": True}


async def test_openai_server_over_replicas_as_jax(sides):
    """Both servers over a two-replica fleet answer two concurrent chats
    with the same replies."""
    async def run(side):
        multi = fleet(side)
        server = side.server(multi, side.tokenizer(), model_name="tiny-dp")
        port = await server.start(host="127.0.0.1", port=0)
        loop = asyncio.get_running_loop()

        def post(body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read().decode())

        body = {"model": "tiny-dp", "max_tokens": 4, "temperature": 0,
                "messages": [{"role": "user", "content": "hi"}]}
        try:
            outs = await asyncio.gather(loop.run_in_executor(None, post, body),
                                        loop.run_in_executor(None, post, body))
        finally:
            await server.stop()
        return [(o["usage"], o["choices"][0]["message"]["content"],
                 o["choices"][0]["finish_reason"]) for o in outs]

    out = same(await on_both(sides, run))
    assert out[0] == out[1] and out[0][0]["completion_tokens"] == 4


@pytest.mark.parametrize("mean_rows", [False, True])
def test_stats_merge_rules_match_jax(mean_rows):
    """Counters sum across replicas; rate / ratio / utilization keys
    average (over the decode-capable rows when ``mean_rows`` is given)."""
    rows = [{"requests_admitted": 3, "spec_acceptance_rate": 0.8, "kv_utilization": 0.5,
             "spec_fallbacks": 1, "role": "prefill", "flag": True},
            {"requests_admitted": 1, "spec_acceptance_rate": 0.4, "kv_utilization": 0.1,
             "spec_fallbacks": 0, "role": "decode"}]
    kw = {"mean_rows": rows[1:]} if mean_rows else {}
    got = {m.__name__: m.MultiAsyncEngine._merge_rows(rows, **kw) for m in (j_multi, t_multi)}
    assert got[t_multi.__name__] == got[j_multi.__name__]

    class Stub:
        def __init__(self, s):
            self._s = s

        def stats(self):
            return self._s

    merged = {}
    for m in (j_multi, t_multi):
        multi = m.MultiAsyncEngine.__new__(m.MultiAsyncEngine)
        multi._engines = [Stub(r) for r in rows]
        merged[m.__name__] = m.MultiAsyncEngine.stats(multi)
    port = merged[t_multi.__name__]
    assert port == merged[j_multi.__name__]
    assert port["requests_admitted"] == 4 and port["replicas"] == 2


async def test_multi_engine_propagates_deadline_as_jax(sides):
    async def run(side):
        multi = fleet(side)
        try:
            ok = await multi.generate(prompts(1)[0], greedy(side),
                                      deadline_s=time.monotonic() + 60.0)
            reaped = await multi.generate(prompts(1)[0], greedy(side),
                                          deadline_s=time.monotonic() - 0.001)
            return (ok.finish_reason, ok.output_tokens, reaped.finish_reason)
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert out[0] in ("length", "stop") and len(out[1]) == 8 and out[2] == "deadline"


# ---------------------------------------------------- router (JAX tests) --


def test_chain_hash_is_the_allocator_identity_on_both():
    toks = list(range(23))
    assert page_hashes(toks, 4) == chain_hashes(toks, 4) == j_chain_hashes(toks, 4)
    assert len(chain_hashes(toks, 4)) == 5
    other = chain_hashes([99] + toks[1:], 4)
    assert all(a != b for a, b in zip(chain_hashes(toks, 4), other))


def test_routing_primitives_match_jax():
    """score_prefix, weighted_load, the weights and the digest payload."""
    for name in ("RESIDENT_WEIGHT", "HOST_WEIGHT", "LIMITER_PENALTY", "AFFINITY_LOAD_SLACK"):
        assert getattr(t_routing, name) == getattr(j_routing, name), name
    h = chain_hashes(list(range(20)), 4)
    for res, hst in ((h[:2], h[2:3]), ([h[0]] + h[2:], []), ([], h), (h, []), ([], [])):
        args = (h, frozenset(res), frozenset(hst))
        assert t_routing.score_prefix(*args) == j_routing.score_prefix(*args)
    assert t_routing.score_prefix(h, frozenset(h[:2]), frozenset(h[2:3]))[:2] == (2, 1)
    for lim in list(j_routing.LIMITER_PENALTY) + ["unknown"]:
        assert t_routing.weighted_load(2.0, lim) == j_routing.weighted_load(2.0, lim)
    digests = [m.ReplicaDigest("r0") for m in (t_routing, j_routing)]
    for d in digests:
        d.publish(frozenset([b"a"]), frozenset([b"b"]), 0.001)
    assert digests[0].snapshot() == digests[1].snapshot() == ({b"a"}, {b"b"})
    assert digests[0].payload() == digests[1].payload()


async def test_affinity_routes_to_longest_prefix_run_as_jax(sides):
    async def run(side):
        multi = fleet(side, policy="affinity")
        prompt = list(range(100, 124))
        h = chain_hashes(prompt, 4)
        multi._by_id["r0"].digest.publish(frozenset(h[:2]), frozenset())
        multi._by_id["r1"].digest.publish(frozenset(h[:5]), frozenset())
        first = multi._pick(prompt)
        multi._by_id["r0"].digest.publish(frozenset(h[:4]), frozenset(h[4:6]))
        second = multi._pick(prompt)
        rs = multi.router_stats()
        return {"picks": [(t.replica, g) for t, g in (first, second)],
                "decisions": rs["decisions"], "per_replica": rs["per_replica"]}

    out = same(await on_both(sides, run))
    assert out["picks"] == [("r1", True), ("r0", True)]
    assert out["per_replica"]["r0"]["matched_host_pages"] == 2


async def test_affinity_yields_to_load_when_hit_replica_saturated_as_jax(sides):
    async def run(side):
        multi = fleet(side, policy="affinity")
        prompt = list(range(300, 324))
        multi._by_id["r0"].digest.publish(frozenset(chain_hashes(prompt, 4)), frozenset())
        picks = []
        for extra in (0, 1):
            multi._pending["r0"] = int(side.routing.AFFINITY_LOAD_SLACK) + extra
            picks.append(multi._pick(prompt)[0].replica)
        return picks, multi.router_stats()["decisions"]

    picks, decisions = same(await on_both(sides, run))
    assert picks == ["r0", "r1"]
    assert decisions["affinity_hit"] == decisions["affinity_miss"] == 1


async def test_no_prefix_hit_falls_back_and_counts_miss_as_jax(sides):
    async def run(side):
        multi = fleet(side, policy="affinity")
        return multi._pick(list(range(200, 220)))[0].replica, multi.router_stats()["decisions"]

    _, decisions = same(await on_both(sides, run))
    assert decisions["affinity_miss"] == 1 and decisions["affinity_hit"] == 0


async def test_pick_staleness_burst_spreads_over_replicas_as_jax(sides):
    async def run(side):
        multi = fleet(side, policy="least_loaded")
        picks = []
        for p in prompts(6):
            target, _ = multi._pick(p)
            multi._pending[target.replica] += 1  # what stream() does next
            picks.append(target.replica)
        return picks

    picks = same(await on_both(sides, run))
    assert set(picks) == {"r0", "r1"} and abs(picks.count("r0") - picks.count("r1")) <= 1


async def test_breaker_open_replica_is_skipped_as_jax(sides):
    async def run(side):
        multi = fleet(side, policy="affinity")
        prompt = list(range(300, 320))
        multi._by_id["r0"].digest.publish(frozenset(chain_hashes(prompt, 4)), frozenset())
        out = []
        for r in ("r0", "r1"):
            br = side.policy.get_breaker(f"replica-{r}")
            for _ in range(br.failure_threshold):
                br.record_failure()
            target, granted = multi._pick(prompt)
            out.append((target.replica, granted, multi.router_stats()["decisions"]))
        return out

    out = same(await on_both(sides, run))
    assert [o[:2] for o in out] == [("r1", True), ("r0", False)]


async def test_limiter_weighted_fallback_skips_paging_bound_replica_as_jax(sides):
    async def run(side):
        multi = fleet(side, policy="least_loaded")
        led = multi._by_id["r0"].ledger
        snap = {f: 0.0 for f in side.ledger.SNAPSHOT_FIELDS}
        now = time.monotonic()
        for i in range(4):
            snap["admission_blocked_steps"] += 1
            snap["decode_seconds_total"] += 0.01
            led.on_step(dict(snap), now - 1.0 + i * 0.1, now - 0.95 + i * 0.1)
        return (led.current_limiter(), multi._pick(list(range(400, 420)))[0].replica,
                multi.router_stats()["decisions"])

    limiter, replica, decisions = same(await on_both(sides, run))
    assert (limiter, replica, decisions["skipped_limiter"]) == ("hbm_pages", "r1", 1)


def fleet_view(payload: dict) -> dict:
    """``/debug/fleet`` without its timings: the schema of every replica row
    and section, and the values that do not depend on host wall time
    (lifecycle, decisions, routing, digests' page counts, disagg, the
    ledger's committed tokens and step count)."""
    def schema(x):
        if isinstance(x, dict):
            return {k: schema(v) for k, v in x.items()}
        if isinstance(x, list):
            return [schema(v) for v in x[:1]]
        return type(x).__name__ if x is not None else None

    router = dict(payload["router"] or {})
    per = {r: {k: v for k, v in row.items() if k != "digest"}
           for r, row in router.get("per_replica", {}).items()}
    digests = {r: {k: row["digest"][k] for k in ("resident_pages", "host_pages")}
               for r, row in router.get("per_replica", {}).items()}
    return {
        "schema": {k: schema(v) for k, v in payload.items() if k not in ("replicas",)},
        "replica_keys": [sorted(r) for r in payload["replicas"]],
        "replica_ids": [r["replica"] for r in payload["replicas"]],
        "router": {k: v for k, v in router.items() if k != "per_replica"},
        "per_replica": per,
        "digest_pages": digests,
    }


async def test_routed_traffic_token_identical_with_counters_as_jax(sides, monkeypatch):
    """Mixed routed traffic: the same tokens as one engine, the same
    replica per request, the same decisions, and the same ``/debug/fleet``
    payload (schema and router values) for two replicas."""
    set_env(monkeypatch, ROUTE_DIGEST_INTERVAL_S="0")
    ps = prompts(4)

    async def run(side):
        want = expected_tokens(side, ps)
        multi = fleet(side)
        picks = record_picks(multi)
        try:
            # two waves of two concurrent requests (a third concurrent pick
            # would race the JAX drivers, whose admission blocks the loop)
            results = []
            for pair in (ps[:2], ps[2:]):
                results += await asyncio.gather(*(multi.generate(p, greedy(side))
                                                  for p in pair))
            # one more pass, one request at a time: each prompt's prefix now
            # lives on the replica that served it
            again = [await multi.generate(p, greedy(side)) for p in ps]
            assert [r.output_tokens for r in results] == want
            assert [r.output_tokens for r in again] == want
            await asyncio.sleep(0.05)  # let the drivers publish their digests
            router = multi.stats()["router"]
            view = fleet_view(multi.fleet())
            return {"picks": picks, "decisions": router["decisions"],
                    "routed": {r: v["routed"] for r, v in router["per_replica"].items()},
                    "fleet": view}
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert set(out["decisions"]) == set(t_multi.DECISIONS)
    assert out["picks"][4:] == out["picks"][:4]  # affinity: back where the prefix is
    assert out["decisions"]["affinity_hit"] >= 4
    assert out["fleet"]["replica_ids"] == ["r0", "r1"]


async def test_drain_with_in_flight_completes_token_identically_as_jax(sides):
    prompt = prompts(1)[0]

    async def run(side):
        want = expected_tokens(side, [prompt], 16)[0]
        multi = fleet(side)
        try:
            tokens, drain_task, final = [], None, None
            async for event in multi.stream(prompt, greedy(side, 16), request_id="drain-me"):
                if event.type == "token":
                    tokens.append(event.token_id)
                    if drain_task is None:
                        victim = multi._route["drain-me"].replica
                        drain_task = asyncio.create_task(multi.drain(victim))
                else:
                    final = event.result
            out = await drain_task
            assert final.output_tokens == want == tokens
            return {"out": {k: out[k] for k in ("replica", "lifecycle")},
                    "lifecycle": multi._by_id[out["replica"]].lifecycle, "tokens": tokens}
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert out["out"]["lifecycle"] == out["lifecycle"] == "drained"


async def test_drained_replica_admits_nothing_as_jax(sides):
    async def run(side):
        multi = fleet(side)
        try:
            await multi.drain("r0")
            before = multi._by_id["r0"].engine.requests_admitted
            await asyncio.gather(*(multi.generate(p, greedy(side, 4)) for p in prompts(4)))
            per = multi.router_stats()["per_replica"]
            return (multi._by_id["r0"].engine.requests_admitted - before,
                    per["r0"]["routed"], per["r1"]["routed"])
        finally:
            await multi.stop()

    assert same(await on_both(sides, run)) == (0, 0, 4)


async def test_drain_writes_cached_pages_back_to_host_tier_as_jax(sides):
    async def run(side):
        multi = fleet(side, kv_tier="on", kv_host_pool_pages=32)
        try:
            ps = prompts(4)
            for pair in (ps[:2], ps[2:]):  # two replicas, two waves: two each
                await asyncio.gather(*(multi.generate(p, greedy(side, 4)) for p in pair))
            victim = max(multi._engines, key=lambda ae: ae.engine.requests_admitted).replica
            alloc = multi._by_id[victim].engine._allocator
            lru = len(alloc._lru)
            await multi.drain(victim)
            return {"victim": victim, "lru": lru, "host_pages": alloc.host_pages,
                    "writebacks": alloc.writebacks}
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert out["lru"] > 0 and out["host_pages"] > 0 and out["writebacks"] > 0


async def test_warm_spare_activation_restores_capacity_as_jax(sides):
    async def run(side):
        multi = fleet(side, spares=1)
        try:
            lifecycle = multi._by_id["r1"].lifecycle
            await asyncio.gather(*(multi.generate(p, greedy(side, 4)) for p in prompts(3)))
            routed = multi.router_stats()["per_replica"]["r1"]["routed"]
            await multi.drain("r0")
            with pytest.raises(RuntimeError, match="no active replicas"):
                await multi.generate(prompts(1)[0], greedy(side, 4))
            out = await multi.activate("r1")
            r = await multi.generate(prompts(1)[0], greedy(side, 4))
            return (lifecycle, routed, out["lifecycle"], r.finish_reason, r.output_tokens,
                    multi.router_stats()["per_replica"]["r1"]["routed"])
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert out[:4] == ("spare", 0, "active", "length") and out[5] == 1


async def test_double_drain_joins_one_operation_as_jax(sides):
    async def run(side):
        multi = fleet(side)
        try:
            multi._pending["r0"] = 1  # in flight: the drain spins
            t1 = asyncio.create_task(multi.drain("r0"))
            t2 = asyncio.create_task(multi.drain("r0"))
            await asyncio.sleep(0.05)
            running = (t1.done(), t2.done(), multi._by_id["r0"].lifecycle)
            multi._pending["r0"] = 0
            r1, r2 = await asyncio.gather(t1, t2)
            return running, r1 is r2, r1["lifecycle"], r1["waited"] >= 1
        finally:
            await multi.stop()

    assert same(await on_both(sides, run)) == ((False, False, "draining"), True, "drained", True)


async def test_double_activate_joins_one_operation_as_jax(sides):
    async def run(side):
        multi = fleet(side, spares=1)
        try:
            r1, r2 = await asyncio.gather(multi.activate("r1"), multi.activate("r1"))
            return r1 is r2, r1["lifecycle"], multi._by_id["r1"].lifecycle
        finally:
            await multi.stop()

    assert same(await on_both(sides, run)) == (True, "active", "active")


async def test_drain_then_activate_race_serializes_as_jax(sides):
    async def run(side):
        multi = fleet(side)
        try:
            multi._pending["r0"] = 1
            d = asyncio.create_task(multi.drain("r0"))
            await asyncio.sleep(0.02)
            a = asyncio.create_task(multi.activate("r0"))
            await asyncio.sleep(0.05)
            queued = not a.done()
            multi._pending["r0"] = 0
            out_d, out_a = await asyncio.gather(d, a)
            r = await multi.generate(prompts(1)[0], greedy(side, 4))
            return (queued, out_d["lifecycle"], out_a["lifecycle"],
                    multi._by_id["r0"].lifecycle, r.finish_reason)
        finally:
            await multi.stop()

    assert same(await on_both(sides, run)) == (True, "drained", "active", "active", "length")


async def test_stats_never_wait_on_a_wedged_driver(sides, monkeypatch):
    """A divergence by design (ROADMAP queue 3 item 18): the JAX stats()
    waits ``CTRL_STATS_TIMEOUT_S`` on a wedged driver's lock and then
    serves the replica's cached row with ``stale_since``; the port's
    stats() takes no lock, so the wedged replica's row stays live (no
    ``stale_since``), with the JAX row's keys and role, and no call waits
    on the wedge (each well under one wedged iteration, 0.8 s)."""
    async def run(side):
        multi = fleet(side)
        try:
            fresh = multi.stats()
            set_env(monkeypatch, FAULTS="fleet.step.r1:delay=0.8", CTRL_STATS_TIMEOUT_S="0.1")
            await multi._by_id["r1"].start()
            rows, slowest = [], 0.0
            for _ in range(8):
                t0 = time.monotonic()
                rows.append(multi.stats()["per_replica"])
                slowest = max(slowest, time.monotonic() - t0)
                await asyncio.sleep(0.05)
            monkeypatch.setenv("FAULTS", "")
            set_env(monkeypatch)
            return fresh, rows, slowest
        finally:
            await multi.stop()

    out = await on_both(sides, run)
    j_fresh, j_rows, _ = out["jax"]
    fresh, rows, slowest = out["port"]
    assert any("stale_since" in r[1] for r in j_rows)  # JAX: the stale row
    assert all("stale_since" not in r[1] for r in rows)  # the port: live rows
    assert [sorted(r) for r in fresh["per_replica"]] == [sorted(r) for r in
                                                         j_fresh["per_replica"]]
    assert all(r[1]["role"] == "fused" for r in rows)
    assert slowest < 0.4


async def test_a_request_routed_to_a_dead_unfenced_replica_fails_fast_where_jax_waits(
        sides, monkeypatch):
    """A divergence by design (ROADMAP queue 3 item 21): FAULTS kills r0's
    driver at its first iteration, and the router still sends the next
    request to r0 (active, unfenced, the lighter replica).  The port's
    ``AsyncEngine.stream`` raises at once ("engine driver is dead"); the
    JAX fleet queues the request on the dead driver, and its caller waits
    until the controller (``CTRL=on``) fences r0 and the fence's error
    frame ends the request.  Every wait here is bounded at 2 s; both fleets
    and controllers stop in a ``finally``."""
    import githubrepostorag_tpu.serving.controller as j_controller
    from githubrepostorag_tpu_torch.serving import controller as t_controller

    controllers = {"jax": j_controller, "port": t_controller}
    set_env(monkeypatch, FAULTS="fleet.step.r0:error@window=1:", CTRL_TICK_S="0.05",
            CTRL_HYSTERESIS_TICKS="2", CTRL_COOLDOWN_S="0.1", CTRL_LIVENESS_TIMEOUT_S="30")

    async def run(side):
        multi = fleet(side)
        picks = record_picks(multi)
        ctrl = controllers[side.name].FleetController(multi)
        try:
            await multi.start()
            for _ in range(100):
                if not multi._by_id["r0"].driver_alive():
                    break
                await asyncio.sleep(0.02)
            dead = not multi._by_id["r0"].driver_alive()
            task = asyncio.ensure_future(multi.generate(prompts(1)[0], greedy(side, 4)))
            await asyncio.wait([task], timeout=0.3)
            early = None
            if task.done():
                exc = task.exception()
                early = (type(exc).__name__, str(exc).split(":")[0]) if exc else "result"
            await ctrl.start()
            late = None
            if not task.done():
                res = await asyncio.wait_for(task, timeout=2.0)
                late = (res.finish_reason, res.error)
            return dead, picks, early, late, multi._by_id["r0"].lifecycle
        finally:
            ctrl.stop()
            await multi.stop()

    out = await on_both(sides, run)
    assert out["port"][:2] == out["jax"][:2] == (True, ["r0"])
    assert out["port"][2] == ("RuntimeError", "engine driver is dead")
    assert out["jax"][2] is None
    assert out["jax"][3] == ("error", "replica r0 fenced by fleet controller")
    assert out["jax"][4] in ("draining", "drained")


async def test_fleet_lifecycle_endpoints_as_jax(sides):
    """POST /debug/fleet/drain and /activate over a socket, /debug/fleet
    between, on both servers; and a single engine's 404."""
    async def run(side):
        multi = fleet(side)
        server = side.server(multi, side.tokenizer(), model_name="tiny-fleet")
        port = await server.start(host="127.0.0.1", port=0)
        loop = asyncio.get_running_loop()

        def call(path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode() if body is not None else None,
                headers={"Content-Type": "application/json"},
                method="POST" if body is not None else "GET")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read().decode())

        try:
            out = [await loop.run_in_executor(None, call, "/debug/fleet/drain",
                                              {"replica": "r1"})]
            status, fl = await loop.run_in_executor(None, call, "/debug/fleet")
            out.append((status, fl["router"]["per_replica"]["r1"]["lifecycle"]))
            out.append(await loop.run_in_executor(None, call, "/debug/fleet/activate",
                                                  {"replica": "r1"}))
            out.append((await loop.run_in_executor(None, call, "/debug/fleet/drain",
                                                   {"replica": "r9"}))[0])
            out.append((await loop.run_in_executor(None, call, "/debug/fleet/drain",
                                                   {"nope": 1}))[0])
            status, health = await loop.run_in_executor(None, call, "/health")
            out.append((status, health["replicas"], sorted(health["router"])))
        finally:
            await server.stop()
        return out

    out = same(await on_both(sides, run))
    assert out[0] == (200, {"replica": "r1", "lifecycle": "drained", "waited": 0})
    assert out[1] == (200, "drained") and out[2][1]["lifecycle"] == "active"
    assert out[3:5] == [404, 400]


# ------------------------------------------------ disagg (JAX tests) -----


def disagg_fleet(side, monkeypatch, n: int = 3, prefill: int = 1, spares: int = 0, **kw):
    """A DISAGG=on fleet: the settings are read when the fleet is built."""
    set_env(monkeypatch, DISAGG="on", DISAGG_PREFILL_REPLICAS=str(prefill))
    return fleet(side, n=n, spares=spares, **{**TIER, **kw})


async def test_assign_roles_off_or_unviable_stays_fused_as_jax(sides, monkeypatch):
    async def run(side):
        monkeypatch.delenv("DISAGG", raising=False)
        set_env(monkeypatch)
        off = fleet(side, n=3, **TIER)
        solo = disagg_fleet(side, monkeypatch, n=1)
        mixed = side.multi.MultiAsyncEngine([side.engine(**TIER),
                                             side.engine(kv_tier="off")])
        return [(m.disagg_stats(), [ae.role for ae in m._engines]) for m in (off, solo, mixed)]

    out = same(await on_both(sides, run))
    assert all(not ds["enabled"] and set(roles) == {"fused"} for ds, roles in out)
    assert out[0][0]["transport"] is None


async def test_assign_roles_splits_clamps_and_keeps_spares_fused_as_jax(sides, monkeypatch):
    async def run(side):
        out = []
        for n, prefill, spares in ((3, 1, 0), (3, 5, 0), (3, 1, 1)):
            m = disagg_fleet(side, monkeypatch, n=n, prefill=prefill, spares=spares)
            out.append((m.disagg_stats(), [(ae.role, ae.lifecycle) for ae in m._engines],
                        [side.metrics.counter_value(side.metrics.FLEET_ROLE, replica=r)
                         for r in ("r0", "r1", "r2")]))
        return out

    out = same(await on_both(sides, run))
    assert out[0][0]["prefill_replicas"] == ["r0"] and out[1][0]["decode_replicas"] == ["r2"]
    assert out[2][1][2] == ("fused", "spare")


async def test_disagg_token_identical_to_fused_as_jax(sides, monkeypatch):
    ps = prompts(4)

    async def run(side):
        want = expected_tokens(side, ps, **TIER)
        multi = disagg_fleet(side, monkeypatch)
        picks = record_picks(multi)
        try:
            results = await asyncio.gather(*(multi.generate(p, greedy(side)) for p in ps))
            assert [r.output_tokens for r in results] == want
            ds = multi.disagg_stats()
            # which decode replica takes each request depends on the decode
            # progress at its pick (timing), so the picks compared are the
            # prefill replica's; page counts are summed over the decoders
            return {"tokens": want, "prefill_picks": picks.count("r0"), "disagg": ds,
                    "imported": sum(ae.engine.kv_pages_imported for ae in multi._engines[1:]),
                    "exported": multi._engines[0].engine.kv_pages_exported}
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    ds = out["disagg"]
    assert ds["handoffs"] == 4 and ds["pages_shipped"] > 0 and ds["fallbacks"] == {}
    assert out["prefill_picks"] == 4
    assert out["imported"] > 0 and out["exported"] >= out["imported"]


async def test_disagg_repeat_traffic_dedups_the_wire_as_jax(sides, monkeypatch):
    ps = prompts(2, seed=5)

    async def run(side):
        want = expected_tokens(side, ps, **TIER)
        multi = disagg_fleet(side, monkeypatch, n=2)
        try:
            rounds = []
            for _ in range(2):
                res = [await multi.generate(p, greedy(side)) for p in ps]
                assert [r.output_tokens for r in res] == want
                ds = multi.disagg_stats()
                rounds.append((ds["pages_shipped"], ds["pages_deduped"]))
            return rounds
        finally:
            await multi.stop()

    (s1, d1), (s2, d2) = same(await on_both(sides, run))
    assert s1 > 0 and d2 > d1 and s2 - s1 < s1


@pytest.mark.parametrize("extra", [
    pytest.param(dict(kv_quant=True), id="int8_kv"),
    pytest.param(dict(spec_ngram_k=3), id="spec_decode"),
])
async def test_disagg_parity_composes_with_quant_and_spec_as_jax(sides, monkeypatch, extra):
    ps = prompts(3, seed=7)

    async def run(side):
        want = expected_tokens(side, ps, **TIER, **extra)
        multi = disagg_fleet(side, monkeypatch, **extra)
        try:
            results = await asyncio.gather(*(multi.generate(p, greedy(side)) for p in ps))
            assert [r.output_tokens for r in results] == want
            return want, multi.disagg_stats()
        finally:
            await multi.stop()

    _, ds = same(await on_both(sides, run))
    assert ds["handoffs"] == 3


async def test_short_prompt_skips_the_handoff_as_jax(sides, monkeypatch):
    async def run(side):
        want = expected_tokens(side, [[1, 2, 3, 4]], 4, **TIER)[0]
        multi = disagg_fleet(side, monkeypatch, n=2)
        try:
            res = await multi.generate([1, 2, 3, 4], greedy(side, 4))
            assert res.output_tokens == want
            return multi.disagg_stats(), multi.router_stats()["per_replica"]["r1"]["routed"]
        finally:
            await multi.stop()

    ds, routed = same(await on_both(sides, run))
    assert ds["handoffs"] == 0 and ds["fallbacks"] == {} and routed == 1


async def test_transfer_failure_finishes_fused_as_jax(sides, monkeypatch):
    ps = prompts(2, seed=9)

    async def run(side):
        want = expected_tokens(side, ps, **TIER)
        multi = disagg_fleet(side, monkeypatch, n=2)

        async def dead_wire(src, dst, hashes):
            raise ConnectionError("wire down")

        multi._transport.transfer = dead_wire
        try:
            results = [await multi.generate(p, greedy(side)) for p in ps]
            assert [r.output_tokens for r in results] == want
            return multi.disagg_stats(), multi.router_stats()["per_replica"]["r0"]["routed"]
        finally:
            await multi.stop()

    ds, routed = same(await on_both(sides, run))
    assert ds["handoffs"] == 0 and ds["fallbacks"] == {"transfer_error": 2} and routed > 0


async def test_no_decode_replica_finishes_fused_as_jax(sides, monkeypatch):
    prompt = prompts(1, seed=13)[0]

    async def run(side):
        want = expected_tokens(side, [prompt], 4, **TIER)[0]
        multi = disagg_fleet(side, monkeypatch, n=2)
        try:
            await multi.drain("r1")
            res = await multi.generate(prompt, greedy(side, 4))
            assert res.output_tokens == want
            return multi.disagg_stats()["fallbacks"]
        finally:
            await multi.stop()

    assert same(await on_both(sides, run)) == {"no_decode_replica": 1}


async def test_fleet_stats_expose_roles_and_per_role_as_jax(sides, monkeypatch):
    async def run(side):
        multi = disagg_fleet(side, monkeypatch)
        try:
            await multi.generate(prompts(1)[0], greedy(side, 4))
            stats = multi.stats()
            per_role = {r: {k: v[k] for k in ("requests_admitted", "kv_pages_exported",
                                                "kv_pages_imported")}
                        for r, v in stats["per_role"].items()}
            return ([s["role"] for s in stats["per_replica"]], per_role,
                    stats["requests_admitted"], stats["router"]["disagg"]["enabled"])
        finally:
            await multi.stop()

    roles, per_role, admitted, enabled = same(await on_both(sides, run))
    assert roles == ["prefill", "decode", "decode"] and enabled
    assert sum(v["requests_admitted"] for v in per_role.values()) == admitted


async def test_disagg_zero_live_plans_after_warmup(sides, monkeypatch):
    """The JAX test's zero-live-compile contract in the port's terms: after
    every replica's warmup, mixed handoff / dedup replay / short-prompt
    traffic meets no new launch plan or dispatch shape on any replica (the
    compile watchdog, ROADMAP queue 3 item 16), and hands off as JAX's
    fleet does."""
    ps = prompts(2, seed=17)

    async def run(side):
        multi = disagg_fleet(side, monkeypatch)
        try:
            for ae in multi._engines:
                ae.engine.warmup()
            await multi.generate(ps[0], greedy(side, 4))
            before = ([ae.profiler.watchdog.cache_size() for ae in multi._engines]
                      if side.name == "port" else None)
            res = await asyncio.gather(multi.generate(ps[1], greedy(side, 4)),
                                       multi.generate(ps[0], greedy(side, 4)),
                                       multi.generate([1, 2, 3], greedy(side, 4)))
            after = ([ae.profiler.watchdog.cache_size() for ae in multi._engines]
                     if side.name == "port" else None)
            assert before == after
            return [r.output_tokens for r in res], multi.disagg_stats()["handoffs"]
        finally:
            await multi.stop()

    _, handoffs = same(await on_both(sides, run))
    assert handoffs >= 2


# ------------------------------------------------ chaos (JAX test_chaos) --


async def test_replica_death_during_drain_still_resolves_as_jax(sides, monkeypatch):
    async def run(side):
        multi = side.multi.MultiAsyncEngine([side.engine(page_size=8) for _ in range(2)])
        try:
            ok = await multi.generate([1, 2, 3, 4], greedy(side, 4))
            set_env(monkeypatch, FAULTS="fleet.drain:error")
            before = side.metrics.counter_value(side.metrics.FAULTS_INJECTED,
                                                site="fleet.drain", action="error")
            out = await multi.drain("r0")
            fired = side.metrics.counter_value(side.metrics.FAULTS_INJECTED,
                                               site="fleet.drain", action="error") - before
            failures = side.policy.get_breaker("replica-r0").snapshot()["consecutive_failures"]
            set_env(monkeypatch, FAULTS="")
            res = await multi.generate([5, 6, 7, 8], greedy(side, 4))
            per = multi.router_stats()["per_replica"]
            return (ok.output_tokens, out, fired, failures, res.output_tokens,
                    per["r0"]["lifecycle"], per["r1"]["routed"])
        finally:
            await multi.stop()

    out = same(await on_both(sides, run))
    assert out[1]["lifecycle"] == "drained" and "fleet.drain" in out[1]["fault"]
    assert out[2] == 1 and out[3] >= 1 and out[5] == "drained" and out[6] >= 1


async def test_decode_replica_death_mid_handoff_finishes_fused_as_jax(sides, monkeypatch):
    prompt = list(range(40, 58))  # 4 full shippable pages

    async def run(side):
        kw = dict(kv_host_pool_pages=32)
        want = expected_tokens(side, [prompt], 6, kv_tier="on", **kw)[0]
        set_env(monkeypatch, DISAGG="on", DISAGG_PREFILL_REPLICAS="1",
                FAULTS="disagg.transfer:error")
        multi = side.multi.MultiAsyncEngine([side.engine(kv_tier="on", **kw)
                                             for _ in range(2)])
        try:
            before = side.metrics.counter_value(side.metrics.FAULTS_INJECTED,
                                                site="disagg.transfer", action="error")
            res = await multi.generate(prompt, greedy(side, 6))
            fired = side.metrics.counter_value(side.metrics.FAULTS_INJECTED,
                                               site="disagg.transfer", action="error") - before
            ds = multi.disagg_stats()
            blame = [side.policy.get_breaker(f"replica-{r}").snapshot()["consecutive_failures"]
                     for r in ("r0", "r1")]
            set_env(monkeypatch, FAULTS="")
            res2 = await multi.generate(prompt, greedy(side, 6))
            assert res.output_tokens == res2.output_tokens == want
            return fired, ds, blame, multi.disagg_stats()["handoffs"]
        finally:
            await multi.stop()

    fired, ds, blame, handoffs = same(await on_both(sides, run))
    assert fired == 1 and ds["handoffs"] == 0 and ds["pages_shipped"] == 0
    assert ds["fallbacks"] == {"transfer_error": 1}
    assert blame[0] == 0 and blame[1] >= 1 and handoffs == 1


async def test_disagg_decode_preempt_falls_back_fused_as_jax(sides, monkeypatch):
    prompt = list(range(40, 58))

    async def run(side):
        kw = dict(kv_tier="on", kv_host_pool_pages=32, preempt="on")
        want = expected_tokens(side, [prompt], 6, **kw)[0]
        set_env(monkeypatch, DISAGG="on", DISAGG_PREFILL_REPLICAS="1")
        multi = side.multi.MultiAsyncEngine([side.engine(**kw) for _ in range(2)])
        orig = multi._stream_on
        state = {"parked": False}

        async def parked_decode(target, granted, prompt_ids, sampling, rid, deadline_s,
                                priority):
            if target.role == "decode" and not state["parked"]:
                state["parked"] = True
                yield side.StreamEvent(type="parked")
                return
            async for event in orig(target, granted, prompt_ids, sampling, rid, deadline_s,
                                    priority):
                yield event

        multi._stream_on = parked_decode
        try:
            res = await multi.generate(prompt, greedy(side, 6), priority="batch")
            assert res.output_tokens == want
            return multi.disagg_stats(), state["parked"]
        finally:
            await multi.stop()

    ds, parked = same(await on_both(sides, run))
    assert ds["handoffs"] == 1 and ds["fallbacks"] == {"preempted": 1} and parked


# ------------------------------------------------------- the port alone --


def test_fleet_metric_series_match_jax():
    """The fleet's eleven series carry the JAX package's names, labels and
    help text."""
    names = ("ROUTER_DECISIONS", "ROUTER_PREFIX_PAGES", "ROUTER_ROUTED", "FLEET_LIFECYCLE",
             "FLEET_ROLE", "CTRL_ACTIONS", "CTRL_FAILOPEN", "CTRL_SUPPRESSED",
             "DISAGG_HANDOFFS", "DISAGG_PAGES", "DISAGG_TRANSFER_SECONDS")
    for name in names:
        port, ref = getattr(t_metrics, name), getattr(j_metrics, name)
        assert port.name == ref._name or port.name == ref._name + "_total", name
        assert port.labelnames == tuple(ref._labelnames), name
        assert port.documentation == ref._documentation, name
        assert port.kind == ref._type, name


async def test_replicas_of_one_card_share_one_step_lock():
    """The replicas on one device take their steps under one lock (their
    drivers would otherwise hand the interpreter lock to each other at
    every torch op), the CPU's as a card's; another device's replicas get
    their own.  A fence hands the fenced replica's peers a fresh lock and
    leaves another device's alone."""
    def engine(device):
        return SimpleNamespace(device=torch.device(device), cfg=None, page_size=4,
                               _allocator=SimpleNamespace(num_pages=8, free_count=8))

    multi = t_multi.MultiAsyncEngine([engine(d) for d in ("cuda:0", "cuda:0", "cuda:1",
                                                          "cuda:1", "cpu", "cpu")])
    locks = [ae.step_lock for ae in multi.replicas()]
    assert locks[0] is locks[1] and locks[2] is locks[3] and locks[4] is locks[5]
    assert len({id(lock) for lock in locks}) == 3 and all(lock is not None for lock in locks)
    locks[0].acquire()  # r0 wedged inside its step
    await multi.fence("r0")
    after = [ae.step_lock for ae in multi.replicas()]
    assert after[0] is after[1] and after[1] is not locks[0] and not after[1].locked()
    assert after[2:] == locks[2:]


def test_the_wait_for_a_peers_step_is_no_stall():
    """The ledger and the step profiler keep a replica's wait for its
    peer's turn at the step lock (``waited_s``) out of the scheduler stall,
    so the router's limiter weighting reads the same as JAX's, whose
    replicas never wait: a 0.4 s gap of which 0.35 s was the peer's turn
    is a 0.05 s stall, and the limiter stays "none"."""
    from githubrepostorag_tpu_torch.obs.engine_profile import CompileWatchdog, EngineStepProfiler

    snaps = [{"decode_seconds_total": 0.1}, {"decode_seconds_total": 0.2}]
    out = {}
    for waited in (0.0, 0.35):
        led = t_ledger.TokenLedger(f"wait{waited}", window_s=60.0)
        prof = EngineStepProfiler(CompileWatchdog([]), replica=f"wait{waited}")
        for snap, (start, end) in zip(snaps, ((0.0, 0.1), (0.5, 0.6))):
            led.on_step(snap, start, end, waited_s=waited if start else 0.0)
            prof.on_step(start, end, waited_s=waited if start else 0.0)
        view = led.snapshot(now=1.0)
        out[waited] = (round(view["bucket_seconds"]["sched_stall"], 6), view["limiter"],
                       round(t_metrics.counter_value(t_metrics.SCHED_STALL,
                                                     replica=f"wait{waited}"), 6))
    assert out == {0.0: (0.4, "stall", 0.4), 0.35: (0.05, "none", 0.05)}


def test_arrival_counters_grow_once_under_concurrent_replicas():
    """Kernels B's and E's per-device arrival counters are shared by every
    replica's driver thread: concurrent grows leave one buffer, at least as
    large as the largest request, zeroed, handed to every caller whose
    request it covers."""
    dev = torch.device("cpu")
    paged_decode._COUNTERS.pop(dev, None)
    sizes = [300 + 97 * i for i in range(32)]  # more threads than cores
    barrier = threading.Barrier(len(sizes))
    got: dict[int, torch.Tensor] = {}

    def grab(n):
        barrier.wait(timeout=30)
        got[n] = paged_decode._counters(n, dev)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=grab, args=(n,)) for n in sizes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(got) == len(sizes)
    final = paged_decode._COUNTERS.pop(dev)
    assert final.numel() >= max(sizes) and not final.any()
    assert all(buf.numel() >= n for n, buf in got.items())
    assert got[max(sizes)] is final


async def test_fleet_timeline_carries_picks_lifecycle_and_fences(sides):
    """/debug/timeline's fleet track on both packages: router picks,
    lifecycle changes and a fence with its failed request ids, the same
    kinds in the same order."""
    async def run(side):
        multi = fleet(side, spares=1)
        try:
            await multi.generate(prompts(1)[0], greedy(side, 4))
            await multi.activate("r1")
            out = await multi.fence("r0")
            kinds = [(e["kind"], e.get("replica"), e.get("state"))
                     for e in list(multi._timeline_events)]
            trace = side.timeline.build_timeline(window_s=60.0)
            names = sorted({ev.get("name") for ev in trace["traceEvents"]
                            if str(ev.get("name", "")).startswith(("router", "fleet"))})
            return out, kinds, names
        finally:
            await multi.stop()

    out, kinds, names = same(await on_both(sides, run))
    # the finished request's stream is not closed yet: both fail its queue
    assert (out["replica"], out["lifecycle"]) == ("r0", "draining")
    assert ("fleet.fence", "r0", None) in kinds and ("fleet.lifecycle", "r1", "active") in kinds
    assert names


def test_server_serves_dp_replicas_and_lifecycle_over_a_socket(tmp_path):
    """``python -m githubrepostorag_tpu_torch.serving --device cpu`` with
    MESH_SHAPE=dp:2, FLEET_SPARES=1 and CTRL=on over a tiny checkpoint:
    /health carries two replicas and the router payload, a chat is
    answered, /debug/fleet/drain and /activate move r1 over a real
    socket, /debug/fleet shows the controller, SIGTERM stops it."""
    from tests.test_torch_serving_main import SERVER_ENV, _free_port, _write_checkpoint

    ckpt = _write_checkpoint(tmp_path, seed=0)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("SPEC_DRAFT_MODEL", "FAULTS")}
    env.update(SERVER_ENV, MODEL_WEIGHTS_PATH=str(ckpt), MESH_SHAPE="dp:2", FLEET_SPARES="1",
               CTRL="on", CTRL_TICK_S="0.1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "githubrepostorag_tpu_torch.serving", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"

    def call(path, body=None):
        req = urllib.request.Request(f"{base}{path}",
                                     data=json.dumps(body).encode() if body is not None else None,
                                     headers={"Content-Type": "application/json"},
                                     method="POST" if body is not None else "GET")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                health = call("/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.2)
        assert health["replicas"] == 2 and health["total_pages"] == 128
        per = health["router"]["per_replica"]
        assert (per["r0"]["lifecycle"], per["r1"]["lifecycle"]) == ("active", "spare")
        reply = call("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                              "max_tokens": 4, "temperature": 0})
        assert 1 <= reply["usage"]["completion_tokens"] <= 4
        assert call("/debug/fleet/activate", {"replica": "r1"}) == {
            "replica": "r1", "lifecycle": "active"}
        assert call("/debug/fleet/drain", {"replica": "r1"}) == {
            "replica": "r1", "lifecycle": "drained", "waited": 0}
        fleet_payload = call("/debug/fleet")
        assert fleet_payload["router"]["per_replica"]["r1"]["lifecycle"] == "drained"
        assert fleet_payload["controller"]["running"] is True
        assert [r["replica"] for r in fleet_payload["replicas"]] == ["r0", "r1"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "fleet controller up" in out and "model server stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
