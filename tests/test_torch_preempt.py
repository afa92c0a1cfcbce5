"""The port's preempt-to-host scheduling against the JAX package (CPU,
float32): a saturated tiered engine parks a batch-class victim's pages to
the host tier so a protected arrival admits, then resumes the victim
through the prefix cache with no prompt token recomputed.  Tokens equal
the JAX engine's and an unloaded reference's, and every preemption
counter equals JAX's, over fp, int8 and int4 pages; the admission ladder
(protected arrivals first, warn doubling the headroom, critical pressure
pausing batch admission), a deadline reap while parked, and the
``parked`` stream event of ``AsyncEngine``."""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu_torch import metrics
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams

# the JAX preempt tests' geometry: two batch rows take both rows of a
# 16-page tiered pool, so a protected arrival can only admit by preemption
GEOM = dict(max_num_seqs=2, num_pages=16, page_size=4, max_seq_len=64, prefill_chunk=16,
            decode_burst=4, kv_tier="on", kv_host_pool_pages=64, preempt="on",
            default_priority="interactive", protected_priority="interactive")
PROMPTS = {"b0": list(range(1, 9)), "b1": list(range(21, 29)), "hot": list(range(41, 49))}
STATS = ("preemptions", "preempted_pages", "preempt_resumes", "resume_faulted_pages",
         "resume_recomputed_tokens", "resume_recomputed_prompt_tokens", "deadline_reaps",
         "reaped_tokens", "num_parked")


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(3)))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _side(model, side, **kw):
    jcfg, cfg, jp, tp = model
    if side == "jax":
        return JEngine(jp, jcfg, kv_dtype=jnp.float32, **{**GEOM, **kw}), JSamplingParams
    return Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **kw}), SamplingParams


def _drain(eng, results, max_steps=400):
    steps = 0
    while eng.has_work():
        results.extend(eng.step())
        steps += 1
        assert steps < max_steps, "engine wedged"
    eng.flush_kv_migrations()
    return results


@pytest.mark.parametrize("quant", [0, 8, 4], ids=["fp", "int8", "int4"])
def test_preempt_round_trip_token_identical_as_jax(model, quant):
    """The victim parks to host, the protected request admits, the victim
    resumes by prefix share (and fault-in) and finishes with the tokens of
    an unloaded reference and of the JAX engine; exactly one park and one
    resume, no prompt token recomputed, park events consumed once, every
    counter equal to JAX's, all pages free."""
    ref_eng, sp_cls = _side(model, "port", kv_quant=quant, kv_tier="off", preempt="off")
    ref = {name: ref_eng.generate([p], sp_cls(max_tokens=8 if name == "hot" else 16,
                                              temperature=0.0))[0].output_tokens
           for name, p in PROMPTS.items()}
    out = {}
    for side in ("jax", "port"):
        eng, cls = _side(model, side, kv_quant=quant)
        results = []
        rids = {name: eng.add_request(PROMPTS[name], cls(max_tokens=16, temperature=0.0),
                                      priority="batch") for name in ("b0", "b1")}
        for _ in range(3):
            results.extend(eng.step())
        assert eng.num_running == 2 and not eng._free_rows
        rids["hot"] = eng.add_request(PROMPTS["hot"], cls(max_tokens=8, temperature=0.0))
        _drain(eng, results)
        events = eng.drain_park_events()
        assert eng.drain_park_events() == []  # consumed once
        by_id = {r.request_id: r for r in results}
        out[side] = {
            "tokens": {n: by_id[r].output_tokens for n, r in rids.items()},
            "preempted": {n: by_id[r].preempted for n, r in rids.items()},
            "prompts": {n: by_id[r].prompt_tokens for n, r in rids.items()},
            "events": [next(n for n, r in rids.items() if r == e) for e in events],
            "stats": [getattr(eng, s) for s in STATS],
            "free": eng._allocator.free_count == eng._allocator.num_pages,
        }
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == ref
    assert port["prompts"] == PROMPTS
    assert port["stats"][:3] == [1, port["stats"][1], 1] and port["stats"][1] > 0
    assert port["stats"][STATS.index("resume_recomputed_prompt_tokens")] == 0
    assert len(port["events"]) == 1 and port["events"][0] in ("b0", "b1")
    assert sum(port["preempted"].values()) == 1 and port["preempted"]["hot"] == 0
    assert port["free"]


def test_parked_victim_deadline_reaped_frees_both_tiers_once_as_jax(model):
    """A victim whose deadline lapses while parked (critical pressure holds
    it there) is reaped with finish_reason "deadline"; the pages it
    returned at park time are not freed twice, the pool ends whole and
    still serves -- on both engines alike."""
    out = {}
    for side in ("jax", "port"):
        eng, cls = _side(model, side)
        results = []
        prot = eng.add_request(list(range(1, 9)), cls(max_tokens=24, temperature=0.0))
        victim = eng.add_request(list(range(21, 29)), cls(max_tokens=24, temperature=0.0),
                                 priority="batch", deadline_s=time.monotonic() + 30.0)
        for _ in range(3):
            results.extend(eng.step())
        eng.set_class_pressure({"interactive": 2})
        hot = eng.add_request(list(range(41, 49)), cls(max_tokens=8, temperature=0.0))
        steps = 0
        while eng.preemptions == 0:
            results.extend(eng.step())
            steps += 1
            assert steps < 50, "saturated protected arrival never preempted"
        assert eng.drain_park_events() == [victim] and eng.num_parked == 1
        eng._parked[0].deadline_ts = time.monotonic() - 1.0  # lapses while parked
        results.extend(eng.step())
        assert eng.num_parked == 0 and eng.deadline_reaps == 1
        eng.set_class_pressure({})
        _drain(eng, results)
        by_id = {r.request_id: r for r in results}
        assert eng._allocator.free_count == eng._allocator.num_pages
        after = eng.generate([list(range(61, 69))], cls(max_tokens=4, temperature=0.0))[0]
        assert eng._allocator.free_count == eng._allocator.num_pages
        out[side] = ([by_id[r].finish_reason for r in (prot, victim, hot)],
                     by_id[victim].preempted, by_id[victim].output_tokens,
                     [by_id[r].output_tokens for r in (prot, hot)], after.output_tokens,
                     [getattr(eng, s) for s in STATS])
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["length", "deadline", "length"] and out["port"][1] == 1


def test_admission_ladder_as_jax(model):
    """Protected arrivals queue ahead of batch waiters; warn pressure
    doubles the batch headroom (the gate holds, then opens when pressure
    clears); critical pressure pauses batch admission while protected
    traffic admits."""
    out = {}
    for side in ("jax", "port"):
        trace = []
        eng, cls = _side(model, side, max_num_seqs=1)
        sp = cls(max_tokens=4, temperature=0.0)
        eng.add_request(list(range(1, 5)), sp, priority="batch")
        b = eng.add_request(list(range(11, 15)), sp, priority="batch")
        hot = eng.add_request(list(range(21, 25)), sp)
        order = [r.request_id for r in eng._waiting]
        trace.append(order.index(hot) < order.index(b))
        trace.append(sorted(r.output_tokens for r in _drain(eng, [])))

        eng, cls = _side(model, side, num_pages=8, preempt="off", preempt_headroom_pages=3)
        sp = cls(max_tokens=4, temperature=0.0)
        eng.set_class_pressure({"interactive": 1})
        rid = eng.add_request(list(range(1, 9)), sp, priority="batch")
        first = eng.step()
        trace.append((first, eng.num_waiting, eng.num_running))
        eng.set_class_pressure({})
        trace.append([(r.request_id == rid, r.output_tokens) for r in _drain(eng, list(first))])

        eng, cls = _side(model, side)
        sp = cls(max_tokens=4, temperature=0.0)
        eng.set_class_pressure({"interactive": 2})
        b = eng.add_request(list(range(1, 9)), sp, priority="batch")
        hot = eng.add_request(list(range(21, 29)), sp)
        first = eng.step()
        trace.append((eng.num_running, [r.request_id == b for r in first],
                      any(r.request_id == b for r in eng._waiting)))
        eng.set_class_pressure({"interactive": 0})
        done = {r.request_id: r.output_tokens for r in _drain(eng, list(first))}
        trace.append((done[b], done[hot], eng.admission_blocked_steps))
        out[side] = trace
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port[0] is True
    assert port[2][0] == [] and port[2][1:] == (1, 0)  # warn: held at the gate
    assert port[4][2] is True  # critical: batch still waiting, not shed


def test_async_engine_streams_the_parked_event_and_exports_counters(model):
    """Through AsyncEngine: the victim's stream carries a ``parked`` event
    before its tokens resume, its tokens equal an unloaded reference's,
    and the preemption counters reach ``metrics.py``'s series."""
    _, cfg, _, tp = model
    sp = SamplingParams(max_tokens=40, temperature=0.0)
    ref_eng, _ = _side(model, "port", kv_tier="off", preempt="off", decode_burst=1)
    ref = {n: ref_eng.generate([p], sp)[0].output_tokens for n, p in PROMPTS.items()}
    eng, _ = _side(model, "port", decode_burst=1, num_pages=32)
    replica = "preempt-test"
    before = metrics.counter_value(metrics.ENGINE_PREEMPTIONS, replica=replica)

    async def run():
        aeng = AsyncEngine(eng, replica=replica)
        events = {"b0": [], "b1": []}
        started = asyncio.Event()

        async def batch(name):
            async for ev in aeng.stream(PROMPTS[name], sp, priority="batch"):
                events[name].append(ev.type)
                if ev.type == "token":
                    started.set()
                if ev.type == "final":
                    return ev.result

        try:
            tasks = [asyncio.ensure_future(batch(n)) for n in ("b0", "b1")]
            await asyncio.wait_for(started.wait(), 30)
            while eng.num_running < 2:
                await asyncio.sleep(0.001)
            hot = await asyncio.wait_for(aeng.generate(PROMPTS["hot"], sp), 60)
            results = await asyncio.wait_for(asyncio.gather(*tasks), 60)
            return events, dict(zip(("b0", "b1"), results)), hot
        finally:
            await aeng.stop()

    events, res, hot = asyncio.run(run())
    assert hot.output_tokens == ref["hot"]
    assert {n: r.output_tokens for n, r in res.items()} == {n: ref[n] for n in ("b0", "b1")}
    parked = [n for n, evs in events.items() if "parked" in evs]
    assert parked == [n for n, r in res.items() if r.preempted] and len(parked) == 1
    evs = events[parked[0]]
    assert evs.count("parked") == 1 and evs[-1] == "final"
    assert evs.index("parked") < len(evs) - 2  # tokens came after the park
    assert eng.preemptions == eng.preempt_resumes == 1
    assert metrics.counter_value(metrics.ENGINE_PREEMPTIONS, replica=replica) == before + 1
    assert metrics.counter_value(metrics.ENGINE_PREEMPT_RESUMES, replica=replica) >= 1
