"""The port's host KV tier against the JAX package (CPU, float32):
``TieredPageAllocator`` driven through the same operation sequences with
equal state after every operation, ``gather_pages`` / ``scatter_pages`` on
the same pools (the port's padding lands on its drop page), and the
engine's writeback / eviction / fault-in round trip, deadline reap, dedup
hold and page export over fp, int8 and int4 pages, token for token and
counter for counter.  Page codes are compared exactly; float32 pages
written by the model to 1e-4 relative and 1e-5 absolute, their page
scales to 1e-5 relative (the two frameworks' summation orders through
the layers)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.ops.page_migration import (
    gather_pages as j_gather_pages,
    migrate_buckets as j_migrate_buckets,
    scatter_pages as j_scatter_pages,
)
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu.serving import kv_cache as jkv
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.ops.page_migration import (
    gather_pages,
    migrate_buckets,
    scatter_pages,
    split_page_payloads,
)
from githubrepostorag_tpu_torch.serving import Engine, SamplingParams
from githubrepostorag_tpu_torch.serving import kv_cache as tkv

# the JAX tier tests' geometry: a 12-page pool of 4-token pages, so one
# 40-token filler oversubscribes it
GEOM = dict(max_num_seqs=2, num_pages=12, page_size=4, max_seq_len=64, prefill_chunk=16,
            decode_burst=4, kv_tier="on", kv_host_pool_pages=32)
QUANTS = [0, 8, 4]


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _engines(model, **kw):
    jcfg, cfg, jp, tp = model
    return (JEngine(jp, jcfg, kv_dtype=jnp.float32, **{**GEOM, **kw}),
            Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **kw}))


# ------------------------------------------------------------ allocator --

_STATE = ("_free", "_rc", "_hash_to_page", "_page_to_hash", "_wb_inflight", "_claims",
          "_park_queue", "fault_ins", "preempt_parked_pages", "writebacks", "dedup_hits",
          "host_evictions", "tier_drops", "page_imports", "import_dedup_skips", "hit_tokens")


def _state(al) -> dict:
    out = {name: getattr(al, name) for name in _STATE}
    out["_lru"] = list(al._lru)
    out["_host"] = list(al._host)  # keys, in LRU order
    out["_park_queue"] = list(al._park_queue)
    out["staged"] = [(p, pl) for p, pl in al._staged_faults]
    for name in ("free_count", "plain_free_count", "host_pages", "pending_park_writebacks"):
        out[name] = getattr(al, name)
    out["pending_all"] = al.pending_claim_pages()
    return out


def _fuzz_ops(seed: int, n_ops: int = 400):
    """One random operation sequence over a small pool: allocations,
    registrations, shares, releases, parks, evictions, writebacks,
    fault-ins, claims, imports and can_admit queries."""
    rng = np.random.default_rng(seed)
    chains = [tkv.page_hashes(rng.integers(0, 50, 4 * n).tolist(), 4) for n in (2, 3, 4, 5)]
    hashes = [h for c in chains for h in c]
    return rng, chains, hashes


def _apply(al, op, args):
    if op == "allocate":
        try:
            return al.allocate(args)
        except (tkv.OutOfPages, jkv.OutOfPages):
            return "oop"
    return getattr(al, op)(*args) if isinstance(args, tuple) else getattr(al, op)(args)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiered_allocator_matches_jax_over_random_operation_sequences(seed):
    """The two classes take the same random sequence of operations; every
    return value and the whole state (free list, refcounts, maps, LRU and
    host order, in-flight, claims, park queue, staged fault-ins, every
    counter) are equal after each one."""
    rng, chains, hashes = _fuzz_ops(seed)
    sides = [tkv.TieredPageAllocator(8, host_pool_pages=6, migrate_burst=3),
             jkv.TieredPageAllocator(8, host_pool_pages=6, migrate_burst=3)]
    held: list[list[int]] = []  # block tables both sides hold alike
    in_flight: list = []
    for step in range(400):
        op = rng.choice(["allocate", "register", "share", "release", "park", "evict",
                         "land", "fault_in", "claim", "unclaim", "import", "can_admit",
                         "pending"])
        chain = chains[int(rng.integers(len(chains)))]
        if op == "allocate":
            calls = [("allocate", int(rng.integers(0, 4)))]
        elif op == "register" and held:
            pages = held[int(rng.integers(len(held)))]
            j = int(rng.integers(len(pages)))
            calls = [("register", (hashes[int(rng.integers(len(hashes)))], pages[j]))]
        elif op == "share":
            calls = [("share", chain[: int(rng.integers(1, len(chain) + 1))])]
        elif op in ("release", "park") and held:
            calls = [(op, held.pop(int(rng.integers(len(held)))))]
        elif op == "evict":
            calls = [("evict", int(rng.integers(1, 4)))]
        elif op == "land" and in_flight:
            h = in_flight.pop(0)
            calls = [("complete_writeback", (h, ("payload", h)))]
        elif op == "fault_in":
            calls = [("fault_in", ())]
        elif op in ("claim", "unclaim"):
            calls = [(op, chain[: int(rng.integers(1, len(chain) + 1))])]
        elif op == "import":
            h = hashes[int(rng.integers(len(hashes)))]
            calls = [("import_page", (h, ("payload", h)))]
        elif op == "can_admit":
            calls = [("can_admit", (chain, int(rng.integers(0, 8)), int(rng.integers(0, 2)),
                                    int(rng.integers(0, 3))))]
        elif op == "pending":
            calls = [("pending_claim_pages", (chain,))]
        else:
            continue
        for name, args in calls:
            outs = [_apply(al, name, args) for al in sides]
            assert outs[0] == outs[1], (step, name, args)
            if name in ("allocate", "share") and outs[0] not in ("oop", []):
                held.append(outs[0])
            if name == "evict":
                in_flight.extend(h for _, h in outs[0])
        assert _state(sides[0]) == _state(sides[1]), (step, op)


def test_headroom_and_need_zero_on_every_allocator_as_jax():
    """can_admit's headroom, duplicate-hash and need=0 edges on the three
    allocators: the same answers as the JAX allocators."""
    h = tkv.page_hashes(list(range(8)), 4)
    for t_cls, j_cls in ((tkv.PageAllocator, jkv.PageAllocator),
                         (tkv.PrefixCachingAllocator, jkv.PrefixCachingAllocator),
                         (tkv.TieredPageAllocator, jkv.TieredPageAllocator)):
        sides = [t_cls(4), j_cls(4)]
        for al in sides:
            pages = al.allocate(2)
            if hasattr(al, "register"):
                al.register(h[0], pages[0])
                al.release(pages)
        for need in range(0, 5):
            for headroom in range(0, 4):
                for hashes in ([], h, h + h):
                    answers = [al.can_admit(hashes, need, 0, headroom) for al in sides]
                    assert answers[0] == answers[1], (t_cls.__name__, need, headroom)


# ---------------------------------------------------------- migration ops --


def _pools(quant, rng, L=2, n_kv=2, P=6, ps=4, hd=8):
    shape = (L, n_kv, P, ps, hd)
    if quant == 0:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        return k, v, None, None
    if quant == 8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    else:
        k, v = (rng.integers(0, 256, (*shape[:-1], hd // 2)).astype(np.uint8) for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.2, shape[:3]).astype(np.float32) for _ in range(2))
    return k, v, ks, vs


def _drop(x):
    return None if x is None else torch.from_numpy(
        np.concatenate([x, np.zeros_like(x[:, :, :1])], axis=2))


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8", "int4"])
def test_gather_and_scatter_pages_match_jax(quant):
    """A padded burst (page 2 real, three -1 rows): the gather's real rows
    equal JAX's, the scatter writes page 2 and nothing else -- the JAX
    pools' last page above all -- and the port's padding rows land on its
    drop page, which no block table references."""
    rng = np.random.default_rng(17 + quant)
    k, v, ks, vs = _pools(quant, rng)
    P = k.shape[2]
    idx = np.asarray([2, -1, -1, -1], np.int32)
    payload = _pools(quant, rng, P=4)
    assert migrate_buckets(8) == j_migrate_buckets(8) == [1, 2, 4, 8]
    assert migrate_buckets(6) == j_migrate_buckets(6)

    j_out = j_scatter_pages(jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
                            jnp.asarray(payload[0]),
                            *(None if x is None else jnp.asarray(x) for x in (ks, vs)),
                            v_vals=jnp.asarray(payload[1]),
                            ks_vals=None if quant == 0 else jnp.asarray(payload[2]),
                            vs_vals=None if quant == 0 else jnp.asarray(payload[3]))
    t_pools = [_drop(x) for x in (k, v, ks, vs)]
    scatter_pages(t_pools[0], t_pools[1], torch.from_numpy(idx), torch.from_numpy(payload[0]),
                  t_pools[2], t_pools[3], v_vals=torch.from_numpy(payload[1]),
                  ks_vals=None if quant == 0 else torch.from_numpy(payload[2]),
                  vs_vals=None if quant == 0 else torch.from_numpy(payload[3]))
    for t, j, before in zip(t_pools, j_out, (k, v, ks, vs)):
        if before is None:
            continue
        np.testing.assert_array_equal(t[:, :, :P].numpy(), np.asarray(j))
        np.testing.assert_array_equal(t[:, :, P - 1].numpy(), before[:, :, P - 1])
    np.testing.assert_array_equal(t_pools[0][:, :, P].numpy(), payload[0][:, :, 3])  # a padding row

    j_g = j_gather_pages(*(jnp.asarray(np.asarray(x)) for x in j_out[:2]), jnp.asarray(idx),
                         *(None if x is None else jnp.asarray(x) for x in j_out[2:]))
    t_g = gather_pages(*t_pools[:2], torch.from_numpy(idx), *t_pools[2:])
    for t, j in zip(t_g, j_g):
        if t is None:
            assert j is None
            continue
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # padding clamps to page 0
    pay = split_page_payloads(tuple(t_g) + (None, None), 1)[0]
    np.testing.assert_array_equal(pay[0].numpy(), payload[0][:, :, 0])
    assert pay[4] is None and pay[5] is None


# ---------------------------------------------------------------- engine --


def _same_payload(t_pay, j_pay) -> None:
    """A page payload (k, v, k scales, v scales, draft k, draft v) against
    JAX's: int8 / int4 codes exactly, f32 pages to 1e-4 relative, page
    scales (the amax of a first write) to 1e-5 relative."""
    for i, (t, j) in enumerate(zip(t_pay, j_pay)):
        if t is None:
            assert j is None
        elif i >= 2:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=0)
        elif t.dtype != torch.float32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8", "int4"])
def test_evicted_prefix_faults_in_token_identical_as_jax(model, quant):
    """The tier's round trip: a prefix registered, written back to host,
    its device copies reclaimed by an oversubscribing filler, then
    re-admitted by fault-in.  Tokens equal an untiered engine's and the
    JAX engine's; writebacks, tier drops, fault-ins, dispatches, faulted
    pages and every tier counter equal JAX's; the pool balances.  The
    faulted pages' payloads equal the pages written back, byte for byte."""
    _, cfg, _, tp = model
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()  # 6 pages
    filler = rng.integers(0, cfg.vocab_size, size=40).tolist()  # 10 pages
    sp = dict(max_tokens=4, temperature=0.0, repetition_penalty=1.2)
    ref = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", kv_quant=quant,
                 **{**GEOM, "kv_tier": "off", "prefix_caching": False})
    expect = ref.generate([prompt], SamplingParams(**sp))[0].output_tokens
    je, te = _engines(model, kv_quant=quant)
    out = {}
    for side, eng, cls in (("jax", je, JSamplingParams), ("port", te, SamplingParams)):
        first = eng.generate([prompt], cls(**sp))[0].output_tokens
        eng.flush_kv_migrations()
        saved = {h: eng._allocator._host[h] for h in list(eng._allocator._host)}
        eng.generate([filler], cls(**sp))
        res = eng.generate([prompt], cls(**sp))[0]
        al = eng._allocator
        out[side] = dict(first=first, tokens=res.output_tokens, faulted=res.faulted_pages,
                         counters=[al.writebacks, al.tier_drops, al.fault_ins, al.dedup_hits,
                                   al.host_evictions, al.host_pages, eng.kv_fault_dispatches,
                                   eng.kv_migrations, eng.dedup_holds, al.free_count],
                         saved=saved)
        assert al.free_count == al.num_pages and not eng.has_work()
    assert out["port"]["first"] == out["port"]["tokens"] == expect
    assert out["port"]["tokens"] == out["jax"]["tokens"]
    assert out["port"]["counters"] == out["jax"]["counters"]
    assert out["port"]["faulted"] == out["jax"]["faulted"] > 0
    assert list(out["port"]["saved"]) == list(out["jax"]["saved"])
    for h, t_pay in out["port"]["saved"].items():
        j_pay = out["jax"]["saved"][h]
        _same_payload(t_pay, j_pay)
    # the faulted pages hold the bytes that were written back
    for h, pay in out["port"]["saved"].items():
        page = te._allocator._hash_to_page.get(h)
        if page is not None:
            torch.testing.assert_close(te._k_pages[:, :, page], pay[0], rtol=0, atol=0)


def test_deadline_reap_frees_both_tiers_as_jax(model):
    """A request reaped mid-prefill right after its prefix faulted in
    returns every device page and drops its claims on both engines; the
    host copies stay as cache."""
    _, cfg, _, _ = model
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()
    filler = rng.integers(0, cfg.vocab_size, size=40).tolist()
    tail = rng.integers(0, cfg.vocab_size, size=16).tolist()
    out = {}
    for side, eng, cls in zip(("jax", "port"), _engines(model, prefill_chunk=8),
                              (JSamplingParams, SamplingParams)):
        eng.generate([prompt], cls(max_tokens=8, temperature=0.0))
        eng.flush_kv_migrations()
        eng.generate([filler], cls(max_tokens=8, temperature=0.0))
        rid = eng.add_request(prompt + tail, cls(max_tokens=4, temperature=0.0),
                              deadline_s=time.monotonic() + 60.0)
        req = eng._requests[rid]
        eng.step()
        assert req.faulted_pages > 0 and req.claimed_hashes
        req.deadline_ts = time.monotonic() - 1.0
        finished = []
        while eng.has_work():
            finished.extend(eng.step())
        al = eng._allocator
        out[side] = ([r.finish_reason for r in finished], al.free_count, al._claims,
                     al._staged_faults, al.host_pages, eng.deadline_reaps, eng.reaped_tokens)
        assert al.free_count == al.num_pages and al.host_pages > 0
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["deadline"]


def test_dedup_hold_waits_for_inflight_twin_as_jax(model):
    """An identical-prefix follower admitted while its leader prefills
    holds for one registration instead of duplicating the footprint: the
    same holds, dedup hits and tokens as the JAX engine."""
    _, cfg, _, _ = model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=32).tolist()
    out = {}
    for side, eng, cls in zip(("jax", "port"), _engines(model, prefill_chunk=8),
                              (JSamplingParams, SamplingParams)):
        res = eng.generate([prompt, prompt], cls(max_tokens=4, temperature=0.0))
        out[side] = ([r.output_tokens for r in res], eng.dedup_holds,
                     eng._allocator.dedup_hits, eng._allocator.hit_tokens)
        assert eng._allocator.free_count == eng._allocator.num_pages
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == out["port"][0][1] and out["port"][1] > 0


@pytest.mark.parametrize("quant", [8, 4], ids=["int8", "int4"])
def test_exported_pages_import_and_serve_as_jax(model, quant):
    """export_kv_pages packs a cached prefix (device gathers and host
    copies) with the JAX engine's payload bytes; a second port engine
    imports them and serves the prompt by fault-in, token-identical."""
    _, cfg, _, _ = model
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=24).tolist()
    hashes = tkv.page_hashes(prompt, 4)
    exported = {}
    for side, eng, cls in zip(("jax", "port"), _engines(model, kv_quant=quant),
                              (JSamplingParams, SamplingParams)):
        want = eng.generate([prompt], cls(max_tokens=4, temperature=0.0))[0].output_tokens
        exported[side] = eng.export_kv_pages(hashes)
        assert eng.kv_pages_exported == len(exported[side]) == len(hashes)
    for (th, tp_), (jh, jp_) in zip(exported["port"], exported["jax"]):
        assert th == jh
        _same_payload(tp_, jp_)
    _, te2 = _engines(model, kv_quant=quant)
    assert te2.import_kv_pages(exported["port"]) == len(hashes)
    res = te2.generate([prompt], SamplingParams(max_tokens=4, temperature=0.0))[0]
    assert res.output_tokens == want and res.faulted_pages == 5  # (24 - 1) // 4 shareable
    assert te2._allocator.free_count == te2._allocator.num_pages


def test_tier_warmup_and_flush_leave_the_engine_clean(model):
    """warmup() runs a gather and a scatter at every burst size (all
    padding: only the drop page is written) and flush_kv_migrations is a
    no-op on an untiered engine."""
    _, cfg, _, tp = model
    te = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", kv_quant=4, **GEOM)
    sizes = []
    real = te._allocator.evict
    te.warmup()
    assert not te.has_work() and te._allocator.free_count == te._allocator.num_pages
    assert te.kv_fault_dispatches == 0 and real is not None
    plain = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu",
                   **{**GEOM, "kv_tier": "off", "kv_host_pool_pages": 0})
    plain.flush_kv_migrations()
    assert plain.kv_migrations == 0 and not isinstance(plain._allocator, tkv.TieredPageAllocator)
    assert sizes == []


class _Recorder:
    """A page observer that records what it is told, or raises."""

    def __init__(self, fail: bool = False) -> None:
        self.events: list[tuple] = []
        self.fail = fail

    def _note(self, *event) -> None:
        if self.fail:
            raise RuntimeError("observer down")
        self.events.append(event)

    def on_claims(self, delta):
        self._note("claims", delta)

    def on_tier_event(self, kind, n):
        self._note(kind, n)

    def on_request_hold(self, rid, klass, pages):
        self._note("hold", klass, pages)

    def on_request_release(self, rid):
        self._note("release")


def test_page_observer_sees_the_jax_engines_events(model):
    """``attach_page_observer``: the allocator's claim deltas and tier
    events and the engine's holds and releases reach an attached observer
    in the order the JAX engine reports them, over the tier's round trip;
    an observer that raises changes no token."""
    _, cfg, _, _ = model
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()
    filler = rng.integers(0, cfg.vocab_size, size=40).tolist()
    out = {}
    for fail in (False, True):
        for side, eng, cls in zip(("jax", "port"), _engines(model),
                                  (JSamplingParams, SamplingParams)):
            obs = _Recorder(fail)
            eng.attach_page_observer(obs)
            toks = []
            for batch in ([prompt], [filler], [prompt]):
                toks += [r.output_tokens for r in eng.generate(batch, cls(max_tokens=4,
                                                                          temperature=0.0))]
                eng.flush_kv_migrations()
            out[side, fail] = (toks, obs.events)
    assert out["port", False] == out["jax", False]
    kinds = {e[0] for e in out["port", False][1]}
    assert {"claims", "hold", "release", "writeback", "fault_in"} <= kinds
    assert out["port", True][0] == out["port", False][0] and out["port", True][1] == []
