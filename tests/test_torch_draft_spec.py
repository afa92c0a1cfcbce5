"""The port's draft-model speculation against the JAX package's (CPU,
float32): ``draft_spec_burst`` call for call (tokens and proposals exactly,
both pools to 1e-5), and the engine's draft mode in every case of
``tests/test_draft_spec.py`` -- perfect and disagreeing drafts, a stop
inside an accepted run, a mixed batch demoting to plain decode, a prefix
hit admitted mid-run, acceptance collapse and deadline pressure falling
back, the k ladder -- token for token and counter for counter (proposed,
accepted, fallbacks by reason, the per-request accounting), with the same
``ValueError`` messages.  Also: packed prefill and int8 target pages under
the draft, the host tier moving both pools (draft pages byte-equal after a
fault-in, acceptance equal to the first serve's), the export payload, and
warmup covering every dispatch shape (the compile watchdog counts 0 across
mixed draft / plain traffic)."""

from __future__ import annotations

import asyncio
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.models.quant import fuse_projections as j_fuse
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu.serving.draft_spec import draft_spec_burst as j_draft_spec_burst
from githubrepostorag_tpu_torch import metrics
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.quant import fuse_projections
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams
from githubrepostorag_tpu_torch.serving.draft_spec import draft_spec_burst

# the JAX draft tests' geometry
GEOM = dict(max_num_seqs=2, num_pages=32, page_size=4, max_seq_len=64, decode_burst=4)


def _pair(jcfg, cfg, jp):
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The JAX tests' target and an independently drawn draft, f32."""
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    target = _pair(jcfg, cfg, j_init(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    draft = _pair(jcfg, cfg, j_init(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32))
    return target, draft


@pytest.fixture(scope="module")
def narrators():
    """Zero-layer narrators of the JAX collapse test: the target continues
    t -> t+1, the draft t -> t+2, so every proposal disagrees."""
    jcfg = dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False)
    cfg = dataclasses.replace(Qwen2Config.tiny(), tie_word_embeddings=False)
    out = []
    for key, shift in ((5, 1), (6, 2)):
        p = j_init(jcfg, jax.random.PRNGKey(key), dtype=jnp.float32)
        p = dict(p, layers=jax.tree.map(jnp.zeros_like, p["layers"]),
                 lm_head=jnp.roll(p["embed"], shift, axis=0).T)
        out.append(_pair(jcfg, cfg, p))
    return out


def _engines(target, draft, **kw):
    jcfg, cfg, jt, tt = target
    geom = {**GEOM, **kw}
    je = JEngine(jt, jcfg, kv_dtype=jnp.float32, draft_params=draft[2], draft_cfg=draft[0],
                 **geom)
    te = Engine(tt, cfg, kv_dtype=torch.float32, device="cpu", draft_params=draft[3],
                draft_cfg=draft[1], **geom)
    return je, te


def _plain(target, **kw):
    jcfg, cfg, jt, tt = target
    return Engine(tt, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **kw})


COUNTERS = ("spec_proposed", "spec_accepted", "spec_fallbacks", "step_dispatches_total",
            "committed_tokens", "prefill_tokens")


def _summary(res):
    return [(r.output_tokens, r.finish_reason, r.spec_proposed, r.spec_accepted,
             r.spec_fallback) for r in res]


def _serve_both(je, te, prompts, sps, **add):
    """The same requests through both engines' step loops; returns each
    side's results and counters."""
    out = {}
    for side, eng, cls in (("jax", je, JSamplingParams), ("port", te, SamplingParams)):
        rids = [eng.add_request(p, cls(**sp), **add) for p, sp in zip(prompts, sps)]
        done = {}
        while eng.has_work():
            done.update({r.request_id: r for r in eng.step()})
        out[side] = ([done[r] for r in rids], {c: getattr(eng, c) for c in COUNTERS})
        assert eng._allocator.free_count == eng._allocator.num_pages and not eng.has_work()
    return out


# ------------------------------------------------------------- the burst --

def _burst_case(cfg, quant, rng):
    """Both pools with content, four compacted rows (one a page short of
    its limit, one inactive padding row with a zero block table)."""
    ps, num_pages = 4, 24
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, ps, cfg.head_dim)
    if quant == 0:
        kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        scales = []
    else:
        half = (*shape[:-1], cfg.head_dim // 2)
        kp, vp = (rng.integers(0, 256, half).astype(np.uint8) for _ in range(2))
        scales = [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32) for _ in range(2)]
    dkp, dvp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bt = np.asarray([[3, 9, 15, 2, 20, 21], [7, 1, 4, 5, 0, 0], [11, 12, 13, 0, 0, 0],
                     [0, 0, 0, 0, 0, 0]], dtype=np.int32)
    h = 40
    hist = np.zeros((4, h), dtype=np.int32)
    hist[0, :14] = rng.integers(0, cfg.vocab_size, 14)
    hist[1, :9] = rng.integers(0, cfg.vocab_size, 9)
    hist[2, :10] = rng.integers(0, cfg.vocab_size, 10)
    hlens = np.asarray([14, 9, 10, 0], dtype=np.int32)
    lens = np.maximum(hlens - 1, 0).astype(np.int32)
    limits = np.asarray([24, 16, 12, 0], dtype=np.int32)  # row 2: 3 slots left
    active = np.asarray([True, True, True, False])
    return dict(kp=kp, vp=vp, dkp=dkp, dvp=dvp, scales=scales, bt=bt, hist=hist, hlens=hlens,
                lens=lens, limits=limits, active=active, num_pages=num_pages)


def _with_drop(x):
    """The port's pools carry one extra page, the drop page."""
    return torch.from_numpy(np.concatenate([x, np.zeros_like(x[:, :, :1])], axis=2))


@pytest.mark.parametrize("models,quant", [("pair", 0), ("pair", 4), ("narrators", 0)])
def test_draft_spec_burst_matches_jax(pair, narrators, models, quant):
    """Tokens and proposals exactly, both pools after the burst (codes
    exactly, floats to 1e-5) against the JAX burst; the drop pages took
    every write past a row's limit and nothing else moved."""
    target, draft = pair if models == "pair" else narrators
    jcfg, cfg, jt, tt = target
    case = _burst_case(cfg, quant, np.random.default_rng(quant + 3))
    keys = ("hist", "hlens", "lens")
    scale_kw = dict(zip(("k_scales", "v_scales"), map(jnp.asarray, case["scales"])))
    j_out = j_draft_spec_burst(
        j_fuse(jt), j_fuse(draft[2]), jcfg, draft[0], *(jnp.asarray(case[x]) for x in keys),
        *(jnp.asarray(case[x]) for x in ("kp", "vp", "dkp", "dvp")),
        *(jnp.asarray(case[x]) for x in ("bt", "limits", "active")),
        n_iters=3, k=3, use_pallas=False, **scale_kw)
    pools = [_with_drop(case[x]) for x in ("kp", "vp", "dkp", "dvp")]
    scales = [_with_drop(s) for s in case["scales"]]
    drop_before = [p[:, :, -1].clone() for p in pools[2:]]
    t_out = draft_spec_burst(
        fuse_projections(tt), fuse_projections(draft[3]), cfg, draft[1],
        *(torch.from_numpy(case[x]) for x in keys), *pools,
        *(torch.from_numpy(case[x]) for x in ("bt", "limits", "active")), n_iters=3, k=3,
        **dict(zip(("k_scales", "v_scales"), scales)))
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    assert t_out[1].numpy().sum() > 0 and (t_out[0].numpy()[3] == -1).all()
    n = case["num_pages"]
    for t, j in zip(pools + scales, list(j_out[2:6]) + list(j_out[6:])):
        t = t[:, :, :n].numpy()
        if t.dtype != np.float32:
            np.testing.assert_array_equal(t, np.asarray(j))
        else:
            np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=1e-5)
    if models == "pair":
        # row 2 ran into its limit: its step-k writes went to the drop page
        # (the zero-layer narrators write zeros there)
        assert any(not torch.equal(p[:, :, -1], b) for p, b in zip(pools[2:], drop_before))
    else:
        assert (t_out[0].numpy()[:3, :, 1] == -1).all()  # nothing accepted


# ------------------------------------------------------ construction --

@pytest.mark.parametrize("bad", ["draft_only", "vocab", "ngram", "spec_k", "spec_iters",
                                 "fused"])
def test_construction_errors_match_jax(pair, bad):
    target, draft = pair
    jcfg, cfg, jt, tt = target
    big_j = dataclasses.replace(jcfg, vocab_size=jcfg.vocab_size + 1)
    big_t = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
    kw = {"draft_only": ({"draft_params": draft[2]}, {"draft_params": draft[3]}),
          "vocab": ({"draft_params": draft[2], "draft_cfg": big_j},
                    {"draft_params": draft[3], "draft_cfg": big_t}),
          "ngram": ({"draft_params": draft[2], "draft_cfg": jcfg, "spec_ngram_k": 4},
                    {"draft_params": draft[3], "draft_cfg": cfg, "spec_ngram_k": 4}),
          "spec_k": ({"draft_params": draft[2], "draft_cfg": jcfg, "spec_k": 0},
                     {"draft_params": draft[3], "draft_cfg": cfg, "spec_k": 0}),
          "spec_iters": ({"draft_params": draft[2], "draft_cfg": jcfg, "spec_iters": 0},
                         {"draft_params": draft[3], "draft_cfg": cfg, "spec_iters": 0}),
          "fused": ({"draft_params": draft[2], "draft_cfg": jcfg, "spec_ngram_k": 2,
                     "spec_burst_iters": 2, "fused_step": True, "prefill_token_budget": 32},
                    {"draft_params": draft[3], "draft_cfg": cfg, "spec_ngram_k": 2,
                     "spec_burst_iters": 2, "fused_step": True, "prefill_token_budget": 32})}[bad]
    with pytest.raises(ValueError) as j_err:
        JEngine(jt, jcfg, kv_dtype=jnp.float32, **GEOM, **kw[0])
    with pytest.raises(ValueError) as t_err:
        Engine(tt, cfg, kv_dtype=torch.float32, device="cpu", **GEOM, **kw[1])
    assert str(t_err.value) == str(j_err.value)


def test_draft_pools_and_ladder_as_jax(pair):
    target, draft = pair
    je, te = _engines(target, draft, spec_k=4, kv_quant=8)
    assert te._spec_k_ladder == je._spec_k_ladder == [1, 2, 4]
    assert te._dk_pages.dtype == torch.float32 and te._k_pages.dtype == torch.int8
    assert te._dk_pages.shape[2] == te._k_pages.shape[2] == GEOM["num_pages"] + 1
    assert tuple(te._dk_pages.shape[:2]) == tuple(je._dk_pages.shape[:2])
    assert _engines(target, draft, spec_k=6)[1]._spec_k_ladder == [1, 2, 4, 6]


# ---------------------------------------------------------------- engine --

def test_perfect_draft_matches_jax(pair):
    """Draft == target: everything accepted, tokens equal plain decoding's."""
    target, _ = pair
    prompt = list(range(1, 13))
    sp = dict(max_tokens=24, temperature=0.0, stop_token_ids=())
    plain = _plain(target).generate([prompt], SamplingParams(**sp))[0].output_tokens
    je, te = _engines(target, target, spec_k=4, spec_iters=2)
    out = _serve_both(je, te, [prompt], [sp])
    assert _summary(out["port"][0]) == _summary(out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    res = out["port"][0][0]
    assert res.output_tokens == plain and res.spec_fallback is None
    assert te.spec_accepted / te.spec_proposed > 0.8 and res.spec_proposed == te.spec_proposed


def test_disagreeing_draft_matches_jax(pair):
    target, draft = pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, target[1].vocab_size, n).tolist() for n in (9, 14)]
    sp = dict(max_tokens=16, temperature=0.0, stop_token_ids=())
    plain = _plain(target).generate(prompts, SamplingParams(**sp))
    je, te = _engines(target, draft, spec_k=2, spec_iters=2, spec_accept_floor=0.0)
    out = _serve_both(je, te, prompts, [sp, sp])
    assert _summary(out["port"][0]) == _summary(out["jax"][0])
    assert out["port"][1] == out["jax"][1] and te.spec_proposed > 0
    assert [r.output_tokens for r in out["port"][0]] == [r.output_tokens for r in plain]


def test_stop_inside_an_accepted_run_matches_jax(pair):
    target, _ = pair
    prompt = [3, 4, 5, 6, 7]
    ref = _plain(target).generate(
        [prompt], SamplingParams(max_tokens=20, temperature=0.0))[0].output_tokens
    sp = dict(max_tokens=20, temperature=0.0, stop_token_ids=(ref[6],))
    je, te = _engines(target, target, spec_k=4, spec_iters=2)
    out = _serve_both(je, te, [prompt], [sp])
    assert _summary(out["port"][0]) == _summary(out["jax"][0])
    assert out["port"][0][0].finish_reason == "stop"
    assert out["port"][0][0].output_tokens == ref[: ref.index(ref[6]) + 1]


def test_mixed_batch_demotes_then_resumes_as_jax(pair):
    """A sampled row demotes the whole dispatch to plain decode while it
    runs; the greedy row's tokens and the speculation counters equal JAX's
    (the sampled row's draws differ: the generators differ)."""
    target, _ = pair
    rng = np.random.default_rng(5)
    prompts = [list(range(2, 12)), rng.integers(0, target[1].vocab_size, 8).tolist()]
    sps = [dict(max_tokens=24, temperature=0.0, stop_token_ids=()),
           dict(max_tokens=4, temperature=0.9, stop_token_ids=())]
    plain = _plain(target).generate(prompts, [SamplingParams(**s) for s in sps])
    je, te = _engines(target, target, spec_k=2, spec_iters=2)
    out = _serve_both(je, te, prompts, sps)
    assert out["port"][0][0].output_tokens == out["jax"][0][0].output_tokens \
        == plain[0].output_tokens
    assert _summary(out["port"][0])[0][1:] == _summary(out["jax"][0])[0][1:]
    assert len(out["port"][0][1].output_tokens) == 4 and out["port"][0][1].spec_proposed == 0
    assert out["port"][1] == out["jax"][1] and te.spec_proposed > 0


def test_prefix_hit_admitted_mid_run_matches_jax(pair):
    target, _ = pair
    p1, p2 = list(range(1, 17)), list(range(1, 17)) + [20, 21]
    sp = dict(max_tokens=10, temperature=0.0, stop_token_ids=())
    out = {}
    je, te = _engines(target, target, spec_k=2, spec_iters=2)
    for side, eng, cls in (("jax", je, JSamplingParams), ("port", te, SamplingParams)):
        done = {}
        r1 = eng.add_request(p1, cls(**sp))
        done.update({r.request_id: r for r in eng.step()})
        r2 = eng.add_request(p2, cls(**sp))
        while eng.has_work():
            done.update({r.request_id: r for r in eng.step()})
        out[side] = (_summary([done[r1], done[r2]]), eng._allocator.hit_tokens,
                     {c: getattr(eng, c) for c in COUNTERS})
    assert out["port"] == out["jax"] and out["port"][1] > 0


def test_acceptance_collapse_falls_back_as_jax(narrators):
    target, draft = narrators
    prompt = [100, 101, 102]
    sp = dict(max_tokens=24, temperature=0.0, stop_token_ids=())
    je, te = _engines(target, draft, spec_k=2, spec_iters=2, spec_accept_floor=0.5)
    out = _serve_both(je, te, [prompt], [sp], deadline_s=time.monotonic() + 60.0)
    assert _summary(out["port"][0]) == _summary(out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    res = out["port"][0][0]
    assert res.output_tokens == list(range(103, 127)) and res.finish_reason == "length"
    assert res.spec_fallback == "acceptance" and te.spec_fallbacks == {"acceptance": 1}


def test_deadline_pressure_falls_back_as_jax(pair):
    target, _ = pair
    sp = dict(max_tokens=8, temperature=0.0, stop_token_ids=())
    je, te = _engines(target, target, spec_k=2, spec_iters=2, spec_deadline_margin_s=1e9)
    out = _serve_both(je, te, [list(range(1, 9))], [sp], deadline_s=time.monotonic() + 60.0)
    assert _summary(out["port"][0]) == _summary(out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0][0].spec_fallback == "deadline" and te.spec_proposed == 0
    assert te.spec_fallbacks == {"deadline": 1}


def test_pick_spec_k_matches_jax(pair):
    target, draft = pair
    je, te = _engines(target, draft, spec_k=4)

    class R:
        def __init__(self, ema):
            self.spec_accept_ema = ema

    for emas in ([None], [1.0], [0.5], [0.05], [0.3, 0.9], [None, 0.2], [0.7, 0.7, 0.1]):
        rows = [R(e) for e in emas]
        assert te._pick_spec_k(rows) == je._pick_spec_k(rows)
    assert [te._pick_spec_k([R(e)]) for e in (None, 1.0, 0.5, 0.05)] == [4, 4, 2, 1]


@pytest.mark.parametrize("mode", ["packed", "int8_pages"])
def test_draft_under_packed_prefill_and_int8_pages_matches_jax(pair, mode):
    """The packed prefill wave mirrored into the draft pools, and int8
    target pages beside full-precision draft pools: JAX's tokens and
    counters (dispatches count the draft's mirror too)."""
    target, draft = pair
    kw = {"packed": dict(prefill_token_budget=16), "int8_pages": dict(kv_quant=8)}[mode]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, target[1].vocab_size, n).tolist() for n in (11, 22)]
    sp = dict(max_tokens=10, temperature=0.0, stop_token_ids=())
    je, te = _engines(target, draft if mode == "packed" else target, spec_k=2, spec_iters=2,
                      **kw)
    out = _serve_both(je, te, prompts, [sp, sp])
    assert _summary(out["port"][0]) == _summary(out["jax"][0])
    assert out["port"][1] == out["jax"][1] and te.spec_proposed > 0


# ---------------------------------------------------------- host tier --

TIER = dict(num_pages=12, kv_tier="on", kv_host_pool_pages=32, prefill_chunk=16)


def test_host_tier_moves_both_pools(pair):
    """A prefix written back, its device pages reclaimed by a filler, then
    faulted back in: the draft pages hold the bytes written back, and the
    request's acceptance on the second serve equals its first serve's,
    as its tokens do; the JAX engine agrees on tokens and counters."""
    target, _ = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, target[1].vocab_size, size=24).tolist()  # 6 pages
    filler = rng.integers(0, target[1].vocab_size, size=40).tolist()  # 10 pages
    sp = dict(max_tokens=8, temperature=0.0, stop_token_ids=())
    je, te = _engines(target, target, spec_k=2, spec_iters=2, **TIER)
    out = {}
    for side, eng, cls in (("jax", je, JSamplingParams), ("port", te, SamplingParams)):
        first = eng.generate([prompt], cls(**sp))[0]
        eng.flush_kv_migrations()
        saved = dict(eng._allocator._host)
        eng.generate([filler], cls(**sp))
        again = eng.generate([prompt], cls(**sp))[0]
        out[side] = (_summary([first, again]), again.faulted_pages, eng._allocator.fault_ins,
                     {c: getattr(eng, c) for c in COUNTERS}, saved)
        assert eng._allocator.free_count == eng._allocator.num_pages
    assert out["port"][:4] == out["jax"][:4]
    (first, again), faulted = out["port"][0], out["port"][1]
    assert faulted > 0 and first[0] == again[0]
    assert (first[2], first[3]) == (again[2], again[3]) and first[3] > 0
    moved = 0
    for h, pay in out["port"][4].items():
        assert pay[4] is not None and pay[5] is not None  # both pools saved
        j_pay = out["jax"][4][h]
        np.testing.assert_allclose(pay[4].numpy(), np.asarray(j_pay[4]), atol=1e-5, rtol=1e-4)
        page = te._allocator._hash_to_page.get(h)
        if page is not None:
            torch.testing.assert_close(te._dk_pages[:, :, page], pay[4], rtol=0, atol=0)
            torch.testing.assert_close(te._dv_pages[:, :, page], pay[5], rtol=0, atol=0)
            moved += 1
    assert moved >= faulted


def test_export_ships_the_draft_pages(pair):
    target, _ = pair
    _, te = _engines(target, target, spec_k=2, spec_iters=2, **TIER)
    prompt = list(range(3, 27))
    te.generate([prompt], SamplingParams(max_tokens=2, temperature=0.0))
    hashes = list(te._allocator._hash_to_page)
    pages = te.export_kv_pages(hashes)
    assert len(pages) == len(hashes) > 0
    for h, pay in pages:
        page = te._allocator.device_page_of(h)
        if page is not None:
            torch.testing.assert_close(pay[4], te._dk_pages[:, :, page], rtol=0, atol=0)


# --------------------------------------------------- warmup, watchdog --

def test_warmup_covers_every_shape_and_the_watchdog_stays_zero(pair):
    """After warmup, greedy batches at both row buckets, a mixed batch (a
    plain-decode step), a prefix hit and an adaptive-k downshift through
    ``AsyncEngine`` add no dispatch shape: the watchdog counts 0; a plan
    the card has not launched counts 1.  The engine is left clean."""
    from githubrepostorag_tpu_torch.ops.fused_decode import _plan_window

    target, draft = pair
    te = _engines(target, draft, spec_k=2, spec_iters=2, spec_accept_floor=0.0)[1]
    te.warmup()
    assert not te.has_work() and te._allocator.free_count == te._allocator.num_pages
    assert {("draft", nb, k) for nb in (1, 2) for k in (1, 2)} <= te.dispatch_shapes
    warmed = set(te.dispatch_shapes)
    replica = "draft-watchdog"
    greedy = SamplingParams(max_tokens=8, temperature=0.0)
    sampled = SamplingParams(max_tokens=4, temperature=0.8)

    async def run():
        ae = AsyncEngine(te, replica=replica)
        await ae.start()
        before = metrics.counter_value(metrics.XLA_COMPILES, replica=replica)
        try:
            await ae.generate([1, 2, 3], greedy)
            await asyncio.gather(ae.generate([4, 5, 6], greedy), ae.generate([7, 8, 9], greedy))
            await asyncio.gather(ae.generate([1, 2, 3], greedy), ae.generate([4, 5, 6], sampled))
            await ae.generate(list(range(10, 18)), greedy)
            await ae.generate([1, 2, 3, 4, 9], greedy)
            live = metrics.counter_value(metrics.XLA_COMPILES, replica=replica) - before
            _plan_window(5, 3, 14, 2, 64, 128, 131)  # a shape the card never ran
            await ae.generate([2, 3, 4], greedy)
            after = metrics.counter_value(metrics.XLA_COMPILES, replica=replica) - before
        finally:
            await ae.stop()
        return live, after, ae.steps_total, ae.obs_seconds_total

    live, after, steps, obs_s = asyncio.run(run())
    assert live == 0 and after == 1 and te.dispatch_shapes == warmed
    assert steps > 0 and obs_s > 0
    assert te.spec_proposed > 0 and ("decode", te.decode_burst, False) in warmed
