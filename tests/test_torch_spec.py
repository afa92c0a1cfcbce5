"""The port's n-gram speculation against the JAX package on the same inputs
(CPU, float32): ``ngram_propose``, ``ngram_draft_device``,
``spec_decode_burst`` and ``fused_step_burst`` call for call, and the
engine's spec step, spec burst and fused step over fp, int8 and int4 KV
pages token for token, with the same speculation counters.

Two small models: the "narrator" of the JAX package's fused-step tests (an
untied ``lm_head`` that is the embedding rolled by one row, so greedy
decoding walks a deterministic, prompt-dependent path and n-gram drafts
get accepted) and the tiny config's random draw scaled x4 (varied tokens,
real pool contents).  Tolerances: tokens, proposals and page codes are
compared exactly; full-precision pages and scales to 1e-5 (float32
summation order).  Sampled rows differ from JAX's draws (the generators
differ): they are held to their sampler's support, not to a token."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.models.quant import fuse_projections as j_fuse
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu.serving.fused_step import fused_step_burst as j_fused_step_burst
from githubrepostorag_tpu.serving.spec_burst import (
    ngram_draft_device as j_ngram_draft_device,
    spec_decode_burst as j_spec_decode_burst,
)
from githubrepostorag_tpu.serving.spec_decode import ngram_propose as j_ngram_propose
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.quant import fuse_projections
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.ops import sampling as ts
from githubrepostorag_tpu_torch.serving import Engine, SamplingParams
from githubrepostorag_tpu_torch.serving import fused_step as t_fused_step_mod
from githubrepostorag_tpu_torch.serving.fused_step import fused_step_burst
from githubrepostorag_tpu_torch.serving.spec_burst import ngram_draft_device, spec_decode_burst
from githubrepostorag_tpu_torch.serving.spec_decode import ngram_propose

GEOM = dict(max_num_seqs=4, num_pages=64, page_size=8, max_seq_len=128, prefill_chunk=16,
            decode_burst=4)
QUANTS = [0, 8, 4]


@pytest.fixture(scope="module")
def narrator():
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
              head_dim=8, intermediate_size=64, tie_word_embeddings=False)
    jcfg, cfg = JConfig(**kw), Qwen2Config(**kw)
    jp = j_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jp["lm_head"] = jnp.roll(jp["embed"], 1, axis=0).T
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def scaled():
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _engines(model, **mode):
    jcfg, cfg, jp, tp = model
    return (JEngine(dict(jp), jcfg, kv_dtype=jnp.float32, **{**GEOM, **mode}),
            Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **mode}))


# ------------------------------------------------------------- proposals --


def test_ngram_propose_matches_jax_fuzz():
    """The fuzz cases of ``test_ngram_propose_matches_reference_fuzz`` (same
    seed) and the fixed cases of ``test_spec_decode.py``: every draft equal."""
    rng = np.random.default_rng(23)
    cases = [([1, 2, 3, 9, 9, 1, 2, 3], 3, 4, 1), ([1, 2, 3, 9, 9, 1, 2, 3], 1, 4, 1),
             ([5, 6, 7], 4, 4, 1), ([], 4, 4, 1), ([1], 0, 4, 1),
             ([8, 2, 3, 0, 8, 2, 5, 0, 8, 2], 1, 2, 1),
             ([1, 2, 3, 4, 7, 3, 4, 9, 1, 2, 3, 4], 1, 4, 1), ([4, 1, 7] + [9] * 12, 6, 4, 1)]
    for _ in range(2000):
        max_n = int(rng.integers(1, 6))
        toks = rng.integers(0, int(rng.integers(2, 8)), int(rng.integers(0, 40))).tolist()
        cases.append((toks, int(rng.integers(0, 6)), max_n, int(rng.integers(1, max_n + 1))))
    for toks, k, max_n, min_n in cases:
        assert (ngram_propose(toks, k, max_ngram=max_n, min_ngram=min_n)
                == j_ngram_propose(toks, k, max_ngram=max_n, min_ngram=min_n)), (toks, k)


def test_ngram_draft_device_matches_jax():
    """Random small-alphabet histories (repeats everywhere, ties between
    earlier matches) and lengths 0..H, including the < 4 rows that draft
    nothing and the row of test_spec_decode.py's fixed case."""
    rng = np.random.default_rng(7)
    b, h = 64, 24
    hist = rng.integers(0, 4, (b, h)).astype(np.int32)
    hist[0, :7] = [1, 2, 3, 9, 9, 1, 2]
    lens = rng.integers(0, h + 1, b).astype(np.int32)
    lens[:4] = [7, 3, 0, h]
    for k in (1, 4):
        t_draft, t_len = ngram_draft_device(torch.from_numpy(hist), torch.from_numpy(lens), k)
        j_draft, j_len = j_ngram_draft_device(jnp.asarray(hist), jnp.asarray(lens), k)
        np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
        np.testing.assert_array_equal(t_draft.numpy(), np.asarray(j_draft))
        assert (t_len.numpy() > 0).sum() > b // 4  # the matcher really matched
    assert t_draft[0, :4].tolist() == [3, 9, 9, 1] and t_len[0] == 4


# ----------------------------------------------------- device bursts --


def _burst_case(cfg, quant, rng):
    """Pools with content everywhere, four compacted rows: two with
    repeating histories (drafts), one a page short of its row limit (the
    draft clips), one inactive padding row with a zero block table."""
    ps, num_pages, max_pages = 8, 24, 6
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, ps, cfg.head_dim)
    if quant == 0:
        kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        scales = []
    else:
        if quant == 8:
            kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        else:
            half = (*shape[:-1], cfg.head_dim // 2)
            kp, vp = (rng.integers(0, 256, half).astype(np.uint8) for _ in range(2))
        scales = [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32) for _ in range(2)]
    bt = np.asarray([[3, 9, 15, 2, 0, 0], [7, 1, 4, 0, 0, 0], [11, 12, 0, 0, 0, 0],
                     [0, 0, 0, 0, 0, 0]], dtype=np.int32)
    h = 48
    hist = np.zeros((4, h), dtype=np.int32)
    pattern = [5, 9, 2, 7, 5, 9, 2, 7, 5, 9, 2, 7, 5, 9]
    hist[0, :14] = pattern
    hist[1, :9] = rng.integers(0, cfg.vocab_size, 9)
    hist[1, 9:12] = hist[1, 2:5]  # the bigram at 3..4 recurs at the end
    hist[2, :12] = [3, 4, 3, 4, 3, 4, 3, 4, 3, 4, 3, 4]
    hlens = np.asarray([14, 12, 12, 0], dtype=np.int32)
    lens = np.maximum(hlens - 1, 0).astype(np.int32)
    limits = np.asarray([40, 40, 14, 0], dtype=np.int32)  # row 2: 3 slots left
    active = np.asarray([True, True, True, False])
    return dict(kp=kp, vp=vp, scales=scales, bt=bt, hist=hist, hlens=hlens, lens=lens,
                limits=limits, active=active, num_pages=num_pages)


def _with_drop(x):
    """The port's pools and scales carry one extra page, the drop page."""
    return torch.from_numpy(np.concatenate([x, np.zeros_like(x[:, :, :1])], axis=2))


def _check_pools(case, t_pools, j_pools, quant):
    n = case["num_pages"]
    for t, j in zip(t_pools, j_pools):
        t = t[:, :, :n].numpy()
        if quant and t.dtype != np.float32:
            np.testing.assert_array_equal(t, np.asarray(j))
        else:
            np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8", "int4"])
def test_spec_decode_burst_matches_jax(scaled, quant):
    """Tokens, proposals, and the pools after the burst (codes exactly,
    float values and page scales to 1e-5) against the JAX burst."""
    jcfg, cfg, jp, tp = scaled
    case = _burst_case(cfg, quant, np.random.default_rng(quant))
    keys = ("hist", "hlens", "lens")
    j_out = j_spec_decode_burst(
        j_fuse(jp), jcfg, *(jnp.asarray(case[x]) for x in keys),
        jnp.asarray(case["kp"]), jnp.asarray(case["vp"]),
        *(jnp.asarray(case[x]) for x in ("bt", "limits", "active")),
        n_iters=3, k=4, use_pallas=False,
        **dict(zip(("k_scales", "v_scales"), map(jnp.asarray, case["scales"]))))
    t_pools = [_with_drop(case["kp"]), _with_drop(case["vp"])]
    t_scales = [_with_drop(s) for s in case["scales"]]
    t_out = spec_decode_burst(
        fuse_projections(tp), cfg, *(torch.from_numpy(case[x]) for x in keys), *t_pools,
        *(torch.from_numpy(case[x]) for x in ("bt", "limits", "active")), n_iters=3, k=4,
        **dict(zip(("k_scales", "v_scales"), t_scales)))
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    assert t_out[1].numpy().sum() > 0  # drafts were proposed
    assert (t_out[0].numpy()[3] == -1).all()  # the padding row committed nothing
    assert (t_out[0].numpy()[2, :, 0] >= 0).sum() <= 3  # row 2 stopped at its limit
    _check_pools(case, t_pools + t_scales, list(j_out[2:]), quant)


def _fused_inputs(case, cfg, seed):
    rng = np.random.default_rng(seed)
    b = len(case["hlens"])
    presence = np.zeros((8, cfg.vocab_size), dtype=bool)
    presence[:, rng.integers(0, cfg.vocab_size, 20)] = True
    return dict(spec_ok=np.asarray([True, False, True, True]),
                row_idx=np.asarray([5, 2, 0, 0], dtype=np.int32), presence=presence,
                temp=np.asarray([0.0, 0.8, 0.0, 1.0], np.float32),
                top_p=np.asarray([1.0, 0.9, 1.0, 1.0], np.float32),
                top_k=np.asarray([0, 6, 0, 0], np.int32),
                pen=np.ones(b, np.float32))


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8", "int4"])
def test_fused_step_burst_matches_jax(scaled, quant, monkeypatch):
    """A mixed batch: greedy rows' tokens and proposals equal JAX's; the
    sampled row (temperature 0.8, top-k 6, top-p 0.9) commits one token an
    iteration, each inside its sampler's top-k / top-p set of the logits it
    was drawn from; presence marks exactly the committed tokens."""
    jcfg, cfg, jp, tp = scaled
    case = _burst_case(cfg, quant, np.random.default_rng(10 + quant))
    f = _fused_inputs(case, cfg, quant)
    keys = ("hist", "hlens", "lens")
    j_args = dict(zip(("k_scales", "v_scales"), map(jnp.asarray, case["scales"])))
    rows = f["row_idx"]
    j_out = j_fused_step_burst(
        j_fuse(jp), jcfg, *(jnp.asarray(case[x]) for x in keys),
        jnp.asarray(case["kp"]), jnp.asarray(case["vp"]),
        *(jnp.asarray(case[x]) for x in ("bt", "limits", "active")),
        jnp.asarray(f["spec_ok"]), jnp.asarray(rows), jnp.asarray(f["presence"]),
        jax.random.PRNGKey(0), *(jnp.asarray(f[x]) for x in ("temp", "top_p", "top_k", "pen")),
        n_iters=3, k=4, use_pallas=False, filter_sampling=True, **j_args)
    draws = []
    real = ts.sample_tokens_capped

    def spy(logits, *args, **kw):
        out = real(logits, *args, **kw)
        draws.append((logits[:, 0].clone(), args[-1].clone(), out.clone()))
        return out

    monkeypatch.setattr(t_fused_step_mod, "sample_tokens_capped", spy)
    t_pools = [_with_drop(case["kp"]), _with_drop(case["vp"])]
    t_scales = [_with_drop(s) for s in case["scales"]]
    pres = torch.from_numpy(np.concatenate([f["presence"], np.zeros((8, 1), bool)], axis=1))
    t_out = fused_step_burst(
        fuse_projections(tp), cfg, *(torch.from_numpy(case[x]) for x in keys), *t_pools,
        *(torch.from_numpy(case[x]) for x in ("bt", "limits", "active")),
        torch.from_numpy(f["spec_ok"]), torch.from_numpy(rows), pres,
        torch.Generator().manual_seed(0),
        *(torch.from_numpy(f[x]) for x in ("temp", "top_p", "top_k", "pen")),
        n_iters=3, k=4, filter_sampling=True, **dict(zip(("k_scales", "v_scales"), t_scales)))
    t_toks, j_toks = t_out[0].numpy(), np.asarray(j_out[0])
    greedy = [0, 2, 3]
    np.testing.assert_array_equal(t_toks[greedy], j_toks[greedy])
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    assert t_out[2] is None and j_out[2] is None
    # the sampled row: one token an iteration, inside its support
    assert (t_toks[1, :, 1:] == -1).all() and (t_toks[1, :, 0] >= 0).all()
    assert len(draws) == 3
    for it, (logits, pres_rows, out) in enumerate(draws):
        tok = int(out[1])
        assert tok == t_toks[1, it, 0]
        lg = ts.apply_repetition_penalty(logits[1:2], pres_rows[1:2], torch.ones(1, 1)) / 0.8
        kept = ts.top_p_mask(ts.top_k_mask(lg, torch.tensor([6])), torch.tensor([0.9]))
        assert kept[0, tok] > ts.NEG_INF
    # presence: the JAX pool's marks for every row; the drop column aside
    j_pres = np.asarray(j_out[5])
    t_pres = t_out[5][:, : cfg.vocab_size].numpy()
    other = [r for r in range(8) if r != rows[1]]
    np.testing.assert_array_equal(t_pres[other], j_pres[other])
    marked = set(np.flatnonzero(t_pres[rows[1]] & ~f["presence"][rows[1]]).tolist())
    assert marked <= set(t_toks[1, :, 0].tolist())


def test_fused_step_burst_runs_the_packed_prefill_phase_as_jax(narrator):
    """``has_prefill``: the packed wave's per-segment logits (and its K/V)
    equal JAX's; the decode phase follows it in the same call."""
    jcfg, cfg, jp, tp = narrator
    budget, rb, tq, ps, mp = 16, 2, 8, 8, 4
    ids = np.zeros((1, budget), np.int32)
    ids[0, :7] = [3, 4, 5, 6, 7, 8, 9]
    ids[0, 7:12] = [20, 21, 22, 23, 24]
    pos = np.zeros((1, budget), np.int32)
    pos[0, :7] = np.arange(7)
    pos[0, 7:12] = np.arange(5)
    seg = np.full((budget,), rb, np.int32)
    seg[:7], seg[7:12] = 0, 1
    bt = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    slots = np.full((budget,), -1, np.int32)
    slots[:7] = 8 + np.arange(7)
    slots[7:12] = 24 + np.arange(5)
    pf = [ids, pos, slots, bt, np.zeros(rb, np.int32), np.asarray([7, 5], np.int32), seg,
          np.asarray([6, 11], np.int32)]
    nb, h = 1, 32
    dec = dict(hist=np.zeros((nb, h), np.int32), hlens=np.asarray([3], np.int32),
               lens=np.asarray([2], np.int32), bt=np.asarray([[5, 0, 0, 0]], np.int32),
               limits=np.asarray([30], np.int32), active=np.asarray([True]))
    dec["hist"][0, :3] = [40, 41, 42]
    shape = (cfg.num_layers, cfg.num_kv_heads, 8, ps, cfg.head_dim)
    kp, vp = (np.random.default_rng(i).normal(size=shape).astype(np.float32) for i in (1, 2))
    samp = [np.zeros(nb, np.float32), np.ones(nb, np.float32), np.zeros(nb, np.int32),
            np.ones(nb, np.float32)]
    order = ("hist", "hlens", "lens")
    j_out = j_fused_step_burst(
        j_fuse(jp), jcfg, *(jnp.asarray(dec[x]) for x in order), jnp.asarray(kp),
        jnp.asarray(vp), *(jnp.asarray(dec[x]) for x in ("bt", "limits", "active")),
        jnp.ones((nb,), bool), jnp.zeros((nb,), jnp.int32), jnp.zeros((4, cfg.vocab_size), bool),
        jax.random.PRNGKey(1), *map(jnp.asarray, samp), *map(jnp.asarray, pf),
        n_iters=2, k=3, tq=tq, use_pallas=False, filter_sampling=False, has_prefill=True)
    t_pools = [_with_drop(kp), _with_drop(vp)]
    t_out = fused_step_burst(
        fuse_projections(tp), cfg, *(torch.from_numpy(dec[x]) for x in order), *t_pools,
        *(torch.from_numpy(dec[x]) for x in ("bt", "limits", "active")),
        torch.ones((nb,), dtype=torch.bool), torch.zeros((nb,), dtype=torch.int32),
        torch.zeros((4, cfg.vocab_size + 1), dtype=torch.bool), torch.Generator(),
        *map(torch.from_numpy, samp), *map(torch.from_numpy, pf),
        n_iters=2, k=3, tq=tq, filter_sampling=False, has_prefill=True)
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(j_out[2]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    for t, j in zip(t_pools, j_out[3:5]):
        np.testing.assert_allclose(t[:, :, :8].numpy(), np.asarray(j), atol=1e-5, rtol=1e-6)


# ----------------------------------------------------------------- engine --

SPEC_MODES = {
    "spec": dict(spec_ngram_k=3),
    "burst": dict(spec_ngram_k=3, spec_burst_iters=2),
    "fused": dict(spec_ngram_k=3, spec_burst_iters=2, fused_step=True, prefill_token_budget=32),
}


@pytest.mark.parametrize("quant", QUANTS, ids=["fp", "int8", "int4"])
def test_engine_spec_modes_greedy_tokens_and_counters_match_jax(narrator, quant):
    """Each spec mode against the JAX engine in the same mode over the same
    pages: greedy tokens equal, and equal to the port's default engine's;
    spec_proposed, spec_accepted, step_dispatches_total and
    fused_steps_total equal JAX's; drafts are accepted; every page comes
    back.  In the fused mode a second wave joins while the first decodes
    (the deferred prefill wave rides the fused call)."""
    jcfg, cfg, jp, tp = narrator
    prompts = [[1, 2, 3, 4, 5, 6, 1, 2], [3, 4, 9, 3], [20, 21, 22, 20, 21], [30, 31, 32]]
    late = [[11, 12, 13, 11, 12]]
    sp_j, sp_t = (cls(max_tokens=10, temperature=0.0) for cls in (JSamplingParams, SamplingParams))
    base = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", kv_quant=quant, **GEOM)
    expect = [r.output_tokens for r in base.generate(prompts + late, sp_t)]
    counters = ("spec_proposed", "spec_accepted", "step_dispatches_total", "fused_steps_total")
    for name, mode in SPEC_MODES.items():
        je, te = _engines(narrator, kv_quant=quant, **mode)
        got = {}
        for side, eng, sp in (("jax", je, sp_j), ("port", te, sp_t)):
            if name != "fused":
                res = eng.generate(prompts + late, sp)
            else:
                rids = [eng.add_request(p, sp) for p in prompts[:3]]
                done = {r.request_id: r for r in eng.step()}  # a packed prefill alone
                rids += [eng.add_request(p, sp) for p in prompts[3:] + late]
                while eng.has_work():
                    done.update({r.request_id: r for r in eng.step()})
                res = [done[r] for r in rids]
            got[side] = [r.output_tokens for r in res]
            assert all(r.finish_reason == "length" for r in res)
            assert eng._allocator.free_count == eng._allocator.num_pages
        assert got["port"] == got["jax"] == expect, name
        assert [getattr(te, c) for c in counters] == [getattr(je, c) for c in counters], name
        assert te.spec_accepted > 0, name
    assert te.fused_steps_total > 0


def test_engine_spec_mixed_sampled_rows_keep_greedy_parity(narrator):
    """Greedy, penalised and sampled rows in one batch: with the host spec
    step (sampled rows sample position 0) and the fused step (sampled rows
    draw inside the burst), the deterministic rows equal the JAX engine's
    and the default engine's; sampled rows run to their length inside the
    vocabulary; penalised and sampled rows never propose."""
    jcfg, cfg, jp, tp = narrator
    prompts = [[3, 4, 9, 3], [5, 6, 7, 5, 6], [11, 12, 13]]
    sps = [dict(temperature=0.0), dict(temperature=0.0, repetition_penalty=1.3),
           dict(temperature=0.8, top_p=0.9)]
    t_sps = [SamplingParams(max_tokens=8, **s) for s in sps]
    j_sps = [JSamplingParams(max_tokens=8, **s) for s in sps]
    expect = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **GEOM).generate(prompts, t_sps)
    for mode in (SPEC_MODES["spec"], SPEC_MODES["fused"]):
        je, te = _engines(narrator, **mode)
        j_res, t_res = je.generate(prompts, j_sps), te.generate(prompts, t_sps)
        for i in (0, 1):
            assert t_res[i].output_tokens == j_res[i].output_tokens == expect[i].output_tokens
        assert len(t_res[2].output_tokens) == 8
        assert all(0 <= t < cfg.vocab_size for t in t_res[2].output_tokens)
        assert te.spec_proposed == je.spec_proposed > 0
    solo = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", spec_ngram_k=3, **GEOM)
    solo.generate([prompts[1]], [t_sps[1]])
    assert solo.spec_proposed == 0


@pytest.mark.parametrize("mode", ["spec", "burst"])
def test_engine_spec_respects_stop_and_max_tokens(scaled, mode):
    """A stop token inside a committed run ends the request there, as in
    the default engine and the JAX engine in the same mode; max_tokens is
    never overshot; pages balance."""
    jcfg, cfg, jp, tp = scaled
    prompt = [3, 4, 5] * 8
    base = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **GEOM)
    ref = base.generate([prompt], SamplingParams(max_tokens=12, temperature=0.0))[0]
    stop = ref.output_tokens[5]
    cut = ref.output_tokens.index(stop) + 1
    je, te = _engines(scaled, **SPEC_MODES[mode])
    for sp in ((dict(max_tokens=12, stop_token_ids=(stop,))), dict(max_tokens=7)):
        j = je.generate([prompt], JSamplingParams(temperature=0.0, **sp))[0]
        t = te.generate([prompt], SamplingParams(temperature=0.0, **sp))[0]
        assert t.output_tokens == j.output_tokens
        assert t.finish_reason == j.finish_reason
        if "stop_token_ids" in sp:
            assert t.output_tokens == ref.output_tokens[:cut] and t.finish_reason == "stop"
        else:
            assert t.output_tokens == ref.output_tokens[:7] and t.finish_reason == "length"
    assert te.spec_proposed == je.spec_proposed
    assert te._allocator.free_count == te._allocator.num_pages and not te.has_work()


def test_engine_spec_burst_draft_overflowing_row_limits(narrator):
    """A row near its KV budget: ``row_limits`` clips the draft so the
    correction token keeps a slot; the request ends where the default
    engine's does, as JAX's, with drafts accepted near the limit."""
    geom = dict(max_seq_len=32, page_size=4, num_pages=32)
    # the narrator continues 9, 10, ...: it quotes the prompt's first span
    prompt = list(range(1, 13)) + list(range(1, 9))
    sp_j, sp_t = (cls(max_tokens=20, temperature=0.0) for cls in (JSamplingParams, SamplingParams))
    jcfg, cfg, jp, tp = narrator
    plain = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**GEOM, **geom})
    want = plain.generate([prompt], sp_t)[0]
    je, te = _engines(narrator, spec_ngram_k=4, spec_burst_iters=4, **geom)
    j, t = je.generate([prompt], sp_j)[0], te.generate([prompt], sp_t)[0]
    assert t.output_tokens == j.output_tokens == want.output_tokens
    assert t.finish_reason == j.finish_reason == "length"
    assert te.spec_accepted == je.spec_accepted > 0
    assert te._allocator.free_count == te._allocator.num_pages and not te.has_work()


def test_engine_fused_warmup_leaves_the_engine_clean(narrator):
    """warmup() runs every fused variant (row bucket x has_prefill x
    filter_sampling) and leaves the engine as it was: no work, every page
    free, and the same greedy tokens afterwards."""
    jcfg, cfg, jp, tp = narrator
    te = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", kv_quant=4,
                **{**GEOM, **SPEC_MODES["fused"]})
    calls = []
    real = t_fused_step_mod.fused_step_burst

    def spy(*args, **kw):
        calls.append((args[2].shape[0], kw["has_prefill"], kw["filter_sampling"]))
        return real(*args, **kw)

    import githubrepostorag_tpu_torch.serving.engine as engine_mod

    engine_mod.fused_step_burst, saved = spy, engine_mod.fused_step_burst
    try:
        te.warmup()
    finally:
        engine_mod.fused_step_burst = saved
    assert {c for c in calls} >= {(nb, pf, f) for nb in (1, 2, 4) for pf in (False, True)
                                  for f in (False, True)}
    assert not te.has_work() and te._allocator.free_count == te._allocator.num_pages
    sp = SamplingParams(max_tokens=6, temperature=0.0)
    fresh = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", kv_quant=4,
                   **{**GEOM, **SPEC_MODES["fused"]})
    assert te.generate([[9, 10, 11]], sp)[0].output_tokens == \
        fresh.generate([[9, 10, 11]], sp)[0].output_tokens
