"""The port's decode burst and engine against the JAX package on identical
weights (CPU, float32, tiny config): greedy tokens must be identical.

Weights are the JAX ``init_params`` draw scaled x4, so greedy decoding of
the tiny random model walks varied tokens instead of repeating one.  The
int4 cases quantize that tree (group 16, int8 embedding table) on the JAX
side and convert it.  The decode-burst case takes W4A8 on both sides: the
JAX package's int4 matmuls run its Pallas kernel in interpret mode (the
``jax_pallas_int4`` fixture; its CPU path would otherwise take its XLA
oracle, never W4A8).  The engine case sets ``INT4_W4A8=0`` on both sides,
because W4A8 rounds activations to int8 codes: a 1e-6 difference of
float32 summation order upstream can move one code by one step (1e-2 on
a projection's output), and over many greedy steps of a random model that
flips a token.  The W4A8 route is held per burst, where its inputs are
identical."""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu.models import quant as j_quant
from githubrepostorag_tpu.models.quant import fuse_projections as j_fuse
from githubrepostorag_tpu.ops.pallas_int4 import int4_matmul as j_int4_matmul
from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
from githubrepostorag_tpu.serving.decode_burst import decode_burst as j_decode_burst
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.quant import QuantizedLinear4
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, init_params
from githubrepostorag_tpu_torch.serving import AsyncEngine, Engine, SamplingParams
from githubrepostorag_tpu_torch.serving.decode_burst import decode_burst

ENGINE_KW = dict(max_num_seqs=4, num_pages=48, page_size=8, max_seq_len=128, prefill_chunk=32)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = JConfig.tiny(), Qwen2Config.tiny()
    jp = jax.tree.map(lambda x: x * 4 if x.ndim >= 2 else x, j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def int4_weights(weights):
    jcfg, cfg, jp, _ = weights
    jp4 = j_quant.quantize_qwen2_params(jp, bits=4, group_size=16)
    return jcfg, cfg, jp4, params_from_jax(jax.tree.map(np.asarray, jp4), cfg, device="cpu")


@pytest.fixture
def jax_pallas_int4(monkeypatch):
    """Send the JAX package's int4 matmuls through its Pallas kernel in
    interpret mode (automatic route: W4A8 for decode-sized batches, the
    bf16-dequant kernel where the caller pins w4a8=False).  Compiled
    functions are dropped before and after, so no trace crosses the
    patch."""
    def dispatch(x, q, s, zs, layer=None, out_dtype=None, kernel=True, w4a8=None):
        return j_int4_matmul(x, q, s, zs, layer=layer, out_dtype=out_dtype, interpret=True,
                             w4a8=w4a8)

    monkeypatch.setattr(j_quant, "q4_dispatch", dispatch)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _torch_engine(cfg, params, **kw):
    return Engine(params, cfg, kv_dtype=torch.float32, device="cpu", **{**ENGINE_KW, **kw})


def test_decode_burst_matches_jax(weights):
    _check_decode_burst(*weights)


def test_decode_burst_int8_pools_matches_jax(weights):
    """int8 pages with per-page scales: kernel B's int8 branch (its plain
    version here) against the JAX burst's gather path; the burst-end
    commit quantizes the staged tail with the stored scales."""
    _check_decode_burst(*weights, quant=8)


def test_decode_burst_int4_matches_jax(int4_weights, jax_pallas_int4):
    _check_decode_burst(*int4_weights)


def _check_decode_burst(jcfg, cfg, jp, tp, quant=0):
    rng = np.random.default_rng(0)
    b, n_steps, ps, num_pages, max_pages = 3, 4, 8, 16, 4
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, ps, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    scales = []
    if quant:  # int8 codes and per-page scales that differ everywhere
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(0.01, 0.1, shape[:3]).astype(np.float32) for _ in range(2)]
    bt = np.asarray([[3, 9, 15, 0], [7, 1, 0, 0], [0, 0, 0, 0]], dtype=np.int32)
    last = np.asarray([11, 200, -1], dtype=np.int32)
    lens = np.asarray([13, 6, 0], dtype=np.int32)
    active = np.asarray([True, True, False])
    row_limits = np.asarray([24, 8, 0], dtype=np.int32)  # row 1 stops after 2 steps
    presence = rng.random((b, cfg.vocab_size)) < 0.05
    temp = np.zeros(b, np.float32)
    top_p = np.ones(b, np.float32)
    top_k = np.zeros(b, np.int32)
    pen = np.asarray([1.0, 1.3, 1.0], np.float32)

    j_out = j_decode_burst(
        j_fuse(jp), jcfg, *(jnp.asarray(x) for x in (last, lens, kp, vp, presence, active,
                                                      row_limits, bt)),
        jax.random.PRNGKey(0), *(jnp.asarray(x) for x in (temp, top_p, top_k, pen)),
        n_steps=n_steps, use_pallas=False, filter_sampling=False,
        **dict(zip(("k_scales", "v_scales"), map(jnp.asarray, scales))))
    j_packed, j_valid, j_k, j_v, j_pres, j_lens, *j_scales = (np.asarray(x) for x in j_out)
    assert (j_packed[1, 2:] == -1).all() and (j_packed[2] == -1).all()

    # the port's pools carry one extra page, the drop page of commit_paged
    def with_drop(x):
        return torch.from_numpy(np.concatenate([x, np.zeros_like(x[:, :, :1])], axis=2))

    tkp, tvp = with_drop(kp), with_drop(vp)
    t_scales = [with_drop(x) for x in scales]
    pres = torch.from_numpy(presence.copy())
    packed, valid, _, _, _, out_lens, *_ = decode_burst(
        tp, cfg, *(torch.from_numpy(x) for x in (last, lens)), tkp, tvp, pres,
        *(torch.from_numpy(x) for x in (active, row_limits, bt)), torch.Generator(),
        *(torch.from_numpy(x) for x in (temp, top_p, top_k, pen)),
        n_steps=n_steps, filter_sampling=False,
        **dict(zip(("k_scales", "v_scales"), t_scales)))
    np.testing.assert_array_equal(packed.numpy(), j_packed)
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    np.testing.assert_array_equal(out_lens.numpy(), j_lens)
    np.testing.assert_array_equal(pres.numpy(), j_pres)
    if quant:  # codes bit for bit; scales of pages the burst opened within
        # 1e-6 relative (their amax comes from K/V that agree to f32 order)
        np.testing.assert_array_equal(tkp[:, :, :num_pages].numpy(), j_k)
        np.testing.assert_array_equal(tvp[:, :, :num_pages].numpy(), j_v)
        for t, j in zip(t_scales, j_scales):
            np.testing.assert_allclose(t[:, :, :num_pages].numpy(), j, rtol=1e-6, atol=0)
        return
    np.testing.assert_allclose(tkp[:, :, :num_pages].numpy(), j_k, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tvp[:, :, :num_pages].numpy(), j_v, atol=1e-5, rtol=0)


def test_engine_greedy_tokens_match_jax(weights):
    """Mixed prompt lengths and a prefix-cache hit."""
    _check_greedy_tokens(*weights)


@pytest.mark.parametrize("mode", [
    {"prefill_token_budget": 40},  # mixed lengths, a mid-chunk split, a resume
    {"kv_quant": 8},
    {"kv_quant": 4, "prefill_token_budget": 40},
])
def test_engine_packed_and_quantized_greedy_tokens_match_jax(weights, mode):
    """The packed prefill path and int8 / int4 KV pages, each against the
    JAX engine in the same mode (its CPU path: the XLA attention paths,
    the burst's gather path).  A 40-token budget splits the 45-token
    prompt's chunks and the wave's later rows mid-chunk, so segments
    resume at cached lengths that are not page boundaries."""
    _check_greedy_tokens(*weights, **mode)


def test_engine_int4_greedy_tokens_match_jax(int4_weights, monkeypatch):
    """As above with int4 weights; both sides run the exact bf16-dequant
    route, in prefill and in decode (see the module docstring): the port's
    ``int4_matmul_ref`` against the JAX package's CPU path, its XLA oracle
    ``q4_matmul``."""
    monkeypatch.setenv("INT4_W4A8", "0")
    _check_greedy_tokens(*int4_weights)


def _check_greedy_tokens(jcfg, cfg, jp, tp, engines=None, **mode):
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 24).tolist()
    # mixed lengths, one longer than prefill_chunk, one carrying a prefix
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 17, 45)]
    prompts.append(prefix + rng.integers(0, cfg.vocab_size, 5).tolist())
    later = [prefix + rng.integers(0, cfg.vocab_size, 7).tolist()]  # hits the cache
    je, te = engines or (JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW, **mode),
                         _torch_engine(cfg, tp, **mode))
    j_sp = JSamplingParams(temperature=0.0, max_tokens=10)
    t_sp = SamplingParams(temperature=0.0, max_tokens=10)
    for batch in (prompts, later):
        j_res = je.generate(batch, j_sp)
        t_res = te.generate(batch, t_sp)
        for j, t in zip(j_res, t_res):
            assert t.finish_reason == j.finish_reason == "length"
            assert t.output_tokens == j.output_tokens
    assert te._allocator.hit_tokens == je._allocator.hit_tokens >= 24
    assert te.packed_prefill_tokens == je.packed_prefill_tokens
    assert te.packed_prefill_padding == je.packed_prefill_padding
    assert te._allocator.free_count == te._allocator.num_pages
    assert sorted(te._free_rows) == list(range(ENGINE_KW["max_num_seqs"]))


def test_engine_stops_cancels_and_reaps(weights):
    _, cfg, _, tp = weights
    te = _torch_engine(cfg, tp)
    first = te.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=6))[0]
    stop = first.output_tokens[2]
    res = te.generate([[1, 2, 3]], SamplingParams(temperature=0.0, max_tokens=6,
                                                  stop_token_ids=(stop,)))[0]
    assert res.finish_reason == "stop" and res.output_tokens == first.output_tokens[:3]
    rid = te.add_request([4, 5, 6], SamplingParams(max_tokens=50), deadline_s=time.monotonic() - 1)
    bad = te.add_request([], SamplingParams())
    oov = te.add_request([1, cfg.vocab_size], SamplingParams())
    done = {}
    while te.has_work():
        done.update({r.request_id: r for r in te.step()})
    assert done[rid].finish_reason == "deadline"
    assert done[bad].finish_reason == done[oov].finish_reason == "error"
    assert te._allocator.free_count == te._allocator.num_pages


def test_async_engine_streams_tokens(weights):
    _, cfg, _, tp = weights
    prompts = [[7, 8, 9, 10], [3] * 40]
    sp = SamplingParams(temperature=0.0, max_tokens=9)
    expect = [r.output_tokens for r in _torch_engine(cfg, tp).generate(prompts, sp)]

    async def run():
        aeng = AsyncEngine(_torch_engine(cfg, tp))
        try:
            streamed = []

            async def consume():
                async for ev in aeng.stream(prompts[0], sp):
                    if ev.type == "token":
                        streamed.append(ev.token_id)
                    else:
                        return ev.result

            return streamed, await asyncio.wait_for(
                asyncio.gather(consume(), aeng.generate(prompts[1], sp)), timeout=60)
        finally:
            await aeng.stop()

    streamed, (r0, r1) = asyncio.run(run())
    assert streamed == r0.output_tokens == expect[0]
    assert r1.output_tokens == expect[1]


def test_engine_defaults_to_the_card(weights):
    _, cfg, _, tp = weights
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tp, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())


@pytest.mark.parametrize("option", [
    {"spec_ngram_k": 4}, {"spec_ngram_k": 4, "spec_burst_iters": 2},
    {"kv_tier": "on"}, {"kv_host_pool_pages": 16, "preempt": "on"},
    {"draft_params": "draft"},
    {"spec_ngram_k": 4, "spec_burst_iters": 2, "fused_step": True, "prefill_token_budget": 48},
])
def test_engine_rejects_unported_modes(weights, option):
    """The engine modes a tp / sp / ep mesh does not serve yet are refused
    at construction, naming ROADMAP queue 1 item 8.6 (a mesh layout needs
    no world for that: the refusal comes before anything is built)."""
    from githubrepostorag_tpu_torch.parallel import Mesh, MeshPlan

    _, cfg, _, tp = weights
    if option.get("draft_params") == "draft":
        option = {"draft_params": tp, "draft_cfg": cfg}
    with pytest.raises(NotImplementedError, match="item 8.6"):
        _torch_engine(cfg, tp, mesh=Mesh(MeshPlan(tp=2)), **option)


@pytest.mark.parametrize("option, bad", [
    ({"spec_ngram_k": 4}, {"spec_ngram_k": 4, "draft_params": {}, "draft_cfg": object()}),
    ({"spec_ngram_k": 4, "spec_burst_iters": 2}, {"spec_burst_iters": 2}),
    ({"spec_ngram_k": 4, "spec_burst_iters": 2, "fused_step": True, "prefill_token_budget": 48},
     {"spec_ngram_k": 4, "spec_burst_iters": 2, "fused_step": True}),
    ({"spec_ngram_k": 4, "spec_burst_iters": 2, "fused_step": True, "prefill_token_budget": 48},
     {"spec_ngram_k": 4, "spec_burst_iters": 2, "fused_step": True, "prefill_token_budget": 48,
      "prefill_priority": True}),
    ({"fused_step": False, "spec_ngram_k": 2}, {"fused_step": True, "spec_ngram_k": 2}),
    ({"kv_tier": "on"}, {"kv_tier": "on", "prefix_caching": False}),
    ({"kv_host_pool_pages": 16}, {"kv_tier": "sometimes"}),
    ({"kv_tier": "on", "kv_migrate_burst": 16}, None),
    ({"kv_tier": "on", "preempt": "on"}, {"preempt": "on"}),
    ({"kv_host_pool_pages": 16, "preempt_headroom_pages": 4}, {"preempt": "maybe"}),
    ({"protected_priority": "batch", "preempt_headroom_pages": 2}, None),
])
def test_engine_accepts_ported_modes_and_validates_them_as_jax(weights, option, bad):
    """Each ported option is accepted and configures the engine as the JAX
    engine's does (mode flags, allocator class and host capacity, migration
    burst, fused segment bucket, headroom, the protected class); each bad
    combination raises the JAX engine's ValueError, message for message."""
    jcfg, cfg, jp, tp = weights
    te = _torch_engine(cfg, tp, **option)
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW, **option)
    attrs = ("spec_ngram_k", "spec_burst_iters", "fused_step_on", "_fused_pf_segs",
             "_kv_tier_on", "kv_migrate_burst", "_preempt_on", "preempt_headroom_pages",
             "protected_priority", "_priority_sched")
    assert [getattr(te, a) for a in attrs] == [getattr(je, a) for a in attrs]
    assert type(te._allocator).__name__ == type(je._allocator).__name__
    assert getattr(te._allocator, "host_pool_pages", None) == getattr(
        je._allocator, "host_pool_pages", None)
    if bad is not None:
        with pytest.raises(ValueError) as t_err:
            _torch_engine(cfg, tp, **bad)
        with pytest.raises(ValueError) as j_err:
            JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW, **bad)
        assert str(t_err.value) == str(j_err.value)


def test_engine_accepts_off_values_and_rejects_unknown_options(weights):
    _, cfg, _, tp = weights
    _torch_engine(cfg, tp, kv_tier="auto", preempt="off", kv_quant=False, mesh=None)
    with pytest.raises(TypeError):
        _torch_engine(cfg, tp, use_pallas=True)


def test_engine_accepts_packed_prefill_and_quantized_pages(weights):
    _, cfg, _, tp = weights
    te = _torch_engine(cfg, tp, prefill_token_budget=48, kv_quant="int4")
    assert te.kv_quant == 4 and te.packed_chunk == ENGINE_KW["prefill_chunk"]
    assert te._k_pages.dtype == torch.uint8 and te._k_scales.dtype == torch.float32
    assert te.packed_prefill_buckets() == [1, 2, 4]
    te = _torch_engine(cfg, tp, kv_quant=True, prefill_token_budget=None)
    assert te.kv_quant == 8 and te._k_pages.dtype == torch.int8
    with pytest.raises(ValueError):
        _torch_engine(cfg, tp, prefill_token_budget=0)


def test_engine_accepts_quantized_params_and_checks_devices(int4_weights):
    _, cfg, _, tp = int4_weights
    te = _torch_engine(cfg, tp)
    assert isinstance(te.params["layers"]["wqkv"], QuantizedLinear4)  # fused at construction
    assert "wq" in tp["layers"]  # the caller's tree is left as it was
    moved = QuantizedLinear4(*(f.to("meta") for f in tp["layers"]["wo"]))
    with pytest.raises(ValueError, match="meta"):
        _torch_engine(cfg, dict(tp, layers=dict(tp["layers"], wo=moved)))
    with pytest.raises(NotImplementedError):
        _torch_engine(cfg, dict(tp, norm=tp["norm"].to(torch.int32)))


def test_engine_stamps_priority_as_jax(weights):
    """add_request stamps ``priority or default_priority`` on the request,
    on both engines; AsyncEngine.stream passes it through."""
    jcfg, cfg, jp, tp = weights
    te = _torch_engine(cfg, tp, default_priority="batch")
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, default_priority="batch", **ENGINE_KW)
    for eng in (te, je):
        plain = eng.add_request([5, 6, 7], JSamplingParams(max_tokens=2))
        tagged = eng.add_request([5, 6, 7], JSamplingParams(max_tokens=2), priority="interactive")
        assert eng._requests[plain].priority == "batch"
        assert eng._requests[tagged].priority == "interactive"

    async def stream_one():
        ae = AsyncEngine(_torch_engine(cfg, tp))
        seen = []
        real = ae.engine.add_request

        def spy(*args, **kw):
            rid = real(*args, **kw)
            seen.append(ae.engine._requests[rid].priority)
            return rid

        ae.engine.add_request = spy
        try:
            await ae.generate([1, 2, 3], SamplingParams(max_tokens=2), priority="longctx")
            await ae.generate([1, 2, 3], SamplingParams(max_tokens=2))
        finally:
            await ae.stop()
        return seen

    assert asyncio.run(stream_one()) == ["longctx", "interactive"]


def test_async_engine_stats_key_set_matches_jax(weights):
    from githubrepostorag_tpu.serving.async_engine import AsyncEngine as JAsyncEngine

    jcfg, cfg, jp, tp = weights
    port = AsyncEngine(_torch_engine(cfg, tp)).stats()
    ref = JAsyncEngine(JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW)).stats()
    assert sorted(port) == sorted(ref)
    # a fresh engine of the same geometry reads the same everywhere
    assert port == ref
    assert port["free_pages"] == port["total_pages"] == ENGINE_KW["num_pages"]
    # after the same traffic on a tiered spec engine: the same values
    # (writebacks, a fault-in of an evicted prefix, drafts proposed)
    mode = dict(spec_ngram_k=3, kv_tier="on", kv_host_pool_pages=24, num_pages=12,
                page_size=4, max_num_seqs=2, max_seq_len=64, prefill_chunk=16)
    te = Engine(tp, cfg, kv_dtype=torch.float32, device="cpu", **{**ENGINE_KW, **mode})
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **{**ENGINE_KW, **mode})
    rng = np.random.default_rng(4)
    prompt = [5, 6, 7, 8] * 3 + rng.integers(0, cfg.vocab_size, 12).tolist()
    filler = rng.integers(0, cfg.vocab_size, 36).tolist()
    for eng, sp in ((te, SamplingParams), (je, JSamplingParams)):
        for batch in ([prompt], [filler], [prompt]):
            eng.generate(batch, sp(max_tokens=6, temperature=0.0))
            eng.flush_kv_migrations()
    port = AsyncEngine(te).stats()
    ref = JAsyncEngine(je).stats()
    assert port == ref
    assert port["kv_fault_ins"] > 0 and port["kv_writebacks"] > 0 and port["spec_proposed"] > 0


def test_engine_takes_the_servers_tuning_keywords(weights):
    """The JAX server passes its modes' tuning keywords whatever the mode,
    and the engine takes them."""
    _, cfg, _, tp = weights
    _torch_engine(cfg, tp, kv_migrate_burst=8, sp_ring_pack=True, sp_ring_buckets=0, spec_k=4,
                  spec_iters=4, spec_accept_floor=0.35, spec_deadline_margin_s=0.25,
                  protected_priority="interactive")
    # the ring's tuning is taken at any value, as in JAX; without an sp axis
    # no prompt is ring-bound and the ladder is empty
    eng = _torch_engine(cfg, tp, sp_ring_buckets=2, sp_ring_pack=False, sp_prefill_threshold=64)
    assert (eng.sp_ring_bucket_count, eng.sp_ring_pack) == (2, False)
    assert not eng.is_longctx(100) and eng.sp_ring_bucket_ladder() == []
    # the draft controller's tuning is taken at any value (the mode is ported)
    _torch_engine(cfg, tp, spec_k=8, spec_iters=2, spec_accept_floor=0.5,
                  spec_deadline_margin_s=1.0)


def test_out_of_vocabulary_prompt_ids_are_refused_where_jax_admits_them(weights):
    """A divergence by design: the JAX engine admits prompt ids outside the
    vocabulary (its embedding gather reads NaN rows past the table and the
    request runs to its length); the port refuses such a request at
    intake, surfaced as an ``error`` completion through the next step, and
    frees everything it held."""
    jcfg, cfg, jp, tp = weights
    prompt = [5, cfg.vocab_size + 3, 7]
    te = _torch_engine(cfg, tp)
    rid = te.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=3))
    done = {}
    while te.has_work():
        done.update({r.request_id: r for r in te.step()})
    assert done[rid].finish_reason == "error"
    assert done[rid].error == "prompt token id outside the vocabulary"
    assert done[rid].output_tokens == []
    assert te._allocator.free_count == te._allocator.num_pages
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW)
    j_res = je.generate([prompt], JSamplingParams(temperature=0.0, max_tokens=3))[0]
    assert j_res.finish_reason != "error" and len(j_res.output_tokens) == 3


def _record_widths(engine) -> list[tuple[int, int]]:
    """(longest chunk, width) of every ``_dispatch_width`` call on ``engine``."""
    seen, real = [], engine._dispatch_width

    def spy(longest):
        width = real(longest)
        seen.append((longest, width))
        return width

    engine._dispatch_width = spy
    return seen


@pytest.mark.parametrize("mode", [{"prefill_widths": 3}, {"prefill_priority": True},
                                  {"layer_unroll": 4}])
def test_engine_options_greedy_tokens_match_jax(weights, mode):
    """ROADMAP queue 1 item 1: the width ladder, prefill priority and
    layer_unroll, each against the JAX engine with the same option on
    (mixed prompt lengths, a ragged second chunk, a prefix-cache hit).  The
    width each padded wave dispatches at is JAX's ``_dispatch_width``."""
    jcfg, cfg, jp, tp = weights
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW, **mode)
    te = _torch_engine(cfg, tp, **mode)
    assert te.prefill_width_buckets == je.prefill_width_buckets
    assert (te.layer_unroll, te.prefill_priority) == (je.layer_unroll, je.prefill_priority)
    j_widths, t_widths = _record_widths(je), _record_widths(te)
    shapes, run_prefill = [], te._run_prefill

    def spy(fn, ids, *args, **kw):
        shapes.append(tuple(ids.shape))
        return run_prefill(fn, ids, *args, **kw)

    te._run_prefill = spy
    _check_greedy_tokens(jcfg, cfg, jp, tp, engines=(je, te))
    assert t_widths == j_widths
    assert [w for _, w in shapes] == [w for _, w in t_widths]
    # a narrow wave keeps at least prefill_chunk padded tokens (more rows)
    assert all(rows * w >= ENGINE_KW["prefill_chunk"] for rows, w in shapes)
    if "prefill_widths" in mode:
        assert te.prefill_width_buckets == [32, 16]
        assert {w for _, w in t_widths} == {32, 16}
    assert te.step_dispatches_total == je.step_dispatches_total


def test_unfloored_ladder_dispatches_jax_rows(weights):
    """With ``prefill_row_floor`` 0 (how ``chip_smoke.py`` measures the
    floor's cost), every padded wave dispatches JAX's ``[_bucket(n), w]``,
    narrow waves run fewer than ``prefill_chunk`` tokens, and greedy tokens
    still equal the JAX engine's with ``prefill_widths=3`` (on the CPU no
    GEMM changes algorithm with its rows)."""
    from githubrepostorag_tpu_torch.serving.engine import _bucket

    jcfg, cfg, jp, tp = weights
    je = JEngine(jp, jcfg, kv_dtype=jnp.float32, **ENGINE_KW, prefill_widths=3)
    te = _torch_engine(cfg, tp, prefill_widths=3)
    assert te.prefill_row_floor == ENGINE_KW["prefill_chunk"]
    te.prefill_row_floor = 0
    waves, shapes = [], []
    prefill_batch, run_prefill = te._prefill_batch, te._run_prefill

    def batch_spy(reqs, finished):
        waves.append(len(reqs))
        return prefill_batch(reqs, finished)

    def run_spy(fn, ids, *args, **kw):
        shapes.append(tuple(ids.shape))
        return run_prefill(fn, ids, *args, **kw)

    te._prefill_batch, te._run_prefill = batch_spy, run_spy
    _check_greedy_tokens(jcfg, cfg, jp, tp, engines=(je, te))
    assert [rows for rows, _ in shapes] == [_bucket(n, ENGINE_KW["max_num_seqs"], 1)
                                            for n in waves]
    assert any(rows * w < ENGINE_KW["prefill_chunk"] for rows, w in shapes)


def test_prefill_priority_skips_bursts_while_a_wave_admits_as_jax(weights):
    """A wave of two 45-token prompts (two chunks each) admitted beside two
    running rows: with prefill priority the step that runs their first
    chunk runs no decode burst, on both engines; every token equals the
    JAX engine's, and after the wave decode resumes and drains."""
    jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(5)
    short = [rng.integers(0, cfg.vocab_size, 5).tolist() for _ in range(2)]
    long = [rng.integers(0, cfg.vocab_size, 45).tolist() for _ in range(2)]
    out = {}
    for side, eng, sp in (
            ("jax", JEngine(jp, jcfg, kv_dtype=jnp.float32, prefill_priority=True, **ENGINE_KW),
             JSamplingParams(temperature=0.0, max_tokens=12)),
            ("port", _torch_engine(cfg, tp, prefill_priority=True),
             SamplingParams(temperature=0.0, max_tokens=12))):
        decodes, real = [], eng._decode_step

        def spy(finished, real=real, decodes=decodes):
            decodes.append(len(decodes))
            return real(finished)

        eng._decode_step = spy
        rids = [eng.add_request(p, sp) for p in short]
        done, trace = {}, []
        for _ in range(3):
            done.update({r.request_id: r for r in eng.step()})
        rids += [eng.add_request(p, sp) for p in long]
        while eng.has_work():
            before = len(decodes)
            admitting = eng.is_admitting
            done.update({r.request_id: r for r in eng.step()})
            trace.append((admitting, len(decodes) - before))
        out[side] = ([done[r].output_tokens for r in rids], trace, eng.step_dispatches_total)
        assert eng._allocator.free_count == eng._allocator.num_pages
    assert out["port"] == out["jax"]
    trace = out["port"][1]
    assert trace[0] == (True, 0)  # the wave's first chunk ran; no burst beside it
    assert any(n for _, n in trace[1:])  # decode resumed once the wave was in


def test_engine_warmup_runs_each_width(weights):
    _, cfg, _, tp = weights
    te = _torch_engine(cfg, tp, prefill_widths=3)
    widths = _record_widths(te)
    te.warmup()
    assert sorted({w for _, w in widths}) == [16, 32]
    assert te._allocator.free_count == te._allocator.num_pages and not te.has_work()
    assert _torch_engine(cfg, tp, layer_unroll=0).layer_unroll == 1
