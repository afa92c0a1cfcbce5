"""Serving over tp / sp / ep meshes in the port (``Engine(mesh=)``, the
lockstep of ``serving/spmd.py``, the server's ``MESH_SHAPE``) against the
JAX package's, on the CPU.

One world of 4 gloo ranks (``tests/torch_mesh_ranks.mesh_serving_world``)
runs the multi-rank cases; JAX's engines run here on the 8-device virtual
CPU mesh over the same seeded numpy weights:

  - tp 2 greedy tokens equal JAX's tp 2 engine's (tests/test_parallel.py),
    on every rank; so do int8 and int4 weights, int8 pages and packed
    prefill on tp 2 (and the one-device engine's, as JAX's test_quant*.py
    and test_kv_quant.py hold), and int8 pages under the ring at sp 2; the
    W4A8 route on a rank's int4 slices within its tolerance of the exact
    route's logits;
  - ep 4: the MoE forward within JAX's 2e-4 of JAX's one-device logits, and
    the engine's greedy tokens equal JAX's ep 4 engine's (test_moe.py);
  - a 2-rank lockstep server: rank 0's ``AsyncEngine`` leads (three
    streams: one whole, one closed after its first token, one past its
    deadline), rank 1 follows; the whole stream equals JAX's tp 2 engine's.

The rest runs here: the int4 group-cut refusal, the mesh modes' refusals,
``MESH_SHAPE``'s plan and JAX's refusals, ``derive_sp_prefill_threshold``
against JAX's, and the ``longctx`` class on ``AsyncEngine``.
"""

from __future__ import annotations

import asyncio
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.quant import quantize_qwen2_params as j_quantize
from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from githubrepostorag_tpu.models.qwen2 import forward_with_attend as j_forward
from githubrepostorag_tpu.parallel import MeshPlan as JMeshPlan
from githubrepostorag_tpu.parallel import make_mesh as j_make_mesh
from githubrepostorag_tpu.serving import Engine as JEngine
from githubrepostorag_tpu.serving import SamplingParams as JSamplingParams
from githubrepostorag_tpu.serving.engine import derive_sp_prefill_threshold as j_derive
from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.obs import continuous, hbm, slo
from githubrepostorag_tpu_torch.parallel import Mesh, MeshPlan
from githubrepostorag_tpu_torch.serving.__main__ import check_model, check_served
from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine
from githubrepostorag_tpu_torch.serving.engine import Engine, derive_sp_prefill_threshold
from tests.test_torch_long_prefill import _free_port, weights
from tests.torch_mesh_ranks import TP_KW, WORLD, greedy, mesh_serving_world
from tests.torch_parallel_ranks import run_world

MOE_ATOL = 2e-4  # JAX's ep-sharded vs one-device logits bound
TP_PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]


def _jax_refs(jcfg, jp, mcfg, mp, moe_ids, moe_prompts) -> dict:
    """JAX's engines on the plans the ranks run, over the same weights."""
    def gen(eng, prompts, n):
        sp = JSamplingParams(max_tokens=n, temperature=0.0, stop_token_ids=())
        return [r.output_tokens for r in eng.generate(prompts, sp)]

    jp = jax.tree.map(jnp.asarray, jp)
    tp2 = j_make_mesh(JMeshPlan(tp=2))

    def on_tp2(p, **kw):
        return JEngine(p, jcfg, mesh=tp2, max_num_seqs=2, num_pages=32, page_size=4,
                       max_seq_len=64, prefill_chunk=32, kv_dtype=jnp.float32, decode_burst=8,
                       **kw)

    ref = {"tp2": gen(on_tp2(jp), TP_PROMPTS, 10),
           "int8": gen(on_tp2(j_quantize(jp)), TP_PROMPTS, 8),
           # on a tp mesh JAX's int4 takes the exact XLA route (_int4_kernel)
           "int4": gen(on_tp2(j_quantize(jp, bits=4, group_size=16)), TP_PROMPTS, 8),
           "kv8": gen(on_tp2(jp, kv_quant=True), TP_PROMPTS, 8),
           "packed": gen(on_tp2(jp, prefill_token_budget=16), TP_PROMPTS, 8)}
    sp2 = JEngine(jp, jcfg, mesh=j_make_mesh(JMeshPlan(sp=2)), sp_prefill_threshold=32,
                  kv_quant=True, max_num_seqs=4, num_pages=64, page_size=8, max_seq_len=256,
                  prefill_chunk=32, kv_dtype=jnp.float32, decode_burst=4)
    ref["kv8_sp"] = gen(sp2, [list(range(1, 41))], 6)
    assert sp2.sp_prefills == 1
    jmp = jax.tree.map(jnp.asarray, mp)
    ep4 = JEngine(jmp, mcfg, mesh=j_make_mesh(JMeshPlan(ep=4)), max_num_seqs=2, num_pages=32,
                  page_size=8, max_seq_len=64, prefill_chunk=32, kv_dtype=jnp.float32,
                  decode_burst=4)
    pos = jnp.broadcast_to(jnp.arange(16, dtype=jnp.int32), (2, 16))
    ref["ep4_engine"] = [gen(ep4, [p], 10)[0] for p in moe_prompts]
    ref["ep4_logits"] = np.asarray(jax.jit(lambda p: j_forward(p, mcfg, jnp.asarray(moe_ids),
                                                               pos))(jmp))
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's cases in one world of 4 ranks, JAX's references here
    while the world runs."""
    jcfg, mcfg = JQwen2Config.tiny(), JQwen2Config.tiny_moe()
    jp, mp = weights(jcfg, 1), weights(mcfg, 2)
    rng = np.random.default_rng(5)
    moe_ids = rng.integers(0, mcfg.vocab_size, (2, 16), dtype=np.int32)
    moe_prompts = [rng.integers(0, mcfg.vocab_size, 19).tolist() for _ in range(2)]
    out = tmp_path_factory.mktemp("mesh_serving_world")
    ids = rng.integers(0, mcfg.vocab_size, (2, 17))
    moe_batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:],
                 "mask": np.ones((2, 16), dtype=np.int64)}
    refs = {"params": jp, "moe_params": mp, "moe_ids": moe_ids, "moe_prompts": moe_prompts,
            "moe_batch": moe_batch, "lockstep_prompts": TP_PROMPTS + [[4, 4, 4]],
            "w4a8_ids": rng.integers(0, jcfg.vocab_size, (2, 16))}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, mesh_serving_world,
                            (f"127.0.0.1:{_free_port()}", refs, str(out)), nprocs=WORLD)
        ref = _jax_refs(jcfg, jp, mcfg, mp, moe_ids, moe_prompts)
        ranks.result()
    return {"ref": ref, "ranks": [torch.load(out / f"{r}.pt") for r in range(WORLD)]}


def _cases(world, key) -> list:
    got = [r[key] for r in world["ranks"] if key in r]
    assert got, key
    return got


def test_ranks_imported_no_jax(world):
    assert [r["jax_imported"] for r in world["ranks"]] == [False] * WORLD


def test_tp2_tokens_match_jax_on_every_rank(world):
    """tp 2: each rank holds half the heads, pools and MLP; the tokens
    equal JAX's tp 2 engine's on both ranks."""
    got = _cases(world, "tp2")
    assert len(got) == 2
    for tokens in got:
        assert tokens == world["ref"]["tp2"]


@pytest.mark.parametrize("case", ["int8", "int4", "kv8", "packed"])
def test_tp2_engine_token_identical_to_one_device(world, case):
    """int8 and int4 weights (int4 with ``INT4_W4A8=0``, the exact route,
    as JAX takes on a tp mesh), int8 pages and packed prefill on tp 2:
    greedy tokens equal JAX's tp 2 engine's on the same plan, on both
    ranks, and the port's one-device engine's (JAX's own tests)."""
    got = _cases(world, case)
    assert len(got) == 2 and got[0] == got[1]
    assert got[0]["mesh"] == world["ref"][case]
    assert got[0]["mesh"] == got[0]["one"]


def test_tp2_int4_w4a8_runs_kernel_e_route_on_slices(world):
    """At the default route the projections of a decode-sized batch take
    W4A8 on each rank's slices (the row-parallel wo holds half the input
    rows; JAX takes no W4A8 on a tp mesh, so the route has no JAX twin
    here): the logits of one forward over 32 rows part from the exact
    route's on the same slices no more than 1.25x as far as the one-device
    W4A8 route's part from its exact route's (a row-parallel slice
    quantizes its activations over its own K); the logits and the engine's
    tokens are the same on both ranks."""
    got = _cases(world, "int4_w4a8")
    assert torch.equal(got[0]["w4a8"], got[1]["w4a8"])
    assert got[0]["tokens"] == got[1]["tokens"]
    assert all(len(t) == 8 for t in got[0]["tokens"])
    assert got[0]["wo_rows"] == 64 // 2 // 2  # [in / 2 packed, out] over tp 2
    res = got[0]
    err = (res["w4a8"] - res["exact"]).abs().max().item()
    one_err = (res["one_w4a8"] - res["one_exact"]).abs().max().item()
    np.testing.assert_allclose(res["exact"].numpy(), res["one_exact"].numpy(), rtol=0, atol=1e-4)
    assert 0 < err <= 1.25 * one_err, (err, one_err)


def test_kv8_composes_with_sp_ring(world):
    """int8 pages under the ring at sp 2: one ring pass, and the tokens of
    JAX's sp 2 engine (tests/test_kv_quant.py), on both ranks."""
    got = _cases(world, "kv8_sp")
    assert len(got) == 2
    for res in got:
        assert res["sp_prefills"] == 1
        assert res["tokens"] == world["ref"]["kv8_sp"]


def test_ep4_forward_matches_jax(world):
    """ep 4: one expert a rank, routing over all of them, the combine
    summed over ep in float32."""
    ref = world["ref"]["ep4_logits"]
    for res in _cases(world, "ep4"):
        assert res["experts"] == 1
        np.testing.assert_allclose(res["forward"].numpy(), ref, rtol=MOE_ATOL, atol=MOE_ATOL)


def test_ep4_engine_tokens_match_jax(world):
    for res in _cases(world, "ep4"):
        assert res["engine"] == world["ref"]["ep4_engine"]


def test_ep4_train_step_gradients_match_one_device(world):
    """Over ep 4 the step's loss is one device's and every gradient leaf
    (a rank's expert slices; the router, attention and shared expert whole)
    equals one device's within 1e-5 x its max |g|: backward sums the
    input's and the router's gradients over ep."""
    from githubrepostorag_tpu_torch.training.step import leaves

    for res in _cases(world, "ep4_train"):
        loss, one_loss = res["loss"]
        assert abs(float(loss) - float(one_loss)) <= 1e-6 * abs(float(one_loss))
        for got, want in zip(leaves(res["grads"]), leaves(res["one_grads"])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()) + 1e-12)


def test_lockstep_server_over_two_ranks(world):
    """Rank 0 leads, rank 1 follows the same steps: the whole stream equals
    JAX's tp 2 engine's tokens, the closed stream ended after one token, the
    expired one was reaped, every page came back, and rank 1 stepped."""
    lead = world["ranks"][0]["lockstep"]
    whole, closed, expired = lead["streams"]
    assert whole == {"tokens": world["ref"]["tp2"][0], "finish": "length"}
    assert closed["finish"] == "closed" and len(closed["tokens"]) == 1
    assert expired == {"tokens": [], "finish": "deadline"}
    assert lead["free_pages"] == lead["num_pages"]
    assert world["ranks"][1]["lockstep"]["follower_steps"] > 0
    assert lead["messages"] > world["ranks"][1]["lockstep"]["follower_steps"]


# ------------------------------------------------------------ no world ----


def _tiny(**kw):
    return dataclasses.replace(Qwen2Config.tiny(), **kw)


def test_int4_group_cut_is_refused():
    """A row-parallel int4 slice must hold whole groups: wo's 64 input rows
    at group 64 are one group, which tp 2 would cut."""
    cfg = _tiny()
    params = params_from_jax(weights(JQwen2Config.tiny(), 3), cfg, device="cpu")
    q4 = quant.quantize_qwen2_params(params, bits=4, group_size=64)
    with pytest.raises(ValueError, match=r"'wo' has 1 groups of input rows, which tp=2"):
        Engine(q4, cfg, mesh=Mesh(MeshPlan(tp=2)), **TP_KW)
    # group 16: wo has 4 groups, whole on each rank; the mesh has no world
    with pytest.raises(ValueError, match="no process group"):
        Engine(quant.quantize_qwen2_params(params, bits=4, group_size=16), cfg,
               mesh=Mesh(MeshPlan(tp=2)), **TP_KW)


@pytest.mark.parametrize("plan,kw,match", [
    (dict(tp=2), dict(spec_ngram_k=4), "n-gram speculation"),
    (dict(sp=2), dict(kv_tier="on"), "host KV tier"),
    (dict(dp=2, tp=2), {}, "dp x tp fleets"),
    (dict(pp=2), {}, "pp is a training axis"),
    (dict(tp=4), {}, "tp=4 must divide"),
])
def test_mesh_refusals(plan, kw, match):
    cfg = Qwen2Config.tiny()
    params = params_from_jax(weights(JQwen2Config.tiny(), 3), cfg, device="cpu")
    with pytest.raises((NotImplementedError, ValueError), match=match):
        Engine(params, cfg, mesh=Mesh(MeshPlan(**plan)), **TP_KW, **kw)


@pytest.mark.parametrize("sp,explicit,env_set", [(1, 64, True), (2, 0, True), (2, 48, True),
                                                 (4, 0, False), (2, 0, False)])
def test_derive_sp_prefill_threshold_matches_jax(sp, explicit, env_set):
    for chunk, ctx in ((32, 256), (512, 11712), (512, 600)):
        kw = dict(sp=sp, explicit=explicit, env_set=env_set, prefill_chunk=chunk, max_seq_len=ctx)
        assert derive_sp_prefill_threshold(**kw) == j_derive(**kw)


@pytest.mark.parametrize("env,want", [
    ({}, MeshPlan()),
    ({"MESH_SHAPE": "tp:2"}, MeshPlan(tp=2)),
    ({"MESH_SHAPE": "sp:2,tp:2"}, MeshPlan(tp=2, sp=2)),
    ({"MESH_SHAPE": "ep:4"}, MeshPlan(ep=4)),
    ({"MESH_SHAPE": "dp:2"}, MeshPlan(dp=2)),
])
def test_mesh_shape_plans(monkeypatch, env, want):
    monkeypatch.delenv("MESH_SHAPE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    s = config.reload_settings()
    try:
        world = want.n_devices // want.dp
        assert check_served(s, world) == want
        assert check_model(s, want, Qwen2Config.tiny_moe()) == want
    finally:
        monkeypatch.undo()
        config.reload_settings()


@pytest.mark.parametrize("shape,world,moe,match", [
    ("pp:2", 2, False, "pp is a training-side axis"),
    ("ep:2", 2, False, "ep shards the expert stacks"),
    ("dp:2,tp:2", 4, False, "item 8.6"),
    ("tp:2", 1, False, "needs 2 ranks, the world has 1"),
    ("tp:two", 2, False, "bad MESH_SHAPE entry"),
])
def test_mesh_shape_refusals(monkeypatch, shape, world, moe, match):
    """pp and ep over a dense checkpoint exit with the JAX server's
    messages; dp beside another axis, and a plan the world cannot hold,
    exit too."""
    monkeypatch.setenv("MESH_SHAPE", shape)
    s = config.reload_settings()
    try:
        with pytest.raises(SystemExit, match=match):
            plan = check_served(s, world)
            check_model(s, plan, Qwen2Config.tiny_moe() if moe else Qwen2Config.tiny())
    finally:
        monkeypatch.undo()
        config.reload_settings()


def test_unset_mesh_shape_takes_the_heads_tp():
    """No MESH_SHAPE over a world of 8: plan_for_devices' tp, then capped by
    the checkpoint's heads (4 query, 2 kv: tp 2)."""
    s = config.reload_settings()
    plan = check_served(s, 8)
    assert plan == MeshPlan(tp=8)
    assert check_model(s, plan, Qwen2Config.tiny()) == MeshPlan(tp=2)


def test_longctx_class_on_async_engine():
    """A request of no stated class whose prompt takes the ring is put in
    the longctx class (JAX's AsyncEngine rule); a stated class stays."""
    cfg = Qwen2Config.tiny()
    params = params_from_jax(weights(JQwen2Config.tiny(), 3), cfg, device="cpu")
    engine = Engine(params, cfg, **TP_KW)
    engine.is_longctx = lambda n: n >= 20  # as a ring engine's would say
    engine._sp_eligible = lambda req: False  # no sp axis to route to
    seen = []
    add = engine.add_request

    def spy(*args, priority=None, **kw):
        seen.append(priority)
        return add(*args, priority=priority, **kw)

    engine.add_request = spy

    async def run():
        aeng = AsyncEngine(engine, replica="longctx")
        try:
            for prompt, cls in (([1] * 24, None), ([2] * 3, None), ([3] * 24, "batch")):
                await aeng.generate(prompt, greedy(2), priority=cls)
            return aeng.stats()
        finally:
            await aeng.stop()

    try:
        stats = asyncio.run(run())
    finally:
        # the AsyncEngine registered with the process-wide planes
        slo.reset_slo_plane()
        hbm.reset_hbm_plane()
        continuous.reset_profilers()
    assert seen == ["longctx", "interactive", "batch"]
    assert stats["sp_prefills"] == 0 and stats["sp_ring_segments"] == 0
