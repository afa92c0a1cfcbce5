"""The gloo ranks of tests/test_torch_long_prefill.py and
test_torch_mesh_serving.py: one world of ``WORLD`` CPU processes a file
(``tests/torch_parallel_ranks.run_world``'s forkserver), every rank running
every case of its file in the same order (groups and collectives are made
collectively).  Each rank saves what it computed to ``<out>/<rank>.pt``;
the test process holds that against JAX.  No rank imports jax.

Meshes: ranks 0-1 and 2-3 each form a 2-rank mesh (sp 2, tp 2) and run
their cases side by side; all four form tp 2 x sp 2 or ep 4.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time

import torch

from githubrepostorag_tpu_torch.models import quant
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, forward_with_attend
from githubrepostorag_tpu_torch.parallel import MeshPlan, make_mesh, maybe_initialize_distributed
from githubrepostorag_tpu_torch.serving import spmd
from githubrepostorag_tpu_torch.serving.engine import Engine
from githubrepostorag_tpu_torch.serving.sampling_params import SamplingParams

WORLD = 4
GROUP_TIMEOUT_S = 60.0
PAIRS = ([0, 1], [2, 3])

# the JAX long-prefill tests' geometry (tests/test_long_prefill.py)
LONG_KW = dict(max_num_seqs=4, num_pages=64, page_size=8, max_seq_len=256, prefill_chunk=32,
               kv_dtype=torch.float32, decode_burst=4, device="cpu")
# the JAX tp serving tests' geometry (tests/test_parallel.py, test_quant*.py)
TP_KW = dict(max_num_seqs=2, num_pages=32, page_size=4, max_seq_len=64, prefill_chunk=32,
             kv_dtype=torch.float32, decode_burst=8, device="cpu")


def greedy(max_tokens: int, **kw) -> SamplingParams:
    return SamplingParams(max_tokens=max_tokens, temperature=0.0, stop_token_ids=(), **kw)


def _join(rank: int, addr: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(JAX_COORDINATOR_ADDRESS=addr, JAX_NUM_PROCESSES=str(WORLD),
                      JAX_PROCESS_ID=str(rank))
    assert maybe_initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)


def _done(rank: int, out_dir: str, results: dict) -> None:
    results["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(results, os.path.join(out_dir, f"{rank}.pt"))
    torch.distributed.destroy_process_group()


def _pair_meshes(**plan):
    """Every rank makes both pairs' meshes (collectively); returns its own."""
    meshes = [make_mesh(MeshPlan(**plan), devices=pair) for pair in PAIRS]
    return next(m for m in meshes if m is not None)


def tokens(engine: Engine, prompts, sp) -> list[list[int]]:
    return [r.output_tokens for r in engine.generate(prompts, sp)]


def pools(engine: Engine) -> dict:
    p = engine._allocator.num_pages
    out = {"k": engine._k_pages[:, :, :p].clone(), "v": engine._v_pages[:, :, :p].clone()}
    if engine._k_scales is not None:
        out.update(ks=engine._k_scales[:, :, :p].clone(), vs=engine._v_scales[:, :, :p].clone())
    return out


# ------------------------------------------------------------ long prefill --


def long_prefill_world(rank: int, addr: str, refs: dict, out_dir: str) -> None:
    _join(rank, addr)
    cfg = Qwen2Config.tiny()
    params = params_from_jax(refs["params"], cfg, device="cpu")
    prompts = refs["prompts"]
    sp2 = _pair_meshes(sp=2)

    def chunked(**kw):
        return Engine(params, cfg, **LONG_KW, **kw)

    def ring(threshold=40, mesh=sp2, **kw):
        return Engine(params, cfg, mesh=mesh, sp_prefill_threshold=threshold, **LONG_KW, **kw)

    res = {"coords": sp2.coords}
    if rank in PAIRS[0]:
        # one prompt: tokens (with a repetition penalty) and pages
        sp = greedy(12, repetition_penalty=1.2)
        eng = ring()
        res["parity"] = {"ring": tokens(eng, [prompts["p48"]], sp), "sp_prefills": eng.sp_prefills,
                         "chunked": tokens(chunked(), [prompts["p48"]], sp)}
        a, b = chunked(), ring()
        a.generate([prompts["p56"]], greedy(1))
        b.generate([prompts["p56"]], greedy(1))
        res["pools"] = {"chunked": pools(a), "ring": pools(b), "sp_prefills": b.sp_prefills}
        a, b = chunked(kv_quant=True), ring(kv_quant=True)
        res["kv8"] = {"chunked": tokens(a, [prompts["p48b"]], greedy(12)),
                      "ring": tokens(b, [prompts["p48b"]], greedy(12)),
                      "sp_prefills": b.sp_prefills, "ring_pools": pools(b)}
        eng = ring()
        short = list(range(1, 21))
        res["short"] = {"ring": tokens(eng, [short], greedy(6)), "sp_prefills": eng.sp_prefills,
                        "chunked": tokens(chunked(), [short], greedy(6))}
        eng = ring()
        r1 = eng.add_request([1, 2, 3, 4], greedy(10))
        for _ in range(2):
            eng.step()
        r2 = eng.add_request(prompts["p64"], greedy(10))
        done = {}
        while eng.has_work():
            done.update({r.request_id: r.output_tokens for r in eng.step()})
        res["mixed"] = {"ring": [done[r1], done[r2]], "sp_prefills": eng.sp_prefills,
                        "solo": [tokens(chunked(), [p], greedy(10))[0]
                                 for p in ([1, 2, 3, 4], prompts["p64"])]}
        eng = ring()
        eng.generate([prompts["prefix_long"]], greedy(6))
        res["prefix"] = {"ring": tokens(eng, [prompts["prefix_short"]], greedy(6)),
                         "sp_prefills": eng.sp_prefills, "hit_tokens": eng._allocator.hit_tokens,
                         "chunked": tokens(chunked(), [prompts["prefix_short"]], greedy(6))}
        eng = ring()
        eng.warmup()
        warm = eng.sp_prefills
        res["warmup"] = {"warm": warm, "ring": tokens(eng, [prompts["p64"]], greedy(4)),
                         "sp_prefills": eng.sp_prefills,
                         "chunked": tokens(chunked(), [prompts["p64"]], greedy(4))}
        eng = chunked()
        eng.warmup()
        res["warmup_off"] = eng.sp_prefills
    else:
        # the packed passes
        three = [prompts[k] for k in ("p48", "p64", "p56")]
        packed, seq = ring(), ring(sp_ring_pack=False)
        res["packed"] = {"packed": tokens(packed, three, greedy(8)),
                         "packed_passes": packed.sp_prefills, "segments": packed.sp_ring_segments,
                         "seq": tokens(seq, three, greedy(8)), "seq_passes": seq.sp_prefills,
                         "solo": [tokens(chunked(), [p], greedy(8))[0] for p in three]}
        two = [prompts["p56"], prompts["p48"]]
        a, b = ring(), ring(sp_ring_pack=False)
        a.generate(two, greedy(1))
        b.generate(two, greedy(1))
        res["packed_pools"] = {"packed": pools(a), "seq": pools(b),
                               "passes": (a.sp_prefills, b.sp_prefills)}
        a, b = ring(kv_quant=True), ring(kv_quant=True, sp_ring_pack=False)
        two = [prompts["p48b"], prompts["p64"]]
        res["packed_kv8"] = {"packed": tokens(a, two, greedy(10)), "seq": tokens(b, two, greedy(10)),
                             "passes": a.sp_prefills, "packed_pools": pools(a),
                             "seq_pools": pools(b)}
        eng = ring()
        big = [prompts[k] for k in ("p120a", "p120b", "p112")]
        res["budget"] = {"ring": tokens(eng, big, greedy(6)), "passes": eng.sp_prefills,
                         "segments": eng.sp_ring_segments,
                         "solo": [tokens(chunked(), [p], greedy(6))[0] for p in big]}
        eng = ring()
        wave = [prompts["p48"], prompts["p44"], [3, 1, 4, 1, 5]]
        res["packed_mixed"] = {"ring": tokens(eng, wave, greedy(6)), "passes": eng.sp_prefills,
                               "segments": eng.sp_ring_segments,
                               "solo": [tokens(chunked(), [p], greedy(6))[0] for p in wave]}
        eng = ring()
        eng.generate([prompts["prefix_long"], prompts["p56"]], greedy(4))
        res["packed_prefix"] = {"ring": tokens(eng, [prompts["prefix_short2"]], greedy(4)),
                                "passes": eng.sp_prefills, "segments": eng.sp_ring_segments,
                                "hit_tokens": eng._allocator.hit_tokens,
                                "chunked": tokens(chunked(), [prompts["prefix_short2"]],
                                                  greedy(4))}
    # all four ranks: tp 2 x sp 2 over int8 pages, against JAX's engine
    full = make_mesh(MeshPlan(tp=2, sp=2))
    eng = ring(mesh=full, kv_quant=True)
    one = tokens(eng, [prompts["p48b"]], greedy(12))
    res["tp2sp2"] = {"coords": full.coords, "one": one, "pools": pools(eng)}
    wave = [prompts[k] for k in ("p48", "p64", "p56")] + [[3, 1, 4, 1, 5]]
    res["tp2sp2"].update(wave=tokens(eng, wave, greedy(8)), passes=eng.sp_prefills)
    _done(rank, out_dir, res)


# ----------------------------------------------------------- mesh serving --


def mesh_serving_world(rank: int, addr: str, refs: dict, out_dir: str) -> None:
    _join(rank, addr)
    cfg = Qwen2Config.tiny()
    params = params_from_jax(refs["params"], cfg, device="cpu")
    tp2 = _pair_meshes(tp=2)
    tp_prompts, sp8 = [[1, 2, 3, 4, 5], [9, 8, 7]], greedy(8)
    res = {"coords": tp2.coords}

    def pair(p, mesh=tp2, **kw):
        """Tokens of the mesh engine and the one-device engine over ``p``."""
        return {"mesh": tokens(Engine(p, cfg, mesh=mesh, **TP_KW, **kw), tp_prompts, sp8),
                "one": tokens(Engine(p, cfg, **TP_KW, **kw), tp_prompts, sp8)}

    if rank in PAIRS[0]:
        res["tp2"] = tokens(Engine(params, cfg, mesh=tp2, **TP_KW), tp_prompts, greedy(10))
        res["int8"] = pair(quant.quantize_qwen2_params(params))
        q4 = quant.quantize_qwen2_params(params, bits=4, group_size=16)
        os.environ["INT4_W4A8"] = "0"  # the exact route on both sides
        res["int4"] = pair(q4)
        del os.environ["INT4_W4A8"]
        eng = Engine(q4, cfg, mesh=tp2, **TP_KW)  # kernel E's route on the slices
        res["int4_w4a8"] = {"tokens": tokens(eng, tp_prompts, sp8),
                            "wo_rows": eng.params["layers"]["wo"].q.shape[-2]}
        # the logits of one forward over 32 rows, on the slices and on one
        # device: W4A8 (the automatic route) and the exact route
        ids = torch.from_numpy(refs["w4a8_ids"])
        pos = torch.arange(ids.shape[1]).expand(ids.shape)
        for route in ("exact", "w4a8"):
            if route == "exact":
                os.environ["INT4_W4A8"] = "0"
            res["int4_w4a8"][route] = forward_with_attend(eng.params, cfg, ids, pos, mesh=tp2)
            res["int4_w4a8"]["one_" + route] = forward_with_attend(q4, cfg, ids, pos)
            os.environ.pop("INT4_W4A8", None)
        res["kv8"] = pair(params, kv_quant=True)
        res["packed"] = pair(params, prefill_token_budget=16)
    else:
        sp2 = _pair_meshes(sp=2)
        eng = Engine(params, cfg, mesh=sp2, sp_prefill_threshold=32, kv_quant=True, **LONG_KW)
        res["kv8_sp"] = {"tokens": tokens(eng, [list(range(1, 41))], greedy(6)),
                         "sp_prefills": eng.sp_prefills}
    if rank in PAIRS[0]:
        _pair_meshes(sp=2)  # the other pair's sp meshes, made collectively
    # ep 4 over all ranks: the MoE forward and engine against JAX
    mcfg = Qwen2Config.tiny_moe()
    mparams = params_from_jax(refs["moe_params"], mcfg, device="cpu")
    ep4 = make_mesh(MeshPlan(ep=4))
    from githubrepostorag_tpu_torch.serving.engine import _local_slices

    local = _local_slices(mparams, mcfg, ep4)
    ids = torch.from_numpy(refs["moe_ids"])
    pos = torch.arange(ids.shape[1]).expand(ids.shape)
    res["ep4"] = {
        "experts": local["layers"]["e_wg"].shape[1],
        "forward": forward_with_attend(local, mcfg, ids, pos, mesh=ep4),
        "engine": [tokens(Engine(mparams, mcfg, mesh=ep4, max_num_seqs=2, num_pages=32,
                                 page_size=8, max_seq_len=64, prefill_chunk=32,
                                 kv_dtype=torch.float32, decode_burst=4, device="cpu"),
                          [p], greedy(10))[0] for p in refs["moe_prompts"]],
    }
    # a train step's gradients over ep 4 against one device's
    from githubrepostorag_tpu_torch.training.step import value_and_grad

    batch = {k: torch.from_numpy(v) for k, v in refs["moe_batch"].items()}
    loss, grads = value_and_grad(local, mcfg, ep4, batch, remat=False)
    one_loss, one_grads = value_and_grad(mparams, mcfg, None, batch, remat=False)
    res["ep4_train"] = {"loss": (loss, one_loss), "grads": grads,
                        "one_grads": _local_slices(one_grads, mcfg, ep4)}
    # the lockstep server over ranks 0-1 (tp 2): rank 0 streams, rank 1 follows
    control = spmd.control_group(PAIRS[0])
    if rank in PAIRS[0]:
        engine = Engine(params, cfg, mesh=tp2, **TP_KW)
        if rank == 0:
            res["lockstep"] = asyncio.run(_lead(engine, control, refs["lockstep_prompts"]))
        else:
            res["lockstep"] = {"follower_steps": spmd.follow(engine, control)}
    _done(rank, out_dir, res)


async def _lead(engine: Engine, control, prompts) -> dict:
    """Rank 0 of the lockstep test: an ``AsyncEngine`` whose driver leads;
    three streams at once, one cancelled after its first token, one whose
    deadline has passed on arrival."""
    from githubrepostorag_tpu_torch.serving.async_engine import AsyncEngine

    aeng = AsyncEngine(engine, replica="lockstep")
    aeng.lockstep = leader = spmd.Leader(control)

    async def run(i, prompt, cancel=False, deadline=None):
        agen = aeng.stream(prompt, greedy(10), request_id=f"r{i}", deadline_s=deadline)
        async for ev in agen:
            if ev.type == "token" and cancel:
                break
            if ev.type == "final":
                return {"tokens": ev.result.output_tokens, "finish": ev.result.finish_reason}
        await agen.aclose()  # the stream left first: its request is cancelled
        return {"tokens": [ev.token_id], "finish": "closed"}

    await aeng.start()
    got = await asyncio.gather(run(0, prompts[0]), run(1, prompts[1], cancel=True),
                               run(2, prompts[2], deadline=time.monotonic() - 1.0))
    while engine.has_work():  # the closed stream's cancel lands
        await asyncio.sleep(0.01)
    await aeng.stop()
    leader.close()
    return {"streams": got, "messages": leader.messages, "free_pages": engine._allocator.free_count,
            "num_pages": engine._allocator.num_pages}
