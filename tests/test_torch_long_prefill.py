"""The port's sequence-parallel ring prefill (``serving/long_prefill.py``,
``Engine(mesh=, sp_prefill_threshold=)``) against the JAX package's, on the
CPU: the 14 cases of tests/test_long_prefill.py over gloo ranks, one case
at tp 2 x sp 2, and the pools of every sp rank.

One world of 4 gloo ranks (``tests/torch_mesh_ranks.long_prefill_world``)
runs every port case, held against the port's chunked path as JAX's tests
hold JAX's, and against JAX's ring engines (float32 pages at sp 2, int8
pages at tp 2 x sp 2), run here on the 8-device virtual CPU mesh over the
same seeded numpy weights while the world runs.
Tolerances are JAX's own: greedy tokens identical, pool pages within 1e-5
of the chunked path's, int8 pages within 2 codes and their scales within
2e-2 relative.
"""

from __future__ import annotations

import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from githubrepostorag_tpu.models.qwen2 import init_params as j_init_params
from githubrepostorag_tpu.ops.packed_prefill import ring_segment_layout as j_layout
from githubrepostorag_tpu.parallel import MeshPlan as JMeshPlan
from githubrepostorag_tpu.parallel import make_mesh as j_make_mesh
from githubrepostorag_tpu.serving import Engine as JEngine
from githubrepostorag_tpu.serving import SamplingParams as JSamplingParams
from githubrepostorag_tpu_torch.ops.packed_prefill import ring_segment_layout
from tests.torch_mesh_ranks import WORLD, long_prefill_world
from tests.torch_parallel_ranks import run_world

POOL_TOL = 1e-5  # JAX's ring-vs-chunked pool bound


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def weights(jcfg, seed: int, scale: float = 0.3) -> dict:
    """Seeded numpy weights in JAX's tree (shapes by ``jax.eval_shape``),
    normal(0, scale): at the init's 0.02 every greedy token repeats."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))

    def fill(name, node):
        if isinstance(node, dict):
            return {k: fill(k, v) for k, v in node.items()}
        if name in ("ln1", "ln2", "norm"):
            return (1.0 + 0.1 * rng.standard_normal(node.shape)).astype(np.float32)
        return (scale * rng.standard_normal(node.shape)).astype(np.float32)

    return fill("", shapes)


def _prompts(vocab: int) -> dict:
    def draw(seed, n):
        return np.random.default_rng(seed).integers(0, vocab, n).tolist()

    prefix = draw(3, 24)
    big = np.random.default_rng(14)
    return {"p48": draw(0, 48), "p56": draw(1, 56), "p64": draw(2, 64), "p48b": draw(4, 48),
            "p44": draw(16, 44), "prefix_long": prefix + draw(5, 24),
            "prefix_short": prefix + [7, 8, 9], "prefix_short2": prefix + [5, 6],
            **{k: big.integers(0, vocab, n).tolist()
               for k, n in (("p120a", 120), ("p120b", 120), ("p112", 112))}}


def _jax_refs(jcfg, jp, prompts) -> dict:
    """JAX's ring engines: float32 pages at sp 2 (one prompt's pages, then
    a prompt's tokens under a repetition penalty) and int8 pages at tp 2 x
    sp 2 (one prompt, then a packed wave of three long prompts and a short
    one)."""
    def engine(plan, **kw):
        return JEngine(jax.tree.map(jnp.asarray, jp), jcfg, max_num_seqs=4, num_pages=64,
                       page_size=8, max_seq_len=256, prefill_chunk=32, kv_dtype=jnp.float32,
                       decode_burst=4, mesh=j_make_mesh(plan), sp_prefill_threshold=40, **kw)

    def run(eng, batch, n, **kw):
        sp = JSamplingParams(max_tokens=n, temperature=0.0, stop_token_ids=(), **kw)
        return [r.output_tokens for r in eng.generate(batch, sp)]

    eng = engine(JMeshPlan(sp=2))
    run(eng, [prompts["p56"]], 1)
    ref = {"sp2_pools": {"k": np.asarray(eng._k_pages), "v": np.asarray(eng._v_pages)},
           "sp2_parity": run(eng, [prompts["p48"]], 12, repetition_penalty=1.2)}
    assert eng.sp_prefills == 2
    eng = engine(JMeshPlan(tp=2, sp=2), kv_quant=True)
    ref["one"] = run(eng, [prompts["p48b"]], 12)
    ref["pools"] = {"k": np.asarray(eng._k_pages), "v": np.asarray(eng._v_pages),
                    "ks": np.asarray(eng._k_scales)}
    ref["wave"] = run(eng, [prompts[k] for k in ("p48", "p64", "p56")] + [[3, 1, 4, 1, 5]], 8)
    assert eng.sp_prefills == 2
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's cases in one world of 4 ranks, JAX's references here
    while the world runs."""
    jcfg = JQwen2Config.tiny()
    jp = weights(jcfg, 0)
    prompts = _prompts(jcfg.vocab_size)
    out = tmp_path_factory.mktemp("long_prefill_world")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_world, long_prefill_world,
                            (f"127.0.0.1:{_free_port()}", {"params": jp, "prompts": prompts},
                             str(out)), nprocs=WORLD)
        ref = _jax_refs(jcfg, jp, prompts)
        ranks.result()
    return {"ref": ref, "ranks": [torch.load(out / f"{r}.pt") for r in range(WORLD)]}


def _near_jax_pools(got: dict, ref: dict, heads: slice) -> None:
    """int8 pages within 2 codes of JAX's ring pages, scales within 2e-2
    (JAX's bounds), over this rank's kv heads."""
    p = got["k"].shape[2]
    for name in ("k", "v"):
        diff = np.abs(ref[name][:, heads, :p].astype(np.int32) - got[name].numpy())
        assert diff.max() <= 2, name
    np.testing.assert_allclose(ref["ks"][:, heads, :p], got["ks"].numpy(), rtol=2e-2, atol=1e-7)


def _cases(world, key) -> list:
    """Every rank's result of ``key``, which must be the same on each."""
    got = [r[key] for r in world["ranks"] if key in r]
    assert got, key
    return got


def _same(results: list) -> dict:
    """One rank's result; every other rank's tokens and counts equal it."""
    first = results[0]
    for other in results[1:]:
        for k, v in first.items():
            if not isinstance(v, dict):
                assert other[k] == v, k
    return first


def test_ranks_imported_no_jax(world):
    assert [r["jax_imported"] for r in world["ranks"]] == [False] * WORLD


def test_ring_segment_layout_matches_jax():
    for lens, width, rb in (([48, 64, 56], 256, 4), ([7], 8, 1), ([3, 1, 2], 16, 8)):
        for ours, theirs in zip(ring_segment_layout(lens, width, rb), j_layout(lens, width, rb)):
            assert np.array_equal(ours, theirs)
    with pytest.raises(ValueError, match="do not fit"):
        ring_segment_layout([9], 8, 1)


def test_ring_prefill_token_parity_with_chunked(world):
    """Tokens under a repetition penalty equal the chunked path's and JAX's
    sp 2 ring engine's."""
    res = _same(_cases(world, "parity"))
    assert res["sp_prefills"] == 1, "a prompt above the threshold rides the ring"
    assert res["ring"] == res["chunked"] == world["ref"]["sp2_parity"]


def test_ring_prefill_pool_contents_match_chunked(world):
    """The pages the ring writes equal the chunked path's, and JAX's sp 2
    ring engine's: decode after a ring prefill reads the same cache."""
    ref = world["ref"]["sp2_pools"]
    for res in _cases(world, "pools"):
        assert res["sp_prefills"] == 1
        for name in ("k", "v"):
            ring = res["ring"][name].numpy()
            np.testing.assert_allclose(ring, res["chunked"][name].numpy(),
                                       rtol=POOL_TOL, atol=POOL_TOL, err_msg=name)
            np.testing.assert_allclose(ring, ref[name][:, :, :ring.shape[2]],
                                       rtol=POOL_TOL, atol=POOL_TOL, err_msg=name)


def test_ring_prefill_kv_quant_matches_chunked(world):
    """int8 pages at sp 2: the ring commit quantizes with the chunked path's
    first-write scales.  Tokens equal the chunked path's and JAX's ring
    engine's; pages within 2 codes of JAX's ring pages.  (Against the
    chunked path's pages JAX's own bound of 2 codes does not hold at these
    weights, in either package: the chunked path's later chunks attend over
    quantized pages, the ring's do not, and both packages differ by the
    same 5 codes here.)"""
    for res in _cases(world, "kv8"):
        assert res["sp_prefills"] == 1
        assert res["ring"] == res["chunked"] == world["ref"]["one"]
        _near_jax_pools(res["ring_pools"], world["ref"]["pools"], slice(None))


def test_short_prompts_stay_on_chunked_path(world):
    res = _same(_cases(world, "short"))
    assert res["sp_prefills"] == 0
    assert res["ring"] == res["chunked"]


def test_mixed_long_short_continuous_batching(world):
    res = _same(_cases(world, "mixed"))
    assert res["sp_prefills"] == 1
    assert res["ring"] == res["solo"]


def test_sp_prefill_registers_prefix_for_chunked_followers(world):
    res = _same(_cases(world, "prefix"))
    assert res["sp_prefills"] == 1
    assert res["ring"] == res["chunked"]
    assert res["hit_tokens"] == 24  # 3 pages resumed from the cache


def test_warmup_precompiles_ring_prefill_buckets(world):
    """Warmup runs one prompt a ring width (64 / 128 / 256 at threshold 40
    and max_seq_len 256) and leaves the engine clean."""
    res = _same(_cases(world, "warmup"))
    assert res["warm"] == 3
    assert res["sp_prefills"] == 4
    assert res["ring"] == res["chunked"]


def test_warmup_skips_ring_prefill_when_disabled(world):
    assert set(_cases(world, "warmup_off")) == {0}


def test_packed_ring_multi_segment_token_parity(world):
    res = _same(_cases(world, "packed"))
    assert res["packed_passes"] == 1 and res["segments"] == 3
    assert res["seq_passes"] == 3
    assert res["packed"] == res["seq"] == res["solo"]


def test_packed_ring_pool_contents_match_seq(world):
    for res in _cases(world, "packed_pools"):
        assert res["passes"] == (1, 2)
        for name in ("k", "v"):
            np.testing.assert_allclose(res["packed"][name].numpy(), res["seq"][name].numpy(),
                                       rtol=POOL_TOL, atol=POOL_TOL, err_msg=name)


def test_packed_ring_kv_quant_parity(world):
    for res in _cases(world, "packed_kv8"):
        assert res["passes"] == 1
        assert res["packed"] == res["seq"]
        for name in ("k", "v"):
            diff = (res["packed_pools"][name].int() - res["seq_pools"][name].int()).abs()
            assert diff.max() <= 2, name


def test_packed_ring_token_budget_splits_passes(world):
    """120 + 120 fill the 256-wide pass; the 112-token third rides the next."""
    res = _same(_cases(world, "budget"))
    assert res["passes"] == 2 and res["segments"] == 3
    assert res["ring"] == res["solo"]


def test_packed_ring_mixed_with_short_chunked_rows(world):
    res = _same(_cases(world, "packed_mixed"))
    assert res["passes"] == 1 and res["segments"] == 2
    assert res["ring"] == res["solo"]


def test_packed_ring_registers_prefix_for_chunked_followers(world):
    res = _same(_cases(world, "packed_prefix"))
    assert res["passes"] == 1 and res["segments"] == 2
    assert res["ring"] == res["chunked"]
    assert res["hit_tokens"] == 24


def test_tp2_sp2_ring_matches_jax(world):
    """tp 2 x sp 2 over int8 pages: the ring on each rank's heads; tokens
    equal JAX's engine on the same plan, on every rank, and each rank's
    pages are within JAX's bounds of JAX's for its kv head."""
    for res in _cases(world, "tp2sp2"):
        assert res["passes"] == 2
        assert res["one"] == world["ref"]["one"] and res["wave"] == world["ref"]["wave"]
        tp = res["coords"]["tp"]
        _near_jax_pools(res["pools"], world["ref"]["pools"], slice(tp, tp + 1))


def test_pools_equal_on_every_sp_rank(world):
    """The K/V shards are gathered over sp before the commit, so every rank
    of an sp group holds the same pages, bit for bit (and at tp 2 x sp 2,
    the ranks of one tp coordinate)."""
    ranks = world["ranks"]
    for key in ("pools", "packed_pools", "packed_kv8"):
        holders = [r for r in ranks if key in r]
        assert len(holders) == 2
        a, b = (r[key] for r in holders)
        for name in a:
            if isinstance(a[name], dict):
                for field in a[name]:
                    assert torch.equal(a[name][field], b[name][field]), (key, name, field)
    by_tp = {}
    for r in ranks:
        by_tp.setdefault(r["tp2sp2"]["coords"]["tp"], []).append(r["tp2sp2"]["pools"])
    assert sorted(len(v) for v in by_tp.values()) == [2, 2]
    for a, b in by_tp.values():
        for name in a:
            assert torch.equal(a[name], b[name]), name
