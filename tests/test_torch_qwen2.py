"""The port's Qwen2 model against the JAX package on identical weights
(CPU, float32, tiny config): parameter conversion, dense ``forward`` with
and without a cache, and paged ``forward_paged`` logits, with plain and
with quantized weights (int4 group 16 or int8 projections, int8 embedding
table, tied or int4 / int8 lm_head), plus the HF state-dict loader.
Logits tolerance 1e-4 absolute: two layers of the same float32 arithmetic
summed in another order (for int4, the same dequantized weights)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models import qwen2 as jq
from githubrepostorag_tpu.models.quant import fuse_projections as j_fuse
from githubrepostorag_tpu.models.quant import quantize_qwen2_params as j_quantize
from githubrepostorag_tpu_torch.models import qwen2 as tq
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.quant import fuse_projections as t_fuse
from githubrepostorag_tpu_torch.serving.kv_cache import slot_mapping

ATOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = jq.Qwen2Config.tiny(), tq.Qwen2Config.tiny()
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    # non-zero biases and norm weights so every leaf is exercised
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.02, x.dtype), jp)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def test_params_from_jax_is_exact(weights):
    _, _, jp, tp = weights
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(tp["layers"]) + 2
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(leaf))
    fused = params_from_jax(jax.tree.map(np.asarray, j_fuse(jp)), weights[1], device="cpu")
    np.testing.assert_array_equal(fused["layers"]["wqkv"].numpy(),
                                  t_fuse(tp)["layers"]["wqkv"].numpy())


def test_forward_matches_jax(weights):
    jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    j_logits, _ = jq.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos))
    t_logits, _ = tq.forward(tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos))
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0)
    # the fused serving layout computes the same thing
    f_logits, _ = tq.forward(t_fuse(tp), cfg, torch.from_numpy(ids), torch.from_numpy(pos))
    np.testing.assert_allclose(f_logits.numpy(), t_logits.numpy(), atol=ATOL, rtol=0)


def test_forward_with_dense_cache_matches_jax(weights):
    jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(2)
    b, s, cache_len = 2, 4, 16
    ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    lens = np.asarray([3, 7], dtype=np.int32)
    pos = lens[:, None] + np.arange(s, dtype=np.int32)
    shape = (cfg.num_layers, b, cache_len, cfg.num_kv_heads, cfg.head_dim)
    cache = rng.normal(size=shape).astype(np.float32)
    j_logits, (jk, jv) = jq.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                                    jnp.asarray(cache), jnp.asarray(cache), jnp.asarray(lens))
    ck, cv = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
    t_logits, _ = tq.forward(tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos), ck, cv,
                             torch.from_numpy(lens))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tq.forward(tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos), ck, cv,
                   torch.tensor([cache_len - 2, 0], dtype=torch.int32))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_forward_paged_matches_jax(weights, use_kernels):
    jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(3)
    b, s, ps, num_pages, max_pages = 3, 8, 4, 16, 5
    cached = np.asarray([4, 0, 0], dtype=np.int32)
    new = np.asarray([6, 8, 0], dtype=np.int32)  # row 2 is bucket padding
    # shuffled tables; row 1 owns the pool's last page
    bt = np.asarray([[9, 2, 12, 0, 0], [15, 4, 0, 0, 0], [0] * 5], dtype=np.int32)
    ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    pos = cached[:, None] + np.arange(s, dtype=np.int32)
    slots = np.stack([slot_mapping(bt[i], int(cached[i]), int(new[i]), ps, s) for i in range(b)])
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, ps, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    logits_at = np.maximum(new - 1, 0).astype(np.int32)

    j_logits, jk, jv = jq.forward_paged(
        jp, jcfg, *(jnp.asarray(x) for x in (ids, pos, kp, vp, slots, bt, cached, new)),
        use_pallas=False, logits_at=jnp.asarray(logits_at))
    # the port's pools carry one extra page, the drop page of commit_paged
    drop = np.zeros(shape[:2] + (1,) + shape[3:], np.float32)
    tkp = torch.from_numpy(np.concatenate([kp, drop], axis=2))
    tvp = torch.from_numpy(np.concatenate([vp, drop], axis=2))
    t_logits, tk, tv = tq.forward_paged(
        tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos), tkp, tvp,
        *(torch.from_numpy(x) for x in (slots, bt, cached, new)),
        use_kernels=use_kernels, logits_at=torch.from_numpy(logits_at))
    assert tk is tkp and tv is tvp  # pools update in place
    np.testing.assert_allclose(t_logits[:2].numpy(), np.asarray(j_logits)[:2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkp[:, :, :num_pages].numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tvp[:, :, :num_pages].numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_params_from_state_dict_matches_jax_loader():
    transformers = pytest.importorskip("transformers")
    from githubrepostorag_tpu.models import hf_loader as j_loader
    from githubrepostorag_tpu_torch.models import hf_loader as t_loader

    hf_cfg = transformers.Qwen2Config(
        vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=False, attention_dropout=0.0,
    )
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    sd = model.state_dict()
    jcfg = j_loader.config_from_hf(hf_cfg.to_dict())
    cfg = t_loader.config_from_hf(hf_cfg.to_dict())
    assert cfg.num_layers == jcfg.num_layers and cfg.head_dim == jcfg.head_dim
    jp = j_loader.params_from_state_dict(sd, jcfg)
    tp = t_loader.params_from_state_dict(sd, cfg, device="cpu")
    np.testing.assert_array_equal(tp["lm_head"].numpy(), jp["lm_head"])
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][name].numpy(), leaf)
    ids = torch.randint(0, 256, (1, 9))
    with torch.no_grad():
        hf_logits = model(ids).logits
    t_logits, _ = tq.forward(tp, cfg, ids, torch.arange(9)[None])
    np.testing.assert_allclose(t_logits.numpy(), hf_logits.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bits, tied", [(4, True), (4, False), (8, False)])
def test_quantized_forward_and_forward_paged_match_jax(bits, tied, monkeypatch):
    """The same quantized tree (converted from the JAX one) through both
    packages.  ``forward`` runs the exact bf16-dequant route on both sides
    (INT4_W4A8=0 for the port: the JAX package's CPU path never takes
    W4A8; the W4A8 route is held to the JAX kernel in
    test_torch_engine.py); ``forward_paged`` pins that route itself."""
    jcfg = dataclasses.replace(jq.Qwen2Config.tiny(), tie_word_embeddings=tied)
    cfg = dataclasses.replace(tq.Qwen2Config.tiny(), tie_word_embeddings=tied)
    rng = np.random.default_rng(5)
    jp = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.02, x.dtype),
                      jq.init_params(jcfg, jax.random.PRNGKey(1)))
    jp = j_quantize(jp, bits=bits, group_size=16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert type(tp["embed"]).__name__ == "QuantizedEmbedding"
    assert ("lm_head" in tp) is not tied

    monkeypatch.setenv("INT4_W4A8", "0")
    ids = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    j_logits, _ = jq.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos))
    t_logits, _ = tq.forward(tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos))
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=ATOL, rtol=0)
    monkeypatch.delenv("INT4_W4A8")

    b, s, ps, num_pages = 2, 8, 4, 8
    bt = np.asarray([[5, 1, 6], [2, 7, 0]], dtype=np.int32)
    cached, new = np.asarray([3, 0], np.int32), np.asarray([5, 8], np.int32)
    ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    pos = cached[:, None] + np.arange(s, dtype=np.int32)
    slots = np.stack([slot_mapping(bt[i], int(cached[i]), int(new[i]), ps, s) for i in range(b)])
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, ps, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    j_logits, jk, _ = jq.forward_paged(
        jp, jcfg, *(jnp.asarray(x) for x in (ids, pos, kp, kp, slots, bt, cached, new)),
        use_pallas=False)
    drop = np.zeros(shape[:2] + (1,) + shape[3:], np.float32)
    for use_kernels in (True, False):
        tkp = torch.from_numpy(np.concatenate([kp, drop], axis=2))
        tvp = tkp.clone()
        t_logits, _, _ = tq.forward_paged(
            tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos), tkp, tvp,
            *(torch.from_numpy(x) for x in (slots, bt, cached, new)), use_kernels=use_kernels)
        valid = np.arange(s)[None, :] < new[:, None]
        np.testing.assert_allclose(t_logits.numpy()[valid], np.asarray(j_logits)[valid],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(tkp[:, :, :num_pages].numpy(), np.asarray(jk), atol=ATOL, rtol=0)


def _pools_pair(rng, cfg, num_pages, ps, quant):
    """Matching JAX and port pools: random float32 pages, or zeroed
    quantized pages and scales (the port's with the drop page)."""
    from githubrepostorag_tpu_torch.serving.kv_cache import make_page_pools

    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, ps, cfg.head_dim)
    if not quant:
        kv = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
        drop = np.zeros(shape[:2] + (1,) + shape[3:], np.float32)
        t = [torch.from_numpy(np.concatenate([x, drop], axis=2)) for x in kv]
        return [jnp.asarray(x) for x in kv] + [None, None], t + [None, None]
    from githubrepostorag_tpu.serving.kv_cache import make_page_pools as j_make

    jpools = j_make(jq.Qwen2Config.tiny(), num_pages, ps, quant=quant)
    tpools = make_page_pools(cfg, num_pages, ps, device="cpu", quant=quant)
    return [jpools.k, jpools.v, jpools.ks, jpools.vs], [tpools.k, tpools.v, tpools.ks, tpools.vs]


def _assert_pools_match(t_pools, j_pools, num_pages):
    """Pools on the real pages: float pages within ATOL; quantized codes
    bit for bit and their scales within 1e-6 relative (the K/V feeding
    them agree to float32 summation order)."""
    for t, j in zip(t_pools, j_pools + [None] * (4 - len(j_pools))):
        if t is None:
            continue
        t, j = t[:, :, :num_pages].numpy(), np.asarray(j)
        if t.dtype == np.float32 and t.ndim == 3:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        elif t.dtype == np.float32:
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("quant", [8, 4])
def test_forward_paged_quantized_pools_match_jax(weights, quant):
    """Two chunks into zeroed int8 / int4 pools: the first opens pages and
    fixes their scales, the second resumes mid-page and appends with the
    stored scales.  Logits, pool codes and scales against JAX."""
    jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(20 + quant)
    b, s, ps, num_pages = 2, 6, 4, 8
    bt = np.asarray([[5, 1, 6], [2, 7, 0]], dtype=np.int32)
    jpools, tpools = _pools_pair(rng, cfg, num_pages, ps, quant)
    for cached, new in (([0, 0], [6, 3]), ([6, 3], [5, 6])):
        cached, new = np.asarray(cached, np.int32), np.asarray(new, np.int32)
        ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
        pos = cached[:, None] + np.arange(s, dtype=np.int32)
        slots = np.stack([slot_mapping(bt[i], int(cached[i]), int(new[i]), ps, s)
                          for i in range(b)])
        j_slots = np.where(slots < 0, num_pages * ps, slots)  # JAX drops the sentinel
        j_logits, *jpools = jq.forward_paged(
            jp, jcfg, *(jnp.asarray(x) for x in (ids, pos)), jpools[0], jpools[1],
            *(jnp.asarray(x) for x in (j_slots, bt, cached, new)), use_pallas=False,
            k_scales=jpools[2], v_scales=jpools[3])
        t_logits, *out = tq.forward_paged(
            tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos), tpools[0], tpools[1],
            *(torch.from_numpy(x) for x in (slots, bt, cached, new)),
            k_scales=tpools[2], v_scales=tpools[3])
        assert all(o is t for o, t in zip(out, tpools))  # pools and scales in place
        valid = np.arange(s)[None, :] < new[:, None]
        np.testing.assert_allclose(t_logits.numpy()[valid], np.asarray(j_logits)[valid],
                                   atol=ATOL, rtol=0)
        _assert_pools_match(tpools, jpools, num_pages)
    assert tpools[2][:, :, 5].all()  # page 5 opened by the first chunk


@pytest.mark.parametrize("quant", [0, 8])
def test_forward_paged_packed_matches_jax(weights, quant):
    """One packed wave of three segments (a resume mid-page, a fresh chunk,
    a one-token tail) and padding, logits per segment and pools, against
    the JAX function's XLA path."""
    from githubrepostorag_tpu.serving.kv_cache import packed_slot_mapping as j_psm
    from githubrepostorag_tpu_torch.serving.kv_cache import packed_slot_mapping

    jcfg, cfg, jp, tp = weights
    rng = np.random.default_rng(30 + quant)
    ps, num_pages, tq_, budget, rb = 4, 12, 6, 16, 4
    bt = np.zeros((rb, 3), np.int32)
    bt[:3] = [[3, 9, 0], [11, 1, 4], [6, 2, 8]]
    cached = np.asarray([5, 0, 7, 0], np.int32)
    new = np.asarray([6, 5, 1, 0], np.int32)  # segment 3 is bucket padding
    ids = np.zeros((1, budget), np.int32)
    pos = np.zeros((1, budget), np.int32)
    seg = np.full((budget,), rb, np.int32)
    slots = np.full((budget,), -1, np.int32)
    logits_at = np.zeros((rb,), np.int32)
    off = 0
    for i in range(3):
        n = int(new[i])
        ids[0, off:off + n] = rng.integers(0, cfg.vocab_size, n)
        pos[0, off:off + n] = np.arange(cached[i], cached[i] + n)
        seg[off:off + n] = i
        packed_slot_mapping(bt[i], int(cached[i]), n, ps, slots, off)
        logits_at[i] = off + n - 1
        off += n
    j_slots = np.full((budget,), -1, np.int32)
    for i, o in ((0, 0), (1, 6), (2, 11)):
        j_psm(bt[i], int(cached[i]), int(new[i]), ps, j_slots, o)
    np.testing.assert_array_equal(slots, j_slots)
    jpools, tpools = _pools_pair(rng, cfg, num_pages, ps, quant)
    j_logits, *jpools = jq.forward_paged_packed(
        jp, jcfg, *(jnp.asarray(x) for x in (ids, pos)), jpools[0], jpools[1],
        *(jnp.asarray(x) for x in (slots, bt, cached, new, seg, logits_at)), tq=tq_,
        use_pallas=False, k_scales=jpools[2], v_scales=jpools[3])
    for use_kernels in (True, False):
        t_pools = [None if t is None else t.clone() for t in tpools]
        t_logits, *out = tq.forward_paged_packed(
            tp, cfg, torch.from_numpy(ids), torch.from_numpy(pos), t_pools[0], t_pools[1],
            *(torch.from_numpy(x) for x in (slots, bt, cached, new, seg, logits_at)), tq_,
            use_kernels=use_kernels, k_scales=t_pools[2], v_scales=t_pools[3])
        assert t_logits.shape == (rb, 1, cfg.vocab_size)
        np.testing.assert_allclose(t_logits[:3].numpy(), np.asarray(j_logits)[:3], atol=ATOL,
                                   rtol=0)
        _assert_pools_match(t_pools, jpools, num_pages)
