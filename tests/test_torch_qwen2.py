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
