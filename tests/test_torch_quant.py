"""The port's weight quantization (models/quant.py, the AWQ repacker of
models/hf_loader.py, and quantized leaves in models/convert.py) against
the JAX package on the same numpy inputs (CPU, tiny shapes, group 16).

Quantized codes and bf16 scales must be bit-identical: both sides round
the same float32 values half to even.  Dequantized weights and the
two-dot oracle ``q4_matmul`` agree to 1e-6 absolute (float32 arithmetic
on values of about 0.02 to 1)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.models import hf_loader as j_loader
from githubrepostorag_tpu.models import quant as jq
from githubrepostorag_tpu.models.qwen2 import Qwen2Config as JConfig, init_params as j_init
from githubrepostorag_tpu_torch.models import hf_loader as t_loader
from githubrepostorag_tpu_torch.models import quant as tq
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, forward

G = 16


def _np(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy, bf16 as its raw bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_leaf(t_leaf, j_leaf):
    assert type(t_leaf).__name__ == type(j_leaf).__name__
    for t_f, j_f in zip(t_leaf, j_leaf):
        np.testing.assert_array_equal(_np(t_f), _np(j_f))


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48), (2, 3, 64, 48)])
def test_quantizers_bit_exact(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.02, shape).astype(np.float32)
    w[..., :G, 0] = 0.5  # a constant group: scale floors at 1e-8
    _assert_same_leaf(tq.quantize_weight4(torch.from_numpy(w), G), jq.quantize_weight4(w, G))
    _assert_same_leaf(tq.quantize_weight(torch.from_numpy(w)), jq.quantize_weight(w))
    emb = w.reshape(-1, shape[-1])
    _assert_same_leaf(tq.quantize_embedding(torch.from_numpy(emb)), jq.quantize_embedding(emb))
    with pytest.raises(ValueError):
        tq.quantize_weight4(torch.from_numpy(w), 24)


def test_dequantize_and_q4_matmul_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.02, (64, 48)).astype(np.float32)
    j4, t4 = jq.quantize_weight4(w, G), tq.quantize_weight4(torch.from_numpy(w), G)
    j8, t8 = jq.quantize_weight(w), tq.quantize_weight(torch.from_numpy(w))
    for j, t in ((j4, t4), (j8, t8)):
        np.testing.assert_allclose(tq.dequantize(t, torch.float32).numpy(),
                                   np.asarray(jq.dequantize(j, jnp.float32)), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(
            tq.dequant_weight(t, torch.float32).numpy(),
            np.asarray(jq.dequant_weight(j, jnp.float32)))
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    for preferred in (None, torch.float32):
        got = tq.q4_matmul(torch.from_numpy(x), t4, preferred=preferred)
        ref = jq.q4_matmul(jnp.asarray(x), j4, preferred=preferred and jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def _awq_pack(u4: np.ndarray) -> np.ndarray:
    """Pack uint4 columns the AutoAWQ GEMM way: 8 per int32, interleaved."""
    r, c = u4.shape
    packed = np.zeros((r, c // 8), dtype=np.uint32)
    for pos, col in enumerate(t_loader.AWQ_NIBBLE_ORDER):
        packed |= u4[:, col::8].astype(np.uint32) << np.uint32(4 * pos)
    return packed.view(np.int32)


def test_awq_unpack_known_word():
    """Columns 0..7 holding 0..7 pack, in AutoAWQ's order (0,2,4,6,1,3,5,7),
    into nibbles (low to high) 0,2,4,6,1,3,5,7 = 0x75316420 (a hand-packed
    word, not a round trip through the same constant); 0xF5316420 has its sign
    bit set."""
    word = np.array([[0x75316420, 0xF5316420]], dtype=np.uint32).view(np.int32)
    got = t_loader._awq_unpack(word)
    want = np.concatenate([np.arange(8), [0, 1, 2, 3, 4, 5, 6, 15]]).astype(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want[None, :])
    np.testing.assert_array_equal(got.numpy(), j_loader._awq_unpack(word))


def test_awq_repack_roundtrip_matches_jax():
    """Synthetic AutoAWQ tensors repack losslessly: dequant equals the
    direct (q - z) * s within the bf16 rounding of the scales, and the
    repacked leaf is bit-identical to the JAX repacker's."""
    rng = np.random.default_rng(6)
    in_dim, out, group = 32, 16, 8
    q = rng.integers(0, 16, (in_dim, out)).astype(np.uint8)
    z = rng.integers(0, 16, (in_dim // group, out)).astype(np.uint8)
    s = rng.uniform(0.01, 0.03, (in_dim // group, out)).astype(np.float32)
    got = t_loader.awq_linear_to_quantized4(_awq_pack(q), _awq_pack(z), s)
    ref = (q.astype(np.float32) - np.repeat(z, group, 0)) * np.repeat(s, group, 0)
    np.testing.assert_allclose(tq.dequantize(got, torch.float32).numpy(), ref, atol=2e-3)
    _assert_same_leaf(got, j_loader.awq_linear_to_quantized4(_awq_pack(q), _awq_pack(z), s))


def _awq_state_dict(rng, hf_cfg, quantized_lm_head: bool) -> dict:
    d, inter, v = hf_cfg["hidden_size"], hf_cfg["intermediate_size"], hf_cfg["vocab_size"]
    kv = hf_cfg["num_key_value_heads"] * d // hf_cfg["num_attention_heads"]
    sd = {"model.embed_tokens.weight": rng.normal(0, 0.02, (v, d)).astype(np.float32),
          "model.norm.weight": rng.normal(1, 0.02, d).astype(np.float32)}

    def awq_linear(prefix, k, n):
        sd[prefix + ".qweight"] = _awq_pack(rng.integers(0, 16, (k, n)).astype(np.uint8))
        sd[prefix + ".qzeros"] = _awq_pack(rng.integers(0, 16, (k // G, n)).astype(np.uint8))
        sd[prefix + ".scales"] = rng.uniform(0.001, 0.003, (k // G, n)).astype(np.float16)

    for i in range(hf_cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[p + name + ".weight"] = rng.normal(1, 0.02, d).astype(np.float32)
        for proj, n in (("q_proj", d), ("k_proj", kv), ("v_proj", kv)):
            awq_linear(p + "self_attn." + proj, d, n)
            sd[p + "self_attn." + proj + ".bias"] = rng.normal(0, 0.02, n).astype(np.float32)
        awq_linear(p + "self_attn.o_proj", d, d)
        awq_linear(p + "mlp.gate_proj", d, inter)
        awq_linear(p + "mlp.up_proj", d, inter)
        awq_linear(p + "mlp.down_proj", inter, d)
    if quantized_lm_head:
        awq_linear("lm_head", d, v)
    else:
        sd["lm_head.weight"] = rng.normal(0, 0.02, (v, d)).astype(np.float16)
    return sd


@pytest.mark.parametrize("quantized_lm_head", [False, True])
def test_awq_params_from_state_dict_match_jax(quantized_lm_head):
    hf_cfg = {"vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
              "tie_word_embeddings": False,
              "quantization_config": {"quant_method": "awq", "bits": 4, "version": "gemm"}}
    sd = _awq_state_dict(np.random.default_rng(7), hf_cfg, quantized_lm_head)
    cfg = t_loader.config_from_hf(hf_cfg)
    jp = j_loader.awq_params_from_state_dict(sd, j_loader.config_from_hf(hf_cfg), hf_cfg)
    tp = t_loader.awq_params_from_state_dict(sd, cfg, hf_cfg, device="cpu")
    for name, leaf in jp["layers"].items():
        if isinstance(leaf, tuple):
            _assert_same_leaf(tp["layers"][name], leaf)
        else:
            np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(leaf))
    _assert_same_leaf(tp["embed"], jp["embed"])
    _assert_same_leaf(tp["lm_head"], jp["lm_head"])
    expect = "QuantizedLinear4" if quantized_lm_head else "QuantizedLinear"
    assert type(tp["lm_head"]).__name__ == expect
    logits, _ = forward(tp, cfg, torch.arange(6)[None], torch.arange(6)[None])
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError):
        t_loader.awq_params_from_state_dict(
            sd, cfg, {"quantization_config": {"bits": 8}}, device="cpu")


@pytest.fixture(scope="module")
def tiny_tree():
    jcfg = JConfig.tiny()
    rng = np.random.default_rng(2)
    jp = jax.tree.map(lambda x: x + jnp.asarray(rng.normal(size=x.shape) * 0.02, x.dtype),
                      j_init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, Qwen2Config.tiny(), jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_qwen2_params_and_params_from_jax(tiny_tree, bits):
    """Quantizing the same tree on both sides gives the same leaves, and
    params_from_jax carries a quantized JAX tree across unchanged: integer
    fields stay integer, bf16 scales keep their bits."""
    jcfg, cfg, jp = tiny_tree
    jq_tree = jq.quantize_qwen2_params(jp, bits=bits, group_size=G)
    tq_tree = tq.quantize_qwen2_params(params_from_jax(jp, cfg, device="cpu"), bits=bits,
                                       group_size=G)
    conv = params_from_jax(jq_tree, cfg, device="cpu")
    for t_tree in (tq_tree, conv):
        for name, leaf in jq_tree["layers"].items():
            if isinstance(leaf, tuple):
                _assert_same_leaf(t_tree["layers"][name], leaf)
        _assert_same_leaf(t_tree["embed"], jq_tree["embed"])
    assert conv["layers"]["wq"].q.dtype == (torch.uint8 if bits == 4 else torch.int8)
    assert conv["embed"].q.dtype == torch.int8 and conv["embed"].s.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tq.quantize_qwen2_params({"layers": {"ln1": torch.ones(2, 4)}}, bits=4)


def test_quantize_on_state_dict_path_matches_jax():
    rng = np.random.default_rng(3)
    d, inter, v, kv, L = 64, 128, 64, 32, 2  # group 64, the loader default
    hf_cfg = {"vocab_size": v, "hidden_size": d, "intermediate_size": inter,
              "num_hidden_layers": L, "num_attention_heads": 4, "num_key_value_heads": 2,
              "tie_word_embeddings": False}

    def normal(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": normal(v, d), "model.norm.weight": normal(d) + 1,
          "lm_head.weight": normal(v, d)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = normal(d) + 1
        sd[p + "post_attention_layernorm.weight"] = normal(d) + 1
        for proj, n in (("q_proj", d), ("k_proj", kv), ("v_proj", kv)):
            sd[p + "self_attn." + proj + ".weight"] = normal(n, d)
            sd[p + "self_attn." + proj + ".bias"] = normal(n)
        sd[p + "self_attn.o_proj.weight"] = normal(d, d)
        sd[p + "mlp.gate_proj.weight"] = normal(inter, d)
        sd[p + "mlp.up_proj.weight"] = normal(inter, d)
        sd[p + "mlp.down_proj.weight"] = normal(d, inter)
    cfg = t_loader.config_from_hf(hf_cfg)
    jp = jq.quantize_qwen2_params(
        j_loader.params_from_state_dict(sd, j_loader.config_from_hf(hf_cfg)), bits=4)
    tp = t_loader.params_from_state_dict(sd, cfg, device="cpu", quantize=4)
    for name, leaf in jp["layers"].items():
        if isinstance(leaf, tuple):
            _assert_same_leaf(tp["layers"][name], leaf)
    _assert_same_leaf(tp["lm_head"], jp["lm_head"])
    _assert_same_leaf(tp["embed"], jp["embed"])
    with pytest.raises(ValueError):
        t_loader.params_from_state_dict(sd, cfg, device="cpu", quantize=3)


def test_fuse_projections_of_int4_tree_is_a_relayout(tiny_tree, monkeypatch):
    _, cfg, jp = tiny_tree
    tree = tq.quantize_qwen2_params(params_from_jax(jp, cfg, device="cpu"), bits=4, group_size=G)
    fused = tq.fuse_projections(tree)
    assert "wq" in tree["layers"] and "wqkv" in fused["layers"]  # the default copies
    assert isinstance(fused["layers"]["wgu"], tq.QuantizedLinear4)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 7)))
    pos = torch.arange(7)[None].expand(2, 7)
    for w4a8 in ("0", "1"):
        monkeypatch.setenv("INT4_W4A8", w4a8)
        a, _ = forward(tree, cfg, ids, pos)
        b, _ = forward(fused, cfg, ids, pos)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)


def test_params_nbytes_int4_below_int8_and_init_params_quantized():
    cfg = dataclasses.replace(Qwen2Config.tiny(), tie_word_embeddings=False)
    gen = torch.Generator().manual_seed(0)
    p4 = tq.init_params_quantized(cfg, gen, device="cpu", bits=4, group_size=G)
    p8 = tq.init_params_quantized(cfg, gen, device="cpu", bits=8)
    assert tq.params_nbytes(p4) < tq.params_nbytes(p8)
    wq = p4["layers"]["wq"]
    assert wq.q.shape == (cfg.num_layers, cfg.hidden_size // 2, cfg.num_heads * cfg.head_dim)
    assert wq.s.shape == (cfg.num_layers, cfg.hidden_size // G, cfg.num_heads * cfg.head_dim)
    fused = tq.init_params_quantized(cfg, gen, device="cpu", bits=4, group_size=G, fuse=True)
    assert set(fused["layers"]) >= {"wqkv", "bqkv", "wgu"}
    assert tq.params_nbytes(fused) == tq.params_nbytes(p4)
    logits, _ = forward(fused, cfg, torch.arange(5)[None], torch.arange(5)[None])
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    # the JAX helper makes leaves of the same shapes and byte count
    jp = jq.init_params_quantized(dataclasses.replace(JConfig.tiny(), tie_word_embeddings=False),
                                  bits=4, group_size=G)
    assert tq.params_nbytes(p4) == jq.params_nbytes(jp)


def test_init_params_quantized_refuses_moe_as_jax():
    """The random quantized init is for dense benches; an MoE config raises
    on both sides, naming the loader that quantizes real MoE checkpoints."""
    with pytest.raises(NotImplementedError, match="load_qwen2"):
        tq.init_params_quantized(Qwen2Config.tiny_moe(), torch.Generator())
    with pytest.raises(NotImplementedError, match="load_qwen2"):
        jq.init_params_quantized(JConfig.tiny_moe())
