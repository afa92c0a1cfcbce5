"""The port's checkpoint loading against the JAX package's.

``models/safetensors_io`` against the ``safetensors`` package in both
directions, for every dtype Qwen2 and AutoAWQ checkpoints use, and its
refusal of malformed files; ``load_qwen2`` on tiny checkpoints written here
(a dense one in two shards, one written by each writer, and an AutoAWQ
one, and a Qwen2-MoE one) against ``params_from_jax`` of the JAX package's
``load_qwen2``, for ``quantize`` False, 8 and 4 and ``fuse`` True and
False: the trees must be equal, bit for bit."""

from __future__ import annotations

import dataclasses
import json
import logging
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from githubrepostorag_tpu.models.hf_loader import load_qwen2 as j_load_qwen2
from githubrepostorag_tpu_torch.models.convert import params_from_jax
from githubrepostorag_tpu_torch.models.hf_loader import AWQ_NIBBLE_ORDER, load_qwen2
from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config
from githubrepostorag_tpu_torch.models.safetensors_io import load_file, save_file

safetensors_torch = pytest.importorskip("safetensors.torch")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.int8, torch.uint8]


def _tensors(seed: int) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dtype in enumerate(DTYPES):
        shape = [(3, 5), (7,), (2, 1, 4), (0, 3), ()][i % 5]
        if dtype.is_floating_point:
            out[f"t{i}.{str(dtype)[6:]}"] = torch.randn(shape, generator=g).to(dtype)
        else:
            out[f"t{i}.{str(dtype)[6:]}"] = torch.randint(-100 if dtype.is_signed else 0, 100,
                                                         shape, generator=g, dtype=dtype)
    return out


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_writer_read_by_the_package(tmp_path):
    ts = _tensors(0)
    save_file(ts, tmp_path / "a.safetensors", metadata={"format": "pt", "note": "x"})
    _assert_same(safetensors_torch.load_file(str(tmp_path / "a.safetensors")), ts)
    from safetensors import safe_open

    with safe_open(str(tmp_path / "a.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt", "note": "x"}


def test_reader_reads_the_package(tmp_path):
    ts = _tensors(1)
    safetensors_torch.save_file(ts, str(tmp_path / "b.safetensors"), metadata={"format": "pt"})
    got = load_file(tmp_path / "b.safetensors")
    _assert_same(got, ts)
    _assert_same(load_file(tmp_path / "b.safetensors", device="cpu"), ts)
    # views of the file's private mapping: writing one leaves the file as it was
    got["t0.float32"].fill_(7.0)
    _assert_same(load_file(tmp_path / "b.safetensors"), ts)


def _raw(header: dict | bytes, data: bytes = b"", length: int | None = None) -> bytes:
    raw = header if isinstance(header, bytes) else json.dumps(header).encode()
    return struct.pack("<Q", len(raw) if length is None else length) + raw + data


@pytest.mark.parametrize("name,content", [
    ("empty", b""),
    ("short", b"\x01\x02"),
    ("header_past_the_end", _raw({}, length=1 << 20)),
    ("not_json", _raw(b"{not json")),
    ("not_an_object", _raw(b"[1, 2]")),
    ("unknown_dtype", _raw({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}},
                           b"\0\0")),
    ("size_mismatch", _raw({"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 4]}},
                           b"\0" * 4)),
    ("gap", _raw({"x": {"dtype": "U8", "shape": [2], "data_offsets": [2, 4]}}, b"\0" * 4)),
    ("trailing_bytes", _raw({"x": {"dtype": "U8", "shape": [2], "data_offsets": [0, 2]}},
                            b"\0" * 3)),
    ("missing_key", _raw({"x": {"dtype": "U8", "shape": [2]}}, b"\0\0")),
])
def test_malformed_files_raise(tmp_path, name, content):
    path = tmp_path / f"{name}.safetensors"
    path.write_bytes(content)
    with pytest.raises(ValueError):
        load_file(path)


# ---- load_qwen2 ----------------------------------------------------------

def _config_json(cfg: Qwen2Config, **extra) -> str:
    return json.dumps({
        "model_type": "qwen2", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta, "rms_norm_eps": 1e-6,
        "max_position_embeddings": cfg.max_position_embeddings, **extra})


@pytest.fixture(scope="module")
def dense_checkpoint(tmp_path_factory):
    """A tiny dense Qwen2 checkpoint in HF layout, float32, untied lm_head:
    its layers in a shard written by the safetensors package, embedding,
    norm and lm_head in one written by the port."""
    cfg = Qwen2Config.tiny()
    rng = np.random.default_rng(5)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    q_out, kv_out = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layers = {}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        for name, shape in (("self_attn.q_proj.weight", (q_out, h)),
                            ("self_attn.k_proj.weight", (kv_out, h)),
                            ("self_attn.v_proj.weight", (kv_out, h)),
                            ("self_attn.o_proj.weight", (h, q_out)),
                            ("mlp.gate_proj.weight", (inter, h)), ("mlp.up_proj.weight", (inter, h)),
                            ("mlp.down_proj.weight", (h, inter)),
                            ("self_attn.q_proj.bias", (q_out,)), ("self_attn.k_proj.bias", (kv_out,)),
                            ("self_attn.v_proj.bias", (kv_out,)),
                            ("input_layernorm.weight", (h,)), ("post_attention_layernorm.weight", (h,))):
            layers[f"{p}.{name}"] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    root = tmp_path_factory.mktemp("dense")
    safetensors_numpy.save_file(layers, str(root / "model-00001-of-00002.safetensors"))
    save_file({"model.embed_tokens.weight": torch.randn(cfg.vocab_size, h) * 0.05,
               "model.norm.weight": torch.rand(h) + 0.5,
               "lm_head.weight": torch.randn(cfg.vocab_size, h) * 0.05},
              root / "model-00002-of-00002.safetensors")
    (root / "config.json").write_text(_config_json(cfg, tie_word_embeddings=False))
    return root


def _assert_tree_equal(port, ref, where="params"):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), where
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, tuple):
        assert type(port).__name__ == type(ref).__name__, where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_tree_equal(a, b, f"{where}[{i}]")
    else:
        assert port.dtype == ref.dtype and port.shape == ref.shape, where
        assert torch.equal(port, ref), where


@pytest.mark.parametrize("quantize,fuse,dtype", [
    (False, False, torch.float32), (False, True, torch.float32), (False, True, torch.bfloat16),
    (8, False, torch.float32), (8, True, torch.float32), (4, False, torch.float32),
    (4, True, torch.float32),
])
def test_load_qwen2_matches_jax(dense_checkpoint, quantize, fuse, dtype):
    np_dtype = np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16
    jp, jcfg = j_load_qwen2(str(dense_checkpoint), dtype=np_dtype, quantize=quantize, fuse=fuse)
    params, cfg = load_qwen2(dense_checkpoint, dtype=dtype, quantize=quantize, fuse=fuse,
                             device="cpu")
    assert cfg == Qwen2Config(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    _assert_tree_equal(params, params_from_jax(jp, cfg, device="cpu"))
    assert ("wqkv" in params["layers"]) == fuse


def _write_awq_checkpoint(root) -> None:
    """A tiny AutoAWQ-layout checkpoint: config.json with
    quantization_config.quant_method awq, and projections as GEMM-packed
    qweight / qzeros / scales (the layout of tests/test_openai_server.py's
    fixture)."""
    rng = np.random.default_rng(3)
    group = 16

    def awq_pack(u4: np.ndarray) -> np.ndarray:
        r, c = u4.shape
        out = np.zeros((r, c // 8), dtype=np.uint32)
        for pos, col in enumerate(AWQ_NIBBLE_ORDER):
            out |= u4[:, col::8].astype(np.uint32) << np.uint32(4 * pos)
        return out.view(np.int32)

    def awq_linear(in_dim: int, out_dim: int) -> dict[str, np.ndarray]:
        q = rng.integers(0, 16, (in_dim, out_dim), dtype=np.uint8)
        z = rng.integers(0, 16, (in_dim // group, out_dim), dtype=np.uint8)
        s = (rng.random((in_dim // group, out_dim), dtype=np.float32) * 0.05
             + 0.005).astype(np.float16)
        return {"qweight": awq_pack(q), "qzeros": awq_pack(z), "scales": s}

    cfg = Qwen2Config.tiny()
    h, q_out = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv_out, inter = cfg.num_kv_heads * cfg.head_dim, cfg.intermediate_size
    state = {
        "model.embed_tokens.weight":
            (rng.standard_normal((cfg.vocab_size, h)) * 0.02).astype(np.float16),
        "model.norm.weight": np.ones(h, dtype=np.float16),
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        state[f"{p}.input_layernorm.weight"] = np.ones(h, dtype=np.float16)
        state[f"{p}.post_attention_layernorm.weight"] = np.ones(h, dtype=np.float16)
        for name, dims in (("self_attn.q_proj", (h, q_out)), ("self_attn.k_proj", (h, kv_out)),
                           ("self_attn.v_proj", (h, kv_out)), ("self_attn.o_proj", (q_out, h)),
                           ("mlp.gate_proj", (h, inter)), ("mlp.up_proj", (h, inter)),
                           ("mlp.down_proj", (inter, h))):
            for suffix, tensor in awq_linear(*dims).items():
                state[f"{p}.{name}.{suffix}"] = tensor
        for bname, dim in (("q_proj", q_out), ("k_proj", kv_out), ("v_proj", kv_out)):
            state[f"{p}.self_attn.{bname}.bias"] = (
                rng.standard_normal(dim) * 0.01).astype(np.float16)
    safetensors_numpy.save_file(state, str(root / "model.safetensors"))
    (root / "config.json").write_text(_config_json(
        cfg, tie_word_embeddings=True, torch_dtype="float16",
        quantization_config={"quant_method": "awq", "bits": 4, "version": "gemm",
                             "group_size": group, "zero_point": True}))


@pytest.mark.parametrize("quantize", [False, 8])
def test_load_qwen2_awq_matches_jax(tmp_path, caplog, quantize):
    _write_awq_checkpoint(tmp_path)
    jp, _ = j_load_qwen2(str(tmp_path), dtype=np.float32, fuse=True)
    with caplog.at_level(logging.WARNING, logger="githubrepostorag_tpu_torch.models.hf_loader"):
        params, cfg = load_qwen2(tmp_path, dtype=torch.float32, quantize=quantize, fuse=True,
                                 device="cpu")
    assert type(params["layers"]["wgu"]).__name__ == "QuantizedLinear4"
    _assert_tree_equal(params, params_from_jax(jp, cfg, device="cpu"))
    assert ("ignoring the int8 quantize request" in caplog.text) == (quantize == 8)


@pytest.fixture(scope="module")
def moe_checkpoint(tmp_path_factory):
    """A tiny Qwen2-MoE checkpoint in HF layout (``Qwen2MoeForCausalLM``'s
    names), float32, untied lm_head, 4 experts top-2 of width 64 (so the
    int4 loader's group 64 divides every input dimension)."""
    cfg = dataclasses.replace(Qwen2Config.tiny_moe(), moe_intermediate_size=64,
                              shared_expert_intermediate_size=128, tie_word_embeddings=False)
    rng = np.random.default_rng(6)
    h, e_ff, s_ff = cfg.hidden_size, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
    q_out, kv_out = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h), "model.norm.weight": (h,),
              "lm_head.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "self_attn.q_proj.weight": (q_out, h), p + "self_attn.q_proj.bias": (q_out,),
            p + "self_attn.k_proj.weight": (kv_out, h), p + "self_attn.k_proj.bias": (kv_out,),
            p + "self_attn.v_proj.weight": (kv_out, h), p + "self_attn.v_proj.bias": (kv_out,),
            p + "self_attn.o_proj.weight": (h, q_out), p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,), p + "mlp.gate.weight": (4, h),
            p + "mlp.shared_expert.gate_proj.weight": (s_ff, h),
            p + "mlp.shared_expert.up_proj.weight": (s_ff, h),
            p + "mlp.shared_expert.down_proj.weight": (h, s_ff),
            p + "mlp.shared_expert_gate.weight": (1, h)})
        for e in range(cfg.num_experts):
            shapes.update({p + f"mlp.experts.{e}.gate_proj.weight": (e_ff, h),
                           p + f"mlp.experts.{e}.up_proj.weight": (e_ff, h),
                           p + f"mlp.experts.{e}.down_proj.weight": (h, e_ff)})
    tensors = {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    root = tmp_path_factory.mktemp("moe")
    save_file({k: torch.from_numpy(v) for k, v in tensors.items()}, root / "model.safetensors")
    (root / "config.json").write_text(_config_json(
        cfg, model_type="qwen2_moe", tie_word_embeddings=False, num_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=e_ff, shared_expert_intermediate_size=s_ff,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[]))
    return root


@pytest.mark.parametrize("quantize", [False, 8, 4])
def test_load_qwen2_moe_matches_jax(moe_checkpoint, quantize):
    """A Qwen2-MoE checkpoint loads as JAX's does, bit for bit: experts
    stacked [L, E, in, out] (quantized per expert), the router and shared
    gate full precision, the capacity factor from the caller."""
    jp, jcfg = j_load_qwen2(str(moe_checkpoint), dtype=np.float32, quantize=quantize,
                            moe_capacity_factor=1.5, fuse=True)
    params, cfg = load_qwen2(moe_checkpoint, dtype=torch.float32, quantize=quantize, fuse=True,
                             device="cpu", moe_capacity_factor=1.5)
    assert cfg == Qwen2Config(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    assert cfg.num_experts == 4 and cfg.capacity_factor == 1.5
    _assert_tree_equal(params, params_from_jax(jp, cfg, device="cpu"))
    assert "wgu" not in params["layers"] and "wqkv" in params["layers"]
    assert isinstance(params["layers"]["e_wg"], tuple) == bool(quantize)
    assert not isinstance(params["layers"]["router"], tuple)


def test_awq_moe_checkpoint_refused_as_jax(moe_checkpoint, tmp_path):
    """AWQ repacking covers dense checkpoints only, on both sides."""
    import shutil

    shutil.copy(moe_checkpoint / "model.safetensors", tmp_path / "model.safetensors")
    hf = json.loads((moe_checkpoint / "config.json").read_text())
    hf["quantization_config"] = {"quant_method": "awq", "bits": 4, "version": "gemm"}
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(NotImplementedError, match="AWQ MoE"):
        load_qwen2(tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="AWQ MoE"):
        j_load_qwen2(str(tmp_path))
