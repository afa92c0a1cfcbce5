"""The port's model-server entry point end to end on the CPU: ``python -m
githubrepostorag_tpu_torch.serving --device cpu`` in a subprocess, over a
tiny checkpoint directory (random Qwen2 weights in safetensors, the byte-level
BPE ``tokenizer.json`` and a ChatML ``tokenizer_config.json`` built as
``tests/test_bpe_native.py`` builds them): /health comes up, a chat is
answered, SIGTERM stops it cleanly, on the defaults and with the
speculative and host-tier modes on.  ``build_engine`` runs each mode from
its settings.  And ``main`` refuses what it cannot serve, naming the
roadmap item that brings it."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from githubrepostorag_tpu_torch import config
from githubrepostorag_tpu_torch.models.safetensors_io import save_file
from githubrepostorag_tpu_torch.serving.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
CORPUS = ["def forward(self, x): return self.proj(x) + self.bias",
          "The quick brown fox jumps over the lazy dog.", "don't we'll they've it's I'm",
          "naïve café résumé — em-dash", "数字 123 和 456.789", "emoji 🚀🔥 and symbols €£¥"]
CHAT_TEMPLATE = "{{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}"
SERVER_ENV = {"CONTEXT_WINDOW": "256", "MAX_NUM_SEQS": "2", "KV_PAGE_SIZE": "8",
              "KV_NUM_PAGES": "64", "PREFILL_CHUNK": "32", "QWEN_MODEL": "tiny-ckpt"}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory) -> Path:
    return _write_checkpoint(tmp_path_factory.mktemp("ckpt"), seed=0)


@pytest.fixture(scope="module")
def draft_checkpoint(tmp_path_factory) -> Path:
    """A second model sharing the tokenizer: one layer, other weights."""
    return _write_checkpoint(tmp_path_factory.mktemp("draft"), seed=1, layers=1)


def _write_checkpoint(root: Path, seed: int, layers: int = 2, experts: int = 0) -> Path:
    """A tiny checkpoint with a trained byte-level BPE tokenizer: a dense
    Qwen2, or with ``experts`` a Qwen2-MoE (top-2 of ``experts`` of width
    64, a shared expert of 128)."""
    impl = pytest.importorskip("tokenizers.implementations")
    bpe = impl.ByteLevelBPETokenizer()
    bpe.train_from_iterator(CORPUS * 4, vocab_size=600, min_frequency=1,
                            special_tokens=SPECIALS)
    bpe.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": "<|im_end|>", "chat_template": CHAT_TEMPLATE}))
    vocab, h, inter, heads, kv_heads, hd = 640, 64, 128, 4, 2, 16
    g = torch.Generator().manual_seed(seed)
    state = {"model.embed_tokens.weight": torch.randn(vocab, h, generator=g) * 0.05,
             "model.norm.weight": torch.ones(h)}
    for i in range(layers):
        p = f"model.layers.{i}"
        mlp = ((("mlp.gate.weight", (experts, h)), ("mlp.shared_expert_gate.weight", (1, h)))
               + tuple((f"mlp.{part}.{name}.weight", shape)
                       for part, width in [("shared_expert", 128)]
                       + [(f"experts.{e}", 64) for e in range(experts)]
                       for name, shape in (("gate_proj", (width, h)), ("up_proj", (width, h)),
                                           ("down_proj", (h, width))))
               if experts else
               (("mlp.gate_proj.weight", (inter, h)), ("mlp.up_proj.weight", (inter, h)),
                ("mlp.down_proj.weight", (h, inter))))
        for name, shape in (("self_attn.q_proj.weight", (heads * hd, h)),
                            ("self_attn.k_proj.weight", (kv_heads * hd, h)),
                            ("self_attn.v_proj.weight", (kv_heads * hd, h)),
                            ("self_attn.o_proj.weight", (h, heads * hd)),
                            *mlp,
                            ("self_attn.q_proj.bias", (heads * hd,)),
                            ("self_attn.k_proj.bias", (kv_heads * hd,)),
                            ("self_attn.v_proj.bias", (kv_heads * hd,))):
            state[f"{p}.{name}"] = torch.randn(shape, generator=g) * 0.05
        state[f"{p}.input_layernorm.weight"] = torch.ones(h)
        state[f"{p}.post_attention_layernorm.weight"] = torch.ones(h)
    save_file(state, root / "model.safetensors")
    (root / "config.json").write_text(json.dumps({
        "model_type": "qwen2", "vocab_size": vocab, "hidden_size": h, "intermediate_size": inter,
        "num_hidden_layers": layers, "num_attention_heads": heads,
        "num_key_value_heads": kv_heads, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True, "max_position_embeddings": 512,
        **({"model_type": "qwen2_moe", "num_experts": experts, "num_experts_per_tok": 2,
            "moe_intermediate_size": 64, "shared_expert_intermediate_size": 128,
            "norm_topk_prob": False} if experts else {})}))
    return root


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_serves_a_chat_from_a_checkpoint(checkpoint):
    _serve_a_chat(checkpoint, {})


def test_server_serves_a_chat_from_an_moe_checkpoint(tmp_path):
    """A Qwen2-MoE checkpoint loads and serves through the same entry
    point, its expert capacity from MOE_CAPACITY_FACTOR and its drops
    counted under MOE_DROP_STATS."""
    moe_ckpt = _write_checkpoint(tmp_path, seed=2, experts=4)
    _serve_a_chat(moe_ckpt, {"MOE_CAPACITY_FACTOR": "1.0", "MOE_DROP_STATS": "1"})


def test_server_serves_a_chat_in_the_speculative_and_host_tier_modes(checkpoint):
    """The same server with the fused step (n-gram speculation, its burst,
    a token budget), the host KV tier and preemption on, from the
    settings alone."""
    _serve_a_chat(checkpoint, MODE_ENVS["fused"] | MODE_ENVS["preempt"])


def test_server_serves_a_chat_with_a_draft_model(checkpoint, draft_checkpoint):
    """SPEC_DRAFT_MODEL: the server loads the draft, speculates (drafts
    proposed, in /health) and answers with the JAX engine's greedy tokens
    for the same checkpoints, draft and prompt (bf16 weights on both
    sides, as both servers load them)."""
    import ml_dtypes
    import jax.numpy as jnp

    from githubrepostorag_tpu.models.hf_loader import load_qwen2 as j_load
    from githubrepostorag_tpu.serving import Engine as JEngine, SamplingParams as JSamplingParams
    from githubrepostorag_tpu_torch.serving.tokenizer import make_tokenizer

    messages = [{"role": "user", "content": "hello world"}]
    reply, health = _serve_a_chat(checkpoint, {"SPEC_DRAFT_MODEL": str(draft_checkpoint),
                                               "SPEC_K": "2", "SPEC_ITERS": "2"},
                                  messages=messages, max_tokens=8)
    assert health["spec_proposed"] > 0
    tok = make_tokenizer(str(checkpoint))
    params, cfg = j_load(str(checkpoint), dtype=ml_dtypes.bfloat16, fuse=True)
    dparams, dcfg = j_load(str(draft_checkpoint), dtype=ml_dtypes.bfloat16)
    eng = JEngine(params, cfg, max_num_seqs=2, num_pages=64, page_size=8, max_seq_len=256,
                  prefill_chunk=32, kv_dtype=jnp.bfloat16, draft_params=dparams,
                  draft_cfg=dcfg, spec_k=2, spec_iters=2)
    eng.warmup()  # as the server does: its waves speculate too
    out = eng.generate([tok.encode_chat(messages)], JSamplingParams(
        max_tokens=8, temperature=0.0, stop_token_ids=(tok.eos_token_id,)))[0]
    ids = [t for t in out.output_tokens if t != tok.eos_token_id]
    assert reply["usage"]["completion_tokens"] == len(out.output_tokens)
    assert reply["choices"][0]["message"]["content"] == tok.decode(ids)
    assert eng.spec_proposed == health["spec_proposed"]


def _serve_a_chat(checkpoint, extra: dict, messages=None, max_tokens: int = 6):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MESH_SHAPE", "SPEC_DRAFT_MODEL")}
    env.update(SERVER_ENV, MODEL_WEIGHTS_PATH=str(checkpoint), CTRL="off", **extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "githubrepostorag_tpu_torch.serving", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                with urllib.request.urlopen(f"{base}/health", timeout=5) as resp:
                    health = json.loads(resp.read())
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.2)
        assert health["status"] == "ok" and health["free_pages"] == health["total_pages"] == 64
        body = {"messages": messages or [{"role": "user", "content": "hello world"}],
                "max_tokens": max_tokens, "temperature": 0}
        req = urllib.request.Request(f"{base}/v1/chat/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read())
        assert reply["model"] == "tiny-ckpt"
        assert isinstance(reply["choices"][0]["message"]["content"], str)
        assert 1 <= reply["usage"]["completion_tokens"] <= max_tokens
        with urllib.request.urlopen(f"{base}/health", timeout=5) as resp:
            health = json.loads(resp.read())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "NativeBPETokenizer" in out and "model server stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return reply, health


@pytest.mark.parametrize("env,message", [
    ({}, "requires MODEL_WEIGHTS_PATH"),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "MESH_SHAPE": "tp:2"},
     "MESH_SHAPE='tp:2' needs 2 ranks, the world has 1"),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "SPEC_DRAFT_MODEL": "/draft", "SPEC_NGRAM_K": "4"},
     "SPEC_DRAFT_MODEL and SPEC_NGRAM_K are mutually exclusive"),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "MESH_SHAPE": "dp:2,sp:2"},
     "dp replicas of a tp / sp / ep mesh are ROADMAP.md queue 1 item 8.6"),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "MESH_SHAPE": "dp:two"}, "bad MESH_SHAPE entry"),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "MESH_SHAPE": "dp:2,dp:3"},
     "axis 'dp' given twice"),
])
def test_main_refuses_what_it_cannot_serve(monkeypatch, env, message):
    for name in ("MODEL_WEIGHTS_PATH", "MESH_SHAPE", "SPEC_DRAFT_MODEL", "SPEC_NGRAM_K", "CTRL"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    config.reload_settings()
    try:
        with pytest.raises(SystemExit, match=message) as exc:
            main(["--device", "cpu", "--port", "0"])
        assert exc.value.code not in (0, None)
    finally:
        monkeypatch.undo()
        config.reload_settings()


MODE_ENVS = {
    "spec": {"SPEC_NGRAM_K": "4"},
    "burst": {"SPEC_NGRAM_K": "4", "SPEC_BURST_ITERS": "4"},
    "fused": {"SPEC_NGRAM_K": "4", "SPEC_BURST_ITERS": "4", "FUSED_STEP": "1",
              "PREFILL_TOKEN_BUDGET": "64"},
    "tier": {"KV_TIER": "on", "KV_HOST_POOL_PAGES": "32", "KV_MIGRATE_BURST": "4"},
    "preempt": {"KV_TIER": "on", "KV_HOST_POOL_PAGES": "32", "PREEMPT": "on",
                "PREEMPT_HEADROOM_PAGES": "2", "PRIORITY_PROTECTED_CLASS": "interactive"},
}


@pytest.mark.parametrize("mode", sorted(MODE_ENVS))
def test_build_engine_runs_each_mode_from_its_settings(monkeypatch, mode):
    """``build_engine`` turns each mode's settings into an engine running
    that mode, whose greedy tokens equal the default settings' engine's."""
    from githubrepostorag_tpu_torch.models.qwen2 import Qwen2Config, init_params
    from githubrepostorag_tpu_torch.serving import SamplingParams
    from githubrepostorag_tpu_torch.serving.__main__ import build_engine

    cfg = Qwen2Config.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    prompts = [[5, 6, 7, 8, 5, 6, 7, 8, 5, 6], [9, 10, 11]]
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    engines = {}
    for name, env in (("default", {}), (mode, MODE_ENVS[mode])):
        for key in {k for e in MODE_ENVS.values() for k in e}:
            monkeypatch.delenv(key, raising=False)
        for key, value in {**SERVER_ENV, **env}.items():
            monkeypatch.setenv(key, value)
        engines[name] = build_engine(config.reload_settings(), params, cfg, "cpu")
    monkeypatch.undo()
    config.reload_settings()
    eng = engines[mode]
    flags = {"spec": eng.spec_ngram_k == 4, "burst": eng.spec_burst_iters == 4,
             "fused": eng.fused_step_on and eng.prefill_token_budget == 64,
             "tier": eng._kv_tier_on and eng.kv_migrate_burst == 4,
             "preempt": eng._preempt_on and eng.preempt_headroom_pages == 2}
    assert flags[mode]
    assert not (engines["default"].spec_ngram_k or engines["default"]._kv_tier_on)
    assert ([r.output_tokens for r in eng.generate(prompts, sp)]
            == [r.output_tokens for r in engines["default"].generate(prompts, sp)])
