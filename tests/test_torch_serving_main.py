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
    impl = pytest.importorskip("tokenizers.implementations")
    root = tmp_path_factory.mktemp("ckpt")
    bpe = impl.ByteLevelBPETokenizer()
    bpe.train_from_iterator(CORPUS * 4, vocab_size=600, min_frequency=1,
                            special_tokens=SPECIALS)
    bpe.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": "<|im_end|>", "chat_template": CHAT_TEMPLATE}))
    vocab, h, inter, layers, heads, kv_heads, hd = 640, 64, 128, 2, 4, 2, 16
    g = torch.Generator().manual_seed(0)
    state = {"model.embed_tokens.weight": torch.randn(vocab, h, generator=g) * 0.05,
             "model.norm.weight": torch.ones(h)}
    for i in range(layers):
        p = f"model.layers.{i}"
        for name, shape in (("self_attn.q_proj.weight", (heads * hd, h)),
                            ("self_attn.k_proj.weight", (kv_heads * hd, h)),
                            ("self_attn.v_proj.weight", (kv_heads * hd, h)),
                            ("self_attn.o_proj.weight", (h, heads * hd)),
                            ("mlp.gate_proj.weight", (inter, h)), ("mlp.up_proj.weight", (inter, h)),
                            ("mlp.down_proj.weight", (h, inter)),
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
        "tie_word_embeddings": True, "max_position_embeddings": 512}))
    return root


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_serves_a_chat_from_a_checkpoint(checkpoint):
    _serve_a_chat(checkpoint, {})


def test_server_serves_a_chat_in_the_speculative_and_host_tier_modes(checkpoint):
    """The same server with the fused step (n-gram speculation, its burst,
    a token budget), the host KV tier and preemption on, from the
    settings alone."""
    _serve_a_chat(checkpoint, MODE_ENVS["fused"] | MODE_ENVS["preempt"])


def _serve_a_chat(checkpoint, extra: dict) -> None:
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
        body = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 6,
                "temperature": 0}
        req = urllib.request.Request(f"{base}/v1/chat/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read())
        assert reply["model"] == "tiny-ckpt"
        assert isinstance(reply["choices"][0]["message"]["content"], str)
        assert 1 <= reply["usage"]["completion_tokens"] <= 6
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "NativeBPETokenizer" in out and "model server stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("env,message", [
    ({}, "requires MODEL_WEIGHTS_PATH"),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "MESH_SHAPE": "tp:2"},
     "MESH_SHAPE is set.*queue 1 item 8 "),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "SPEC_DRAFT_MODEL": "/draft"},
     "SPEC_DRAFT_MODEL is set.*queue 1 item 5 "),
    ({"MODEL_WEIGHTS_PATH": "/nonexistent", "CTRL": "on"}, "CTRL is set.*queue 1 item 7 "),
])
def test_main_refuses_what_it_cannot_serve(monkeypatch, env, message):
    for name in ("MODEL_WEIGHTS_PATH", "MESH_SHAPE", "SPEC_DRAFT_MODEL", "CTRL"):
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
