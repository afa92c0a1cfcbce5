"""The port's model-server entry point end to end on the CPU: ``python -m
githubrepostorag_tpu_torch.serving --device cpu`` in a subprocess, over a
tiny checkpoint directory (random Qwen2 weights in safetensors, the byte-level
BPE ``tokenizer.json`` and a ChatML ``tokenizer_config.json`` built as
``tests/test_bpe_native.py`` builds them): /health comes up, a chat is
answered, SIGTERM stops it cleanly.  And ``main`` refuses what it cannot
serve, naming the roadmap item that brings it."""

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
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("MESH_SHAPE", "SPEC_DRAFT_MODEL")}
    env.update(SERVER_ENV, MODEL_WEIGHTS_PATH=str(checkpoint), CTRL="off")
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
