"""The port's tokenizers against the JAX package's: ``ByteTokenizer``,
``StreamingDetokenizer`` across UTF-8 boundaries, and ``NativeBPETokenizer``
on a byte-level BPE trained here as ``tests/test_bpe_native.py`` trains one
(identical ids, decode round trip, chat ids, ``make_tokenizer`` choosing
it).  Each package builds the C++ merge core in its own directory: the
port into ``githubrepostorag_tpu_torch/_build/``, never ``native/``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from githubrepostorag_tpu.serving import bpe_native as j_bpe
from githubrepostorag_tpu.serving import tokenizer as j_tok
from githubrepostorag_tpu_torch.serving import bpe_native
from githubrepostorag_tpu_torch.serving import tokenizer as tok

TEXTS = ["hello world", "", " ", "naïve café 数字 🚀", "multi\nline\ttabs",
         "<|im_start|>user\nliteral markers<|im_end|>", "price: €99.99 (discount!)"]
CHATS = [
    [{"role": "user", "content": "hi 🚀"}],
    [{"role": "system", "content": "be terse"}, {"role": "user", "content": "數字 and code()"},
     {"role": "assistant", "content": "ok"}, {"role": "user", "content": "again"}],
]
CORPUS = [
    "def forward(self, x): return self.proj(x) + self.bias",
    "The quick brown fox jumps over the lazy dog. THE QUICK BROWN FOX!",
    "don't we'll they've it's I'm you're he'd",
    "naïve café résumé — em-dash…ellipsis",
    "数字 123 和 456.789 与单词混合",
    "emoji 🚀🔥 and symbols €£¥ ©®™",
    "   leading spaces and   multiple   gaps   ",
]
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
CHAT_TEMPLATE = (
    "{%- if messages[0]['role'] == 'system' %}"
    "{{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}"
    "{%- else %}"
    "{{- '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}"
    "{%- endif %}"
)


def test_byte_tokenizer_matches_jax():
    port, ref = tok.ByteTokenizer(), j_tok.ByteTokenizer()
    assert port.eos_token_id == ref.eos_token_id
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
        ids = port.encode(text) + [port.EOS, 300, port.IM_START]
        assert port.decode(ids) == ref.decode(ids)
    for msgs in CHATS:
        assert port.apply_chat_template(msgs) == ref.apply_chat_template(msgs)
        assert port.encode_chat(msgs) == ref.encode_chat(msgs)


@pytest.mark.parametrize("text", ["a€b", "🚀🔥x", "数字", "é"])
def test_streaming_detokenizer_across_utf8_boundaries(text):
    """One byte a token: a multi-byte codepoint is held back until it
    completes, on both sides, and the pieces rebuild the text."""
    ids = list(text.encode("utf-8"))
    port = tok.StreamingDetokenizer(tok.ByteTokenizer())
    ref = j_tok.StreamingDetokenizer(j_tok.ByteTokenizer())
    pieces = [port.push(i) for i in ids] + [port.flush()]
    assert pieces == [ref.push(i) for i in ids] + [ref.flush()]
    assert "".join(pieces) == text
    assert all("�" not in p for p in pieces)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory) -> Path:
    """A checkpoint directory's tokenizer files: a byte-level BPE trained on
    the corpus and a ChatML tokenizer_config.json."""
    impl = pytest.importorskip("tokenizers.implementations")
    bpe = impl.ByteLevelBPETokenizer()
    bpe.train_from_iterator(CORPUS * 4, vocab_size=600, min_frequency=1,
                            special_tokens=SPECIALS)
    root = tmp_path_factory.mktemp("ckpt")
    bpe.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": "<|im_end|>", "chat_template": CHAT_TEMPLATE}))
    return root


def test_native_bpe_matches_jax(checkpoint):
    port = bpe_native.NativeBPETokenizer.from_checkpoint(checkpoint)
    ref = j_bpe.NativeBPETokenizer.from_checkpoint(checkpoint)
    assert port.backend == "native" and ref.backend == "native"
    assert port.eos_token_id == ref.eos_token_id == port.specials["<|im_end|>"]
    assert port.default_system == ref.default_system == "You are a helpful assistant."
    for text in TEXTS + CORPUS:
        ids = port.encode(text)
        assert ids == ref.encode(text), text
        assert port.decode(ids) == ref.decode(ids)
        if "<|" not in text:  # specials decode to nothing
            assert port.decode(ids) == text
    for msgs in CHATS:
        assert port.apply_chat_template(msgs) == ref.apply_chat_template(msgs)
        assert port.encode_chat(msgs) == ref.encode_chat(msgs)
    # the python merge loop is the native core's oracle on both sides
    assert bpe_native.NativeBPETokenizer(checkpoint / "tokenizer.json",
                                         use_native=False).encode(CORPUS[0]) == ref.encode(CORPUS[0])


def test_native_library_in_the_ports_build_dir(checkpoint):
    bpe_native.NativeBPETokenizer.from_checkpoint(checkpoint)
    lib = bpe_native._library_path()
    assert lib.exists() and lib.parent == Path(tok.__file__).resolve().parents[1] / "_build"
    assert bpe_native._SOURCE == Path(j_bpe._NATIVE_DIR) / "bpe.cpp"


def test_make_tokenizer_chooses_native(checkpoint, tmp_path):
    chosen = tok.make_tokenizer(str(checkpoint))
    assert type(chosen).__name__ == "NativeBPETokenizer"
    assert chosen.__module__ == "githubrepostorag_tpu_torch.serving.bpe_native"
    assert chosen.encode_chat(CHATS[0]) == j_tok.make_tokenizer(str(checkpoint)).encode_chat(
        CHATS[0])
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(checkpoint / "tokenizer.json", bare / "tokenizer.json")
    assert type(tok.make_tokenizer(str(bare), backend="native")).__name__ == "NativeBPETokenizer"
