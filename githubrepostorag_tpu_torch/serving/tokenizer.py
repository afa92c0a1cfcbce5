"""Tokenizer abstraction for the serving stack; port of
``githubrepostorag_tpu/serving/tokenizer.py``, behavior unchanged.

Two implementations:
  - ``HFTokenizer`` — a local HuggingFace tokenizer directory (Qwen2's BPE
    in real deployments; zero-egress images must have it on disk).
  - ``ByteTokenizer`` — dependency-free UTF-8 byte tokenizer with a
    ChatML-style template, ids 0..255 = bytes, 256+ = specials.  Lets the
    whole serving stack (chat template -> engine -> streaming detokenize)
    run against tiny random models in tests and dev.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    eos_token_id: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        """messages [{role, content}] -> prompt string."""
        ...


class ByteTokenizer:
    """UTF-8 bytes + specials.  Vocab: 0..255 bytes, 256 BOS, 257 EOS,
    258 im_start, 259 im_end — fits the tiny test models' vocab of 512."""

    BOS = 256
    EOS = 257
    IM_START = 258
    IM_END = 259
    vocab_size = 260

    def __init__(self) -> None:
        self.eos_token_id = self.EOS

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        # mirrors ChatML shape textually; specials are injected by encode_chat
        parts = []
        for m in messages:
            parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
        if add_generation_prompt:
            parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    def encode_chat(self, messages: list[dict]) -> list[int]:
        ids: list[int] = []
        for m in messages:
            ids.append(self.IM_START)
            ids.extend(self.encode(f"{m['role']}\n{m['content']}"))
            ids.append(self.IM_END)
        ids.append(self.IM_START)
        ids.extend(self.encode("assistant\n"))
        return ids


class HFTokenizer:
    """Thin adapter over a local transformers tokenizer directory."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)
        self.eos_token_id = self._tok.eos_token_id

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=add_generation_prompt
        )

    def encode_chat(self, messages: list[dict]) -> list[int]:
        return self._tok.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True
        )


def make_tokenizer(model_dir: str, backend: str | None = None) -> "Tokenizer":
    """Tokenizer for a local checkpoint dir: the in-tree C++/Python BPE when
    ``tokenizer.json`` is a byte-level BPE (no transformers import at all),
    else the transformers adapter.  ``backend`` overrides
    Settings.tokenizer_backend ("native" | "hf")."""
    import os

    if backend is None:
        from githubrepostorag_tpu_torch.config import get_settings

        backend = get_settings().tokenizer_backend
    tj = os.path.join(model_dir, "tokenizer.json")
    if backend == "native" and os.path.isfile(tj):
        try:
            from githubrepostorag_tpu_torch.serving.bpe_native import NativeBPETokenizer

            tok = NativeBPETokenizer.from_checkpoint(model_dir)
            # serving renders chat prompts: only select the native tokenizer
            # when its ChatML template matches this vocab's markers
            tok.apply_chat_template([{"role": "user", "content": "probe"}])
            return tok
        except Exception as exc:  # noqa: BLE001 - non-BPE json, unusual spec,
            # unsupported normalizer/pre-tokenizer, undeterminable eos,
            # non-ChatML vocab or unrecognizable chat template
            import logging

            logging.getLogger(__name__).warning(
                "native BPE load failed for %s (%s); using transformers", tj, exc
            )
    return HFTokenizer(model_dir)


class StreamingDetokenizer:
    """Incremental decode that never emits half a UTF-8 codepoint (the
    reference never streams at all — qwen_llm.py:149-151 fakes it)."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self._tok = tokenizer
        self._ids: list[int] = []
        self._emitted = 0

    def push(self, token_id: int) -> str:
        """Feed one token, get newly-complete text (possibly empty)."""
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        # hold back anything that still ends in a replacement char (partial
        # multi-byte sequence) until the next token completes it
        safe_end = len(text)
        while safe_end > 0 and text[safe_end - 1] == "�":
            safe_end -= 1
        out = text[self._emitted : safe_end]
        self._emitted = safe_end
        return out

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        out = text[self._emitted :]
        self._emitted = len(text)
        return out
