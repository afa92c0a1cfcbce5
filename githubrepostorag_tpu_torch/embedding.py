"""Text embedding service: the one encoder shared by ingest writes and
query-time retrieval; port of ``githubrepostorag_tpu/embedding.py``.

Two encoder backends behind one protocol:
  - ``TorchBertTextEncoder`` -- the real path: HF tokenizer + the port's
    BERT encoder (models/encoder.py) on the card, length-bucketed batches.
    e5-style ``query:``/``passage:`` prefixes applied when the model name
    says e5.  The counterpart of the JAX package's ``JaxBertTextEncoder``,
    without its data-parallel mesh (ROADMAP queue 1 item 8).
  - ``HashingTextEncoder`` -- deterministic, dependency-free encoder
    (signed feature hashing of word/bigram tokens, L2-normalized), bit for
    bit the JAX package's: the test backbone and the no-weights backend.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
from pathlib import Path
from typing import Literal, Protocol, Sequence

import numpy as np
import torch

from githubrepostorag_tpu_torch.config import get_settings
from githubrepostorag_tpu_torch.device import explicit_device
from githubrepostorag_tpu_torch.models.encoder import BertConfig, embed, params_from_hf_state_dict
from githubrepostorag_tpu_torch.utils import next_bucket
from githubrepostorag_tpu_torch.utils.logging import get_logger
from githubrepostorag_tpu_torch.utils.profiling import annotate

logger = get_logger(__name__)

Kind = Literal["query", "passage"]


class TextEncoder(Protocol):
    dim: int

    def encode(self, texts: Sequence[str], kind: Kind = "passage") -> np.ndarray:
        """-> [N, dim] float32, L2-normalized rows."""
        ...


_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]+|[0-9]+")


@functools.lru_cache(maxsize=1 << 16)
def _hash_slot(tok: str, dim: int) -> tuple[int, float]:
    """md5(token) -> (feature index, sign), memoized (token vocabularies
    repeat heavily across chunks of one repo)."""
    digest = hashlib.md5(tok.encode("utf-8")).digest()
    return int.from_bytes(digest[:4], "little") % dim, 1.0 if digest[4] & 1 else -1.0


class HashingTextEncoder:
    """Signed feature hashing over words + bigrams, sublinear tf, L2 norm."""

    def __init__(self, dim: int | None = None) -> None:
        self.dim = dim or get_settings().embed_dim

    def _tokens(self, text: str) -> list[str]:
        words = [w.lower() for w in _WORD_RE.findall(text)]
        bigrams = [f"{a}_{b}" for a, b in zip(words, words[1:])]
        return words + bigrams

    def encode(self, texts: Sequence[str], kind: Kind = "passage") -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, text in enumerate(texts):
            counts: dict[str, int] = {}
            for tok in self._tokens(text):
                counts[tok] = counts.get(tok, 0) + 1
            for tok, count in counts.items():
                idx, sign = _hash_slot(tok, self.dim)
                out[i, idx] += sign * (1.0 + np.log(count))
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out


class TorchBertTextEncoder:
    """HF-style tokenizer + the port's BERT on the card.  ``encode`` sorts
    texts by character length (stably) and pads each batch to a power-of-
    two token length and row count, so the card sees a handful of shapes,
    the JAX package's same ones; ``shapes`` records every (rows, length)
    dispatched, ``warmup`` drives the whole ladder."""

    def __init__(
        self,
        params: dict,
        cfg: BertConfig,
        tokenizer,
        *,
        max_length: int = 512,
        batch_size: int = 64,
        e5_prefixes: bool = True,
        device=None,
    ) -> None:
        self.device = explicit_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size
        self.e5_prefixes = e5_prefixes
        self.dim = cfg.hidden_size
        self.params = _to_device(params, self.device)
        self.shapes: set[tuple[int, int]] = set()

    @classmethod
    def from_pretrained(cls, model_dir: str, device=None, **kw) -> "TorchBertTextEncoder":
        """A local HF BERT checkpoint dir: ``config.json``, ``*.safetensors``
        (read by the port's own reader) and the tokenizer files
        (``transformers.AutoTokenizer``, as the JAX package loads them)."""
        from transformers import AutoTokenizer

        from githubrepostorag_tpu_torch.models.safetensors_io import load_file

        root = Path(model_dir)
        hf_cfg = json.loads((root / "config.json").read_text())
        cfg = BertConfig(
            vocab_size=hf_cfg["vocab_size"],
            hidden_size=hf_cfg["hidden_size"],
            intermediate_size=hf_cfg["intermediate_size"],
            num_layers=hf_cfg["num_hidden_layers"],
            num_heads=hf_cfg["num_attention_heads"],
            max_position_embeddings=hf_cfg["max_position_embeddings"],
            type_vocab_size=hf_cfg.get("type_vocab_size", 2),
            layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        )
        dev = explicit_device(device)
        state: dict = {}
        for shard in sorted(root.glob("*.safetensors")):
            state.update(load_file(shard))
        params = params_from_hf_state_dict(state, cfg, device=dev)
        tokenizer = AutoTokenizer.from_pretrained(model_dir)
        kw.setdefault("e5_prefixes", "e5" in model_dir.lower())
        return cls(params, cfg, tokenizer, device=dev, **kw)

    def length_buckets(self) -> list[int]:
        """Every token-length bucket ``encode`` can hand ``embed``."""
        return sorted({next_bucket(n, self.max_length) for n in range(1, self.max_length + 1)})

    def row_buckets(self) -> list[int]:
        """Every row bucket ``encode`` can hand ``embed`` (partial tail
        batches included)."""
        return sorted({next_bucket(n, self.batch_size, minimum=8)
                       for n in range(1, self.batch_size + 1)})

    def _embed(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        self.shapes.add(ids.shape)
        ids_d = torch.from_numpy(ids).to(self.device)
        mask_d = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            return embed(self.params, self.cfg, ids_d, mask_d)

    def warmup(self) -> int:
        """Drive ``embed`` over the full (rows x length) bucket ladder once,
        so live ``encode`` traffic meets no shape it has not run; returns
        the number of dispatches."""
        n = 0
        for rows in self.row_buckets():
            for bucket in self.length_buckets():
                ids = np.zeros((rows, bucket), dtype=np.int64)
                mask = np.zeros((rows, bucket), dtype=np.int64)
                mask[:, 0] = 1  # one real token per row, like a live batch
                with annotate("encoder.warmup"):
                    self._embed(ids, mask).cpu()
                n += 1
        logger.info("embedding: warmup drove %d bucket shapes", n)
        return n

    def encode(self, texts: Sequence[str], kind: Kind = "passage") -> np.ndarray:
        if self.e5_prefixes:
            prefix = "query: " if kind == "query" else "passage: "
            texts = [prefix + t for t in texts]
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        order = sorted(range(len(texts)), key=lambda i: len(texts[i]))
        for start in range(0, len(order), self.batch_size):
            idx = order[start: start + self.batch_size]
            enc = self.tokenizer([texts[i] for i in idx], truncation=True,
                                 max_length=self.max_length, padding=False)
            max_len = max(len(x) for x in enc["input_ids"])
            bucket = next_bucket(max_len, self.max_length)
            rows = next_bucket(len(idx), self.batch_size, minimum=8)
            ids = np.zeros((rows, bucket), dtype=np.int64)
            mask = np.zeros((rows, bucket), dtype=np.int64)
            for row, toks in enumerate(enc["input_ids"]):
                ids[row, : len(toks)] = toks
                mask[row, : len(toks)] = 1
            with annotate("encoder.embed_batch"):
                vecs = self._embed(ids, mask)
            out[idx] = vecs[: len(idx)].float().cpu().numpy()
        return out


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


_encoder: TextEncoder | None = None


def get_encoder(device=None) -> TextEncoder:
    """Process-wide encoder: the port's BERT on ``device`` (the card unless
    ``"cpu"``) when EMBED_MODEL points at a local checkpoint dir, else the
    hashing encoder (the JAX package's behaviour for missing weights)."""
    global _encoder
    if _encoder is None:
        model = get_settings().embed_model
        if model and os.path.isdir(model):
            _encoder = TorchBertTextEncoder.from_pretrained(model, device=device)
            logger.info("embedding: torch BERT encoder from %s on %s", model,
                        _encoder.device)
        else:
            _encoder = HashingTextEncoder()
            logger.warning(
                "embedding: EMBED_MODEL=%r is not a local checkpoint directory — "
                "falling back to the lexical hashing encoder. Retrieval quality is "
                "degraded until a local BERT checkpoint is mounted and EMBED_MODEL "
                "points at it.",
                model,
            )
    return _encoder


def set_encoder(encoder: TextEncoder | None) -> None:
    global _encoder
    _encoder = encoder
