"""In-tree byte-level BPE tokenizer: C++ merge core + Python unicode front;
port of ``githubrepostorag_tpu/serving/bpe_native.py``, behavior unchanged.

The same byte-level BPE family as HuggingFace ``tokenizers`` (GPT-2 /
Qwen2 ``tokenizer.json``), split in two:

  - Python owns what needs unicode tables: the pre-tokenization regex
    (``\\p{L}``-class splitting via the ``regex`` module), the GPT-2
    byte<->unicode vocabulary transcoding, special-token splitting, and the
    chat template.
  - C++ owns the hot loop: the heap-driven merge algorithm over each
    pre-tokenized segment (the repository's ``native/bpe.cpp`` via ctypes,
    built into the port's ``_build/`` by ``utils/host_build.py``).  A
    pure-Python merge fallback keeps the tokenizer working when no
    compiler is available.

Satisfies the serving ``Tokenizer`` protocol (serving/tokenizer.py), so it
drops into the OpenAI server wherever ``HFTokenizer`` would -- without
importing transformers at all.
"""

from __future__ import annotations

import ctypes
import json
import logging
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Sequence

from githubrepostorag_tpu_torch.utils.host_build import NATIVE_DIR, build_library, library_path

logger = logging.getLogger(__name__)

_SOURCE = NATIVE_DIR / "bpe.cpp"

# GPT-2's pre-tokenization pattern; Qwen2's tokenizer.json carries its own
# variant in a Split pre-tokenizer, which the loader prefers when present.
GPT2_PATTERN = (
    r"'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map (vocab files store
    token bytes through this transcoding so they stay valid JSON strings)."""
    bs = list(range(ord("!"), ord("~") + 1))
    bs += list(range(ord("\xa1"), ord("\xac") + 1))
    bs += list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def _unicode_to_byte() -> dict[str, int]:
    return {u: b for b, u in _byte_to_unicode().items()}


def _token_str_to_bytes(token: str) -> bytes:
    u2b = _unicode_to_byte()
    return bytes(u2b[ch] for ch in token)


def _library_path() -> Path:
    return library_path(_SOURCE, "libbpe")


@lru_cache(maxsize=1)
def _load_library() -> ctypes.CDLL | None:
    """The merge core, built at first use; None (the pure-Python merges)
    when it cannot be built or loaded."""
    try:
        lib_path = build_library(_SOURCE, "libbpe")
    except (subprocess.SubprocessError, OSError) as exc:
        logger.warning("native bpe build failed, using python merges: %s", exc)
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
        I32P = ctypes.POINTER(ctypes.c_int32)
        lib.bpe_new.argtypes = [I32P, I32P, ctypes.c_int32, I32P]
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), I32P,
            ctypes.c_int32, I32P, I32P,
        ]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_free.restype = None
        return lib
    except OSError as exc:  # pragma: no cover - environment-specific
        logger.warning("native bpe load failed, using python merges: %s", exc)
        return None


class NativeBPETokenizer:
    """Byte-level BPE from a HuggingFace-format ``tokenizer.json``.

    Implements the serving ``Tokenizer`` protocol with a ChatML template
    (the Qwen2 family's — SURVEY.md §2.1 serving model rows).
    """

    def __init__(
        self,
        tokenizer_json: str | Path,
        use_native: bool = True,
        default_system: str | None = None,
    ) -> None:
        # injected into chats that carry no system turn (Qwen2's template
        # does this — see from_checkpoint, which extracts the checkpoint's
        # own default); None = render exactly the provided messages
        self.default_system = default_system
        path = Path(tokenizer_json)
        spec = json.loads(path.read_text())
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE tokenizer.json: type={model.get('type')}")
        self._norm_forms = self._parse_normalizer(spec.get("normalizer"))
        self._ignore_merges = bool(model.get("ignore_merges", False))

        self.vocab: dict[str, int] = model["vocab"]
        self._id_to_bytes: dict[int, bytes] = {
            i: _token_str_to_bytes(tok) for tok, i in self.vocab.items()
        }
        merges_raw = model["merges"]  # ["a b", ...] or [["a", "b"], ...]
        merges: list[tuple[int, int, int]] = []  # (left_id, right_id, merged_id)
        for m in merges_raw:
            left, right = m.split(" ", 1) if isinstance(m, str) else (m[0], m[1])
            li, ri = self.vocab.get(left), self.vocab.get(right)
            mi = self.vocab.get(left + right)
            if li is None or ri is None or mi is None:
                continue  # malformed row: skip rather than mis-rank the rest
            merges.append((li, ri, mi))
        self._merge_rank: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (li, ri, mi) in enumerate(merges):
            self._merge_rank.setdefault((li, ri), (rank, mi))

        # initial id per raw byte (byte-level BPE has all 256 in vocab)
        b2u = _byte_to_unicode()
        self._byte_ids = [self.vocab[b2u[b]] for b in range(256)]
        # whole-segment vocab lookup for ignore_merges (HF: a segment whose
        # transcoded string is already a vocab entry skips the merge loop)
        self._bytes_to_id = {b: i for i, b in self._id_to_bytes.items()}

        # added tokens bypass pre-tokenization and merging; only entries
        # flagged special=true are hidden by decode (HF skip_special_tokens)
        added = spec.get("added_tokens", [])
        self.specials: dict[str, int] = {t["content"]: t["id"] for t in added}
        self._id_to_special = {
            t["id"]: t["content"] for t in added if t.get("special", True)
        }
        self._added_plain = {  # non-special added tokens decode as their text
            t["id"]: t["content"].encode("utf-8")
            for t in added
            if not t.get("special", True)
        }
        self.eos_token_id = self._pick_eos(path)

        self._pattern = self._find_pattern(spec)
        import regex

        self._re = regex.compile(self._pattern) if self._pattern else None
        self._specials_re = (
            regex.compile("|".join(regex.escape(s) for s in sorted(
                self.specials, key=len, reverse=True)))
            if self.specials else None
        )

        self._lib = _load_library() if use_native else None
        self._handle = None
        if self._lib is not None:
            flat = []
            merged = []
            for li, ri, mi in merges:
                flat += [li, ri]
                merged.append(mi)
            arr = (ctypes.c_int32 * len(flat))(*flat)
            mrg = (ctypes.c_int32 * max(len(merged), 1))(*(merged or [0]))
            byt = (ctypes.c_int32 * 256)(*self._byte_ids)
            self._handle = self._lib.bpe_new(arr, mrg, len(merged), byt)
        self.backend = "native" if self._handle else "python"

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.bpe_free(handle)

    # ------------------------------------------------------------- loading --

    @classmethod
    def from_checkpoint(cls, model_dir: str | Path, **kw) -> "NativeBPETokenizer":
        """Build from a checkpoint dir, honoring its chat template's default
        system prompt.  If tokenizer_config.json carries a chat_template,
        the template must contain a recognizable ChatML default-system
        literal (`<|im_start|>system\\n...<|im_end|>` with plain text
        inside, as Qwen2's does) — otherwise the template's semantics are
        unknown and we raise so make_tokenizer uses transformers instead of
        silently rendering a different prompt than the checkpoint expects."""
        import re as _re

        model_dir = Path(model_dir)
        cfg_path = model_dir / "tokenizer_config.json"
        default_system = None
        if cfg_path.is_file():
            template = json.loads(cfg_path.read_text()).get("chat_template")
            if template:
                # jinja string literals carry "\n" as backslash-n
                for m in _re.finditer(
                    r"<\|im_start\|>system(?:\\n|\n)(.*?)<\|im_end\|>", template, _re.S
                ):
                    content = m.group(1)
                    if not any(ch in content for ch in "{}'\"+"):
                        # jinja string literals carry newlines as backslash-n;
                        # render them as the template engine would
                        default_system = content.replace("\\n", "\n")
                        break
                else:
                    raise ValueError(
                        "chat_template present but no ChatML default-system "
                        "literal found — template semantics unknown"
                    )
        return cls(model_dir / "tokenizer.json", default_system=default_system, **kw)

    @staticmethod
    def _parse_normalizer(node) -> list[str]:
        """Unicode normalization forms the spec requests, in order.  Anything
        beyond NFC/NFD/NFKC/NFKD is unsupported — raise so make_tokenizer
        falls back to the transformers adapter rather than mis-tokenizing."""
        if node is None:
            return []
        if node.get("type") == "Sequence":
            forms: list[str] = []
            for sub in node.get("normalizers", []):
                forms += NativeBPETokenizer._parse_normalizer(sub)
            return forms
        if node.get("type") in ("NFC", "NFD", "NFKC", "NFKD"):
            return [node["type"]]
        raise ValueError(f"unsupported normalizer: {node.get('type')}")

    def _pick_eos(self, tokenizer_json_path: Path) -> int:
        # the authoritative name lives in the sibling tokenizer_config.json
        cfg_path = tokenizer_json_path.parent / "tokenizer_config.json"
        if cfg_path.is_file():
            try:
                eos = json.loads(cfg_path.read_text()).get("eos_token")
                if isinstance(eos, dict):  # {"content": "...", ...} form
                    eos = eos.get("content")
                if eos in self.specials:
                    return self.specials[eos]
                if eos in self.vocab:
                    return self.vocab[eos]
            except (OSError, json.JSONDecodeError):  # pragma: no cover
                pass
        for name in ("<|im_end|>", "<|endoftext|>", "</s>", "<eos>"):
            if name in self.specials:
                return self.specials[name]
        raise ValueError(
            "cannot determine the eos token: no tokenizer_config.json and no "
            "recognized eos-like special — refusing to guess a stop token"
        )

    @staticmethod
    def _find_pattern(spec: dict) -> str | None:
        """The split regex from the pre_tokenizer config (Qwen2 keeps it in
        a Split node; plain ByteLevel implies the GPT-2 pattern).  STRICT:
        semantics this implementation doesn't reproduce (add_prefix_space,
        Split.invert, delimiter-dropping behaviors, non-byte-level
        pre-tokenizers) raise, so make_tokenizer falls back to the
        transformers adapter instead of silently mis-tokenizing.  Returns
        None for no pre_tokenizer at all (whole text = one segment)."""
        import regex

        node = spec.get("pre_tokenizer")
        if node is None:
            return None
        found: list[str] = []

        def walk(n):
            t = n.get("type")
            if t == "Sequence":
                for sub in n.get("pretokenizers", []):
                    walk(sub)
            elif t == "Split":
                if n.get("invert"):
                    raise ValueError("unsupported pre_tokenizer: Split.invert")
                if n.get("behavior", "Isolated") != "Isolated":
                    raise ValueError(
                        f"unsupported Split.behavior {n.get('behavior')!r} "
                        "(only Isolated keeps all text)"
                    )
                pat = n.get("pattern", {})
                if "Regex" in pat:
                    found.append(pat["Regex"])
                elif "String" in pat:
                    found.append(regex.escape(pat["String"]))
                else:
                    raise ValueError(f"unsupported Split.pattern {pat!r}")
            elif t == "ByteLevel":
                if n.get("add_prefix_space"):
                    raise ValueError(
                        "unsupported pre_tokenizer: ByteLevel.add_prefix_space"
                    )
                if n.get("use_regex", True):
                    found.append(GPT2_PATTERN)
            else:
                raise ValueError(f"unsupported pre_tokenizer type {t!r}")

        walk(node)
        if len(found) > 1 and len(set(found)) > 1:
            raise ValueError("multiple conflicting split patterns in pre_tokenizer")
        return found[0] if found else None

    # ------------------------------------------------------------ encoding --

    def _encode_ordinary(self, text: str) -> list[int]:
        """BPE-encode text containing no special tokens."""
        import unicodedata

        for form in self._norm_forms:
            text = unicodedata.normalize(form, text)
        if not text:
            return []
        # unicode regex split; characters the pattern skips become their own
        # segments so byte offsets never misalign
        segs: list[str] = []
        if self._re is None:  # no pre_tokenizer: the whole text is one segment
            segs.append(text)
        else:
            last = 0
            for m in self._re.finditer(text):
                if m.start() > last:
                    segs.append(text[last : m.start()])
                segs.append(m.group())
                last = m.end()
            if last < len(text):
                segs.append(text[last:])

        # per segment: a whole-vocab hit (ignore_merges) resolves here; the
        # rest batch into one native call (or the python merge loop)
        resolved: list[list[int] | None] = []
        merge_sbs: list[bytes] = []
        for seg in segs:
            sb = seg.encode("utf-8")
            if self._ignore_merges:
                whole = self._bytes_to_id.get(sb)
                if whole is not None:
                    resolved.append([whole])
                    continue
            resolved.append(None)
            merge_sbs.append(sb)

        if merge_sbs:
            merged = self._encode_segments(merge_sbs)
        else:
            merged = []
        ids: list[int] = []
        it = iter(merged)
        for r in resolved:
            ids.extend(r if r is not None else next(it))
        return ids

    def _encode_segments(self, sbs: list[bytes]) -> list[list[int]]:
        """Run the merge loop over each byte segment (native in one call)."""
        if self._handle:
            raw = b"".join(sbs)
            offsets = [0]
            for sb in sbs:
                offsets.append(offsets[-1] + len(sb))
            buf = (ctypes.c_uint8 * max(len(raw), 1)).from_buffer_copy(raw or b"\0")
            offs = (ctypes.c_int32 * len(offsets))(*offsets)
            out = (ctypes.c_int32 * max(len(raw), 1))()
            counts = (ctypes.c_int32 * len(sbs))()
            self._lib.bpe_encode(self._handle, buf, offs, len(sbs), out, counts)
            result: list[list[int]] = []
            pos = 0
            for c in counts:
                result.append(list(out[pos : pos + c]))
                pos += c
            return result
        return [self._merge_py(sb) for sb in sbs]

    def _merge_py(self, seg: bytes) -> list[int]:
        """Pure-Python merge loop (fallback; also the native core's oracle in
        tests).  Applies the lowest-rank adjacent merge until none apply."""
        ids = [self._byte_ids[b] for b in seg]
        while len(ids) > 1:
            best_rank, best_i = None, -1
            for i in range(len(ids) - 1):
                r = self._merge_rank.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r[0] < best_rank):
                    best_rank, best_i = r[0], i
            if best_i < 0:
                break
            ids[best_i : best_i + 2] = [self._merge_rank[(ids[best_i], ids[best_i + 1])][1]]
        return ids

    def encode(self, text: str) -> list[int]:
        if self._specials_re is None:
            return self._encode_ordinary(text)
        ids: list[int] = []
        pos = 0
        for m in self._specials_re.finditer(text):
            ids.extend(self._encode_ordinary(text[pos : m.start()]))
            ids.append(self.specials[m.group()])
            pos = m.end()
        ids.extend(self._encode_ordinary(text[pos:]))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts: list[bytes] = []
        for i in ids:
            if i in self._id_to_special:
                continue  # skip_special_tokens semantics, like HFTokenizer
            plain = self._added_plain.get(i)
            if plain is not None:  # non-special added token: keep its text
                parts.append(plain)
                continue
            tok = self._id_to_bytes.get(i)
            if tok is not None:
                parts.append(tok)
        return b"".join(parts).decode("utf-8", errors="replace")

    # ---------------------------------------------------------------- chat --

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        if "<|im_start|>" not in self.specials or "<|im_end|>" not in self.specials:
            raise ValueError(
                "vocab has no ChatML markers — this tokenizer only renders the "
                "ChatML (Qwen2-family) template; use the transformers adapter "
                "for checkpoints with other chat templates"
            )
        if self.default_system is not None and (
            not messages or messages[0].get("role") != "system"
        ):
            messages = [{"role": "system", "content": self.default_system}] + messages
        parts = [
            f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages
        ]
        if add_generation_prompt:
            parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    def encode_chat(self, messages: list[dict]) -> list[int]:
        return self.encode(self.apply_chat_template(messages))
