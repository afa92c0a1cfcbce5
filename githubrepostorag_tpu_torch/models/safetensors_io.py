"""Read and write the safetensors checkpoint format without the
``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [start, end]}, "__metadata__":
{...}}``, padded with spaces to a multiple of 8), then the tensors' raw
little-endian bytes; ``data_offsets`` count from the end of the header.

``load_file`` maps the file (copy-on-write, so nothing is read until used
and nothing is copied whole) and views each tensor through
``torch.frombuffer``; with a ``device`` each tensor goes there one at a
time.  ``save_file`` writes the same layout, larger element types first so
every tensor stays aligned to its element size.  The dtypes are those of
Qwen2 and AutoAWQ checkpoints; any other, or a malformed header, raises.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
    "U8": torch.uint8,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024  # the safetensors package's own limit


def _header(buf, path) -> tuple[dict, int]:
    """The parsed header and the offset its data starts at; raises
    ValueError on anything malformed."""
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > _MAX_HEADER or 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} exceeds the file ({len(buf)} bytes)")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise ValueError(f"{path}: header is not JSON: {exc}") from exc
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    return header, 8 + n


def _entries(header: dict, data_len: int, path) -> list[tuple[str, torch.dtype, list, int, int]]:
    """(name, dtype, shape, start, end) of every tensor, checked: known
    dtype, non-negative shape, a byte range of exactly its size, and the
    ranges tiling the data section with no gap or overlap."""
    out = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            code, shape, (start, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"{path}: malformed entry for {name!r}: {info!r}") from exc
        if code not in DTYPES:
            raise ValueError(f"{path}: {name!r} has unsupported dtype {code!r}; "
                             f"supported: {sorted(DTYPES)}")
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: {name!r} has a malformed shape {shape!r}")
        dtype = DTYPES[code]
        numel = 1
        for d in shape:
            numel *= d
        if not (isinstance(start, int) and isinstance(end, int) and 0 <= start <= end
                and end - start == numel * dtype.itemsize):
            raise ValueError(f"{path}: {name!r} data_offsets {[start, end]} do not hold "
                             f"{shape} x {code}")
        out.append((name, dtype, shape, start, end))
    at = 0
    for name, _, _, start, end in sorted(out, key=lambda e: (e[3], e[4])):
        if start != at:
            raise ValueError(f"{path}: {name!r} starts at {start}, expected {at} "
                             "(tensors must tile the data section)")
        at = end
    if at != data_len:
        raise ValueError(f"{path}: tensors cover {at} bytes of a {data_len}-byte data section")
    return out


def load_file(path: str | Path, device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, by name.  Without ``device`` the
    tensors are views of the file's private (copy-on-write) mapping; with
    one each is copied there, one at a time."""
    path = Path(path)
    with open(path, "rb") as f:
        if path.stat().st_size == 0:
            raise ValueError(f"{path}: empty file")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, base = _header(mm, path)
    out = {}
    for name, dtype, shape, start, end in _entries(header, len(mm) - base, path):
        if end == start:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(mm, dtype=dtype, count=(end - start) // dtype.itemsize,
                                 offset=base + start).reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as a
    safetensors file."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    at = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r} has unsupported dtype {t.dtype}; "
                             f"supported: {sorted(map(str, _NAMES))}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + nbytes]}
        at += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))
