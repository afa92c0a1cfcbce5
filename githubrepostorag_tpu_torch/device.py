"""Device selection shared by the port's entry points."""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Asking for the card where there is none is
    an error, never a silent CPU run: the plain path runs on the CPU only
    when the caller asks for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def explicit_device(device: str | torch.device | None = None) -> torch.device:
    """``resolve_device`` with the card's index filled in (the current one
    when none is given), for objects whose work runs on other threads: a
    new thread's current device is card 0, whatever the creator's was."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The card's number of SMs (the kernels' plans size their grids by
    it), read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# allow_tf32 is one process-wide flag: forwards on several threads share
# one save / restore, the last to leave restores the caller's setting
_ieee_lock = threading.Lock()
_ieee_users = 0
_ieee_saved = False


@contextmanager
def ieee_float32(device: torch.device):
    """IEEE float32 matmuls on the card for the enclosed block, whatever
    ``allow_tf32`` says outside it (TF32 keeps 10 mantissa bits: ~1e-3
    relative, where the retrieval path promises parity within 1e-5)."""
    global _ieee_users, _ieee_saved
    if device.type != "cuda":
        yield
        return
    with _ieee_lock:
        if _ieee_users == 0:
            _ieee_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _ieee_users += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_users -= 1
            if _ieee_users == 0:
                torch.backends.cuda.matmul.allow_tf32 = _ieee_saved
