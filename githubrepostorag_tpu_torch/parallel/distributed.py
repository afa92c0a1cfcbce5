"""Multi-process runtime initialisation: ``torch.distributed`` from the
environment; port of ``githubrepostorag_tpu/parallel/distributed.py``.

JAX joins every host process into one ``jax.distributed`` runtime.  Here
every process is one rank of a ``torch.distributed`` world (one card or
one CPU process each), over NCCL when the caller's device is CUDA and gloo
on the CPU.  The environment contract is JAX's, so one launcher serves
both packages:

  JAX_COORDINATOR_ADDRESS  host:port of rank 0's store   (required to opt in)
  JAX_NUM_PROCESSES        the world size
  JAX_PROCESS_ID           this process's rank

``JAX_DISTRIBUTED=auto`` maps to torch's ``env://`` (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as torch launchers set them).

Every group has a finite timeout (the world's, and ``parallel/mesh.py``'s
axis groups take the same), so a rank whose peers never reach a
collective fails instead of hanging.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch.distributed as dist

from githubrepostorag_tpu_torch.device import resolve_device
from githubrepostorag_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_TIMEOUT_S = 600.0

_initialized = False
_timeout = timedelta(seconds=DEFAULT_TIMEOUT_S)


def maybe_initialize_distributed(device=None, *, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the multi-process world when configured; no-op otherwise.

    Returns True when this process is part of a world.  Safe to call from
    every entry point: initialisation happens once while the world is up
    (after ``destroy_process_group`` a later call starts a new one).
    ``device`` picks the backend (None means the card, as everywhere in
    the port); it is read only once the environment opts in."""
    global _initialized, _timeout
    if _initialized and dist.is_initialized():
        return True

    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    auto = os.environ.get("JAX_DISTRIBUTED", "").lower() == "auto"
    if not coordinator and not auto:
        return False

    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    if coordinator:
        missing = [k for k in ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID") if k not in os.environ]
        if missing:
            raise ValueError(f"JAX_COORDINATOR_ADDRESS is set without {', '.join(missing)}: "
                             "torch.distributed needs the world size and this rank")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(os.environ["JAX_NUM_PROCESSES"]),
                                rank=int(os.environ["JAX_PROCESS_ID"]), timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    _initialized, _timeout = True, timeout
    logger.info("torch.distributed up: rank %d/%d over %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def group_timeout() -> timedelta:
    """The timeout of the world this module started, for the groups made
    inside it."""
    return _timeout
