"""Disaggregated prefill/decode serving: role assignment + KV transport;
port of ``githubrepostorag_tpu/serving/disagg.py``.

A DistServe-style split inside one process: under ``DISAGG=on`` a tiered
fleet of two or more replicas gives ``DISAGG_PREFILL_REPLICAS`` of them
the prefill role and the rest the decode role.  ``MultiAsyncEngine``
sends a new request to a prefill replica for a one-token pass, ships the
finished full prefix pages to the decode replica the affinity ranking
picks through the transport seam below, and submits the original request
there: admission ``share``s the imported host pages and the ordinary
fault-in scatters land them, so the decode replica recomputes only the
tail page (kernel A's prefill window) and resumes token for token.  Any
handoff failure finishes the request fused on the prefill replica; a
fleet that cannot split (one replica, an untiered allocator,
``DISAGG=off``) never leaves fused.

On one card every replica's pools live in the same device memory, so the
in-process transport moves each page card -> host (the source's export
gather) -> the destination's host tier; the fault-in scatters it back
onto the card.  This module owns the two seams that make the split
swappable:

* ``assign_roles`` -- whether the split is viable and which replica takes
  which role.
* ``PageTransport`` / ``InProcessTransport`` -- how exported page payloads
  reach the peer.  A device-to-device or RDMA transport lands here later
  without touching the router.
"""

from __future__ import annotations

import logging
from typing import Any, Protocol

from githubrepostorag_tpu_torch import metrics
from githubrepostorag_tpu_torch.resilience.faults import fire_async

logger = logging.getLogger(__name__)

# gauge encoding for metrics.FLEET_ROLE
ROLE_GAUGE = {"fused": 0, "prefill": 1, "decode": 2}


def assign_roles(engines: list, settings) -> bool:
    """Split ``engines`` (AsyncEngines, spares included) into prefill and
    decode roles per ``settings``; returns whether disaggregation is on.

    The split happens only when it can work: ``DISAGG=on``, at least two
    active replicas, and every active replica running the tiered allocator
    (the handoff moves pages through the host tier).
    ``DISAGG_PREFILL_REPLICAS`` is clamped so at least one decode replica
    remains.  Anything else leaves every replica fused.  Spares stay fused
    until activated; an activated spare decodes."""
    active = [ae for ae in engines if ae.lifecycle == "active"]
    for ae in engines:
        ae.role = "fused"
    on = False
    if settings.disagg == "on":
        tiered = all(getattr(ae.engine, "_kv_tier_on", False) for ae in active)
        if len(active) >= 2 and tiered:
            n_pre = max(1, min(settings.disagg_prefill_replicas, len(active) - 1))
            for ae in active[:n_pre]:
                ae.role = "prefill"
            for ae in active[n_pre:]:
                ae.role = "decode"
            on = True
            logger.info("disagg on: %d prefill / %d decode replicas",
                        n_pre, len(active) - n_pre)
        else:
            logger.warning("DISAGG=on but fleet can't split (%d active, tiered=%s): "
                           "staying fused", len(active), tiered)
    for ae in engines:
        metrics.FLEET_ROLE.labels(replica=ae.replica).set(ROLE_GAUGE[ae.role])
    return on


class PageTransport(Protocol):
    """Moves exported KV page payloads from one replica to another.

    ``transfer`` returns ``(exported, stored)``: how many payloads left
    the source and how many the destination kept (the gap is pages the
    destination already held: content-hash dedup on the wire)."""

    async def transfer(self, src, dst, hashes: list[bytes]) -> tuple[int, int]: ...


class InProcessTransport:
    """Same-process transport: export on the source's driver, import on
    the destination's, host copies between.

    Payloads move in chunks of ``DISAGG_TRANSFER_BURST`` pages so one large
    handoff cannot hold either driver for its whole length: decode steps
    interleave between chunks.  Each chunk crosses the ``disagg.transfer``
    chaos seam first, where a wire transport would fail too (peer died,
    link down), so FAULTS exercises the router's fused fallback where
    production breaks."""

    def __init__(self, burst: int) -> None:
        self.burst = max(1, burst)
        self.transfers = 0
        self.chunks = 0

    async def transfer(self, src, dst, hashes: list[bytes]) -> tuple[int, int]:
        if not hashes:
            return 0, 0
        exported = stored = 0
        for i in range(0, len(hashes), self.burst):
            chunk = hashes[i:i + self.burst]
            await fire_async("disagg.transfer")
            pages = await src.export_kv_pages(chunk)
            exported += len(pages)
            stored += await dst.import_kv_pages(pages)
            self.chunks += 1
        self.transfers += 1
        return exported, stored

    def payload(self) -> dict[str, Any]:
        return {"kind": "in_process", "burst": self.burst,
                "transfers": self.transfers, "chunks": self.chunks}
