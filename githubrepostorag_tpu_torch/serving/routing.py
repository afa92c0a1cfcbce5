"""Fleet-router primitives: per-replica chain digests + prefix scoring;
port of ``githubrepostorag_tpu/serving/routing.py`` (pure Python, the
same names and weights).

The router (``serving/multi_engine.py``) runs on the event loop; each
replica's driver thread owns its allocator.  ``ReplicaDigest`` is the
bridge: the driver publishes a frozen view of its resident / host-tier
chain-hash populations (rate-limited by ``ROUTE_DIGEST_INTERVAL_S``) and
the router reads the latest pair under the same lock — never the live
allocator maps.  Frozensets make the snapshot O(1) to hand over and
immutable on the reader side; the lock covers only a two-reference swap,
so neither domain ever blocks on the other's work.
"""

from __future__ import annotations

import threading

# A host-tier match still skips recomputing prefill but pays a fault-in
# (host->device DMA) per page, so it scores below a resident match.
RESIDENT_WEIGHT = 1.0
HOST_WEIGHT = 0.6

# Fallback weighting: a replica's windowed limiter attribution (obs/ledger)
# expressed as equivalent extra queue depth.  A replica limited by
# `hbm_pages` or `swap_wait` is a bad target even with a short queue — new
# admissions there wait on page churn, not compute.  `kv_transfer` means
# the replica's driver is busy packing/unpacking disaggregated handoffs
# between steps — worse than mild stall, milder than page starvation.
# `compile` is transient but poisons TTFT while it lasts; `stall` is mild
# host-side friction.
LIMITER_PENALTY = {
    "hbm_pages": 8.0,
    "swap_wait": 6.0,
    "kv_transfer": 5.0,
    "compile": 3.0,
    "stall": 1.0,
    "none": 0.0,
}

# Affinity yields to load balance once the hit replica is this many
# requests deeper than the idlest active replica (roughly one scheduler
# batch).  Without the yield, every same-prefix request in a burst piles
# onto one replica while its peers idle — the saved prefill is real but
# the queue wait it buys dwarfs it.  With it, imbalance is bounded: a shared
# prefix still converges onto one replica, and only the overflow of a
# burst spills to the fallback ranking.
AFFINITY_LOAD_SLACK = 4.0


class ReplicaDigest:
    """Latest (resident, host) chain-hash populations for one replica.

    ``publish`` runs on the replica's driver thread; ``snapshot`` runs on
    the router's event loop.  Both go through ``_lock``, the one
    cross-thread handoff of the digest.
    """

    def __init__(self, replica: str) -> None:
        self.replica = replica
        self._lock = threading.Lock()
        self._resident: frozenset[bytes] = frozenset()
        self._host: frozenset[bytes] = frozenset()
        self._builds = 0
        self._build_seconds = 0.0

    def publish(self, resident: frozenset[bytes], host: frozenset[bytes],
                build_s: float = 0.0) -> None:
        with self._lock:
            self._resident = resident
            self._host = host
            self._builds += 1
            self._build_seconds += build_s

    def snapshot(self) -> tuple[frozenset[bytes], frozenset[bytes]]:
        with self._lock:
            return self._resident, self._host

    def payload(self) -> dict:
        with self._lock:
            return {
                "resident_pages": len(self._resident),
                "host_pages": len(self._host),
                "builds": self._builds,
                "build_seconds": round(self._build_seconds, 6),
            }


def score_prefix(hashes: list[bytes],
                 resident: frozenset[bytes],
                 host: frozenset[bytes]) -> tuple[int, int, float]:
    """Longest matchable prefix run of ``hashes`` against one digest.

    The run stops at the first page neither tier can serve — a later match
    is unusable because ``share`` only hands out consecutive runs from page
    0.  Returns (resident_pages, host_pages, score)."""
    res = hst = 0
    score = 0.0
    for h in hashes:
        if h in resident:
            res += 1
            score += RESIDENT_WEIGHT
        elif h in host:
            hst += 1
            score += HOST_WEIGHT
        else:
            break
    return res, hst, score


def weighted_load(load: float, limiter: str) -> float:
    """Least-loaded fallback key: raw queue depth plus the limiter's
    equivalent-queue penalty."""
    return load + LIMITER_PENALTY.get(limiter, 0.0)
