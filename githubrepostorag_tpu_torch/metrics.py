"""The retrieval slice's metric series; port of the matching part of
``githubrepostorag_tpu/metrics.py`` on the standard library.

The JAX package registers these with ``prometheus_client``.  Nothing
records that the card's machine has that package, so the port keeps its
own ``Counter`` / ``Gauge`` / ``Histogram`` with the same ``labels(**kw)``,
``inc`` / ``set`` / ``observe`` surface, and the series keep the JAX
package's names, label names and help text.  ``counter_value`` and
``histogram_stats`` read them back (tests, the health report, the chip
script).  The ``/metrics`` exposition comes with the observability slice
(ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import bisect
import threading

class _Value:
    """One labelled child: a float under the metric's lock."""

    __slots__ = ("_metric", "value")

    def __init__(self, metric: "_Metric") -> None:
        self._metric = metric
        self.value = 0.0


class _CounterChild(_Value):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._metric._lock:
            self.value += amount


class _GaugeChild(_Value):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._metric._lock:
            self.value = float(value)


class _HistogramChild:
    __slots__ = ("_metric", "counts", "sum", "count")

    def __init__(self, metric: "Histogram") -> None:
        self._metric = metric
        self.counts = [0] * (len(metric.buckets) + 1)  # the last is +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._metric.buckets, value)
        with self._metric._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


class _Metric:
    _child = _Value

    def __init__(self, name: str, documentation: str, labelnames=()) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != {list(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child(self)
        return child

    def children(self, **labels) -> list:
        """Every child whose labels include ``labels``."""
        want = {k: str(v) for k, v in labels.items()}
        with self._lock:
            items = list(self._children.items())
        return [c for key, c in items
                if all(dict(zip(self.labelnames, key)).get(k) == v for k, v in want.items())]

class Counter(_Metric):
    _child = _CounterChild


class Gauge(_Metric):
    _child = _GaugeChild


class Histogram(_Metric):
    """Bucket counts (upper bounds ``buckets``, then +Inf), sum and count.
    The retrieval histograms carry no labels: ``observe`` on the metric."""

    _child = _HistogramChild

    def __init__(self, name: str, documentation: str, buckets, labelnames=()) -> None:
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(name, documentation, labelnames)

    def observe(self, value: float) -> None:
        self.labels().observe(value)


def counter_value(metric: _Metric, **labels) -> float:
    """A Counter's or Gauge's value summed over every label set that
    includes ``labels`` (a partial label set aggregates the rest)."""
    return sum(c.value for c in metric.children(**labels))


def histogram_stats(metric: Histogram, **labels) -> dict:
    """``{"count", "sum"}`` of a Histogram over the matching label sets."""
    kids = metric.children(**labels)
    return {"count": sum(c.count for c in kids), "sum": sum(c.sum for c in kids)}


RETRIEVAL_SECONDS = Histogram(
    "rag_retrieval_seconds",
    "Per-request retrieval latency through the coalescer (queue + encode + search)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
)
RETRIEVAL_WAVE_SIZE = Histogram(
    "rag_retrieval_wave_size",
    "Queries coalesced into one encoder forward + search dispatch",
    buckets=(1, 2, 4, 8, 16, 32),
)
DEVICE_INDEX_SEARCHES = Counter(
    "rag_device_index_searches_total",
    "Vector searches by execution path (device = fused on-accelerator top-k, "
    "fallback = host store outside the warmed bucket contract)",
    ["path"],
)
# --- Live device index (ingest/stream.py + retrieval/live_index.py +
# retrieval/device_index.py): fragmentation gauges the background
# compactor triggers on, watermark/lag gauges the apply loop publishes,
# and the full-sync counter tests pin at zero on the churn hot path.
INDEX_LIVE_ROWS = Gauge(
    "rag_index_live_rows",
    "Live (non-tombstoned) rows mirrored per device-index table",
    ["table"],
)
INDEX_HOLES = Gauge(
    "rag_index_tombstoned_holes",
    "Tombstoned hole rows awaiting compaction per device-index table",
    ["table"],
)
INDEX_CAPACITY = Gauge(
    "rag_index_capacity_rows",
    "Allocated capacity-bucket rows per device-index table",
    ["table"],
)
INDEX_COMPACTIONS = Counter(
    "rag_index_compactions_total",
    "In-place hole-reclaim compactions per device-index table "
    "(warmed gather repack, same capacity bucket)",
    ["table"],
)
INDEX_FULL_SYNCS = Counter(
    "rag_index_full_syncs_total",
    "Whole-table transpose re-puts of a device-index corpus (initial "
    "seeding and capacity growth; must NOT happen on the churn hot path)",
    ["table"],
)
INDEX_WATERMARK = Gauge(
    "rag_index_watermark",
    "Mutation-stream watermark by scope: kind=appended is the producers' "
    "log head, kind=applied is the seq the live index has absorbed",
    ["scope", "kind"],
)
INDEX_APPLY_LAG = Gauge(
    "rag_index_apply_lag_ops",
    "Appended-minus-applied mutation ops per scope (stream backlog)",
    ["scope"],
)
INDEX_OPS_APPLIED = Counter(
    "rag_index_ops_applied_total",
    "Mutation ops the live-index apply loop drained into the store",
    ["table", "kind"],
)
