"""Low-overhead fast-path statistics: the substrate under the runtime's
hot-path observability.

The metrics registry (`ray_tpu_torch.util.metrics`) takes a lock per
observation — fine for user metrics, too heavy for paths PR 2 just
measured in microseconds (submit, wait, batcher flush). Stats here are
plain attribute/list increments under the GIL: a ``record()`` is two
integer adds and a float add, no lock, no allocation (the reference
keeps its equivalent fast-path stats in C++ thread-local OpenCensus
buffers for the same reason). Losing the occasional count to a data
race is acceptable for distributions; nothing here is load-bearing.

``collect_runtime_metrics()`` (``_private/runtime_metrics.py``) folds
these into the process metrics registry on every scrape, so they ride
the normal Prometheus exposition and — on cluster nodes — the metric
snapshots shipped to the head.

``ENABLED`` is the A/B kill switch: ``benchmarks/perf_bench.py
--ab-observability`` toggles it to prove the instrumentation tax on the
submit/wait hot paths stays under its budget.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

ENABLED = True

# Latency bounds (seconds): 100µs .. 2.5s, roughly x2.5 steps — the
# control plane lives in this range.
LATENCY_BOUNDS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
# Serve request bounds (seconds): requests legitimately run to
# result_timeout_s (60s) — the control-plane bounds above would clamp
# a degraded route's p95 at 2.5s, hiding exactly what the metric is
# for.
SERVE_LATENCY_BOUNDS = LATENCY_BOUNDS + (5.0, 10.0, 30.0, 60.0, 120.0)
# Size bounds (items): powers of two up to one max frame.
SIZE_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_registry_lock = threading.Lock()
_stats: Dict[Tuple[str, Tuple], "Dist | Counter"] = {}


def set_enabled(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


class Dist:
    """A value distribution over fixed buckets. ``record`` is lock-free
    (GIL-serialized increments); ``snapshot``/``quantile`` read a
    consistent-enough view for monitoring."""

    __slots__ = ("name", "tags", "bounds", "counts", "total", "sum")

    def __init__(self, name: str, tags: Tuple, bounds: Sequence[float]):
        self.name = name
        self.tags = tags
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        if not ENABLED:
            return
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += 1
        self.sum += value

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound quantile estimate (0 when empty)."""
        total = self.total
        if total <= 0:
            return 0.0
        target = q * total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1]
        return self.bounds[-1]

    def snapshot(self) -> dict:
        return {"kind": "dist", "bounds": list(self.bounds),
                "counts": list(self.counts), "count": self.total,
                "sum": self.sum}


class Counter:
    __slots__ = ("name", "tags", "value")

    def __init__(self, name: str, tags: Tuple):
        self.name = name
        self.tags = tags
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if ENABLED:
            self.value += n

    def snapshot(self) -> dict:
        return {"kind": "counter", "value": self.value}


def _norm_tags(tags: Optional[Dict[str, str]]) -> Tuple:
    if not tags:
        return ()
    return tuple(sorted(tags.items()))


def latency(name: str, tags: Optional[Dict[str, str]] = None) -> Dist:
    return _get(name, tags, lambda n, t: Dist(n, t, LATENCY_BOUNDS))


def dist(name: str, tags: Optional[Dict[str, str]] = None,
         bounds: Sequence[float] = SIZE_BOUNDS) -> Dist:
    return _get(name, tags, lambda n, t: Dist(n, t, bounds))


def counter(name: str, tags: Optional[Dict[str, str]] = None) -> Counter:
    return _get(name, tags, Counter)


def _get(name, tags, make):
    key = (name, _norm_tags(tags))
    stat = _stats.get(key)
    if stat is None:
        with _registry_lock:
            stat = _stats.get(key)
            if stat is None:
                stat = _stats[key] = make(name, key[1])
    return stat


def stats_items():
    """[(name, tags_tuple, stat)] — consumed by runtime_metrics."""
    with _registry_lock:
        return [(name, tags, stat)
                for (name, tags), stat in _stats.items()]


def reset() -> None:
    """Zero every stat IN PLACE (tests and the A/B bench). The hot
    paths hold module/instance references to their stat objects, so
    dropping registry entries would orphan them — recordings would keep
    landing in objects the exposition no longer sees."""
    with _registry_lock:
        for stat in _stats.values():
            if isinstance(stat, Dist):
                stat.counts = [0] * (len(stat.bounds) + 1)
                stat.total = 0
                stat.sum = 0.0
            else:
                stat.value = 0


def snapshot_records(name: str) -> dict:
    """Plain-data snapshot of every stat registered under ``name``:
    ``{tags_tuple: (counts_tuple, total, sum)}`` for dists,
    ``{tags_tuple: value}`` for counters. With :func:`restore_records`
    this is the reset-capable API around process-global records that
    tests (the ambient sanitizer, the conftest baseline fixture) use to
    guarantee one test's recordings never leak into the next."""
    out: dict = {}
    with _registry_lock:
        for (n, tags), stat in _stats.items():
            if n != name:
                continue
            if isinstance(stat, Dist):
                out[tags] = (tuple(stat.counts), stat.total, stat.sum)
            else:
                out[tags] = stat.value
    return out


def restore_records(name: str, snapshot: dict) -> None:
    """Restore ``name``'s stats to a :func:`snapshot_records` snapshot
    IN PLACE (same aliasing constraint as :func:`reset`). Tagged series
    created since the snapshot are zeroed — they cannot be deleted
    without orphaning live references, and zero is what the snapshot
    implies for them."""
    with _registry_lock:
        for (n, tags), stat in _stats.items():
            if n != name:
                continue
            saved = snapshot.get(tags)
            if isinstance(stat, Dist):
                if saved is None:
                    stat.counts = [0] * (len(stat.bounds) + 1)
                    stat.total = 0
                    stat.sum = 0.0
                else:
                    counts, total, total_sum = saved
                    stat.counts = list(counts)
                    stat.total = total
                    stat.sum = total_sum
            else:
                stat.value = 0 if saved is None else saved
