"""User-defined metrics: Counter / Gauge / Histogram.

Reference: `python/ray/util/metrics.py` → C++ OpenCensus pipeline. Here
metrics aggregate in a process-global registry with tag support and a
Prometheus-exposition dump (`export_prometheus`), which the dashboard/
metrics agent scrapes or writes out.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[name] = self

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def get(self, tags=None) -> float:
        return self._values.get(self._key(tags), 0.0)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)

    def get(self, tags=None) -> float:
        return self._values.get(self._key(tags), 0.0)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="",
                 boundaries: Sequence[float] = (), tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [
            0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def get(self, tags=None) -> dict:
        k = self._key(tags)
        return {"count": self._totals.get(k, 0),
                "sum": self._sums.get(k, 0.0),
                "buckets": list(self._counts.get(
                    k, [0] * (len(self.boundaries) + 1)))}


def reset_values() -> None:
    """Zero every registered metric's recorded values IN PLACE,
    keeping registrations (metrics are interned by name — dropping
    registry entries would orphan the instances call sites hold, so
    recordings would keep landing in objects the exposition no longer
    sees). The reset-capable API raylint R7 requires of process-global
    registries; tests use it to start from a clean exposition."""
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        with m._lock:
            for attr in ("_values", "_counts", "_sums", "_totals"):
                d = getattr(m, attr, None)
                if d is not None:
                    d.clear()


# Prometheus text exposition format 0.0.4 — scrape endpoints return
# this Content-Type per the exposition spec.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


def _fmt_tags(key: Tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def snapshot_registry() -> dict:
    """Plain-data snapshot of the whole registry — wire-encodable
    (str/float/list only), so cluster nodes ship it to the head's
    aggregator and the dashboard merges snapshots from every node into
    one exposition. Shape per metric::

        {name: {"kind", "description", "boundaries"?, "series": [...]}}

    Counter/gauge series entries are ``[tag_pairs, value]``; histogram
    entries are ``[tag_pairs, bucket_counts, sum, count]`` where
    ``tag_pairs`` is ``[[k, v], ...]`` sorted by key.
    """
    with _registry_lock:
        metrics = list(_registry.values())
    snap: dict = {}
    for m in metrics:
        entry: dict = {"kind": m.kind, "description": m.description}
        if isinstance(m, (Counter, Gauge)):
            with m._lock:
                entry["series"] = [
                    [[list(kv) for kv in k], v]
                    for k, v in m._values.items()]
        elif isinstance(m, Histogram):
            entry["boundaries"] = list(m.boundaries)
            with m._lock:
                entry["series"] = [
                    [[list(kv) for kv in k], list(counts),
                     m._sums.get(k, 0.0), m._totals.get(k, 0)]
                    for k, counts in m._counts.items()]
        else:
            entry["series"] = []
        snap[m.name] = entry
    return snap


def _render_series(lines: List[str], name: str, entry: dict,
                   extra_tags: Optional[dict]) -> None:
    extra = tuple(sorted((extra_tags or {}).items()))
    if entry["kind"] in ("counter", "gauge", "untyped"):
        for tag_pairs, v in entry.get("series", []):
            key = tuple(sorted(
                tuple(kv) for kv in list(tag_pairs) + [list(t) for t
                                                       in extra]))
            lines.append(f"{name}{_fmt_tags(key)} {v}")
        return
    boundaries = entry.get("boundaries", [])
    for tag_pairs, counts, total_sum, total in entry.get("series", []):
        base = {k: v for k, v in tag_pairs}
        base.update(dict(extra))
        acc = 0
        for b, c in zip(boundaries, counts):
            acc += c
            tags = dict(base)
            tags["le"] = str(b)
            lines.append(
                f"{name}_bucket{_fmt_tags(tuple(sorted(tags.items())))}"
                f" {acc}")
        tags = dict(base)
        tags["le"] = "+Inf"
        lines.append(
            f"{name}_bucket{_fmt_tags(tuple(sorted(tags.items())))}"
            f" {total}")
        key = tuple(sorted(base.items()))
        lines.append(f"{name}_sum{_fmt_tags(key)} {total_sum}")
        lines.append(f"{name}_count{_fmt_tags(key)} {total}")


def render_prometheus(snapshots) -> str:
    """Merge registry snapshots into one Prometheus text exposition.

    ``snapshots`` is ``[(snapshot, extra_tags_or_None), ...]`` — the
    dashboard passes the head's snapshot untagged plus one
    ``{"node": node_id}``-tagged snapshot per cluster node, so every
    node's series land under shared metric names with a ``node`` label
    distinguishing them. HELP/TYPE headers are emitted once per name.
    """
    by_name: "dict[str, list]" = {}
    order: List[str] = []
    for snap, extra in snapshots:
        for name, entry in snap.items():
            if name not in by_name:
                by_name[name] = []
                order.append(name)
            by_name[name].append((entry, extra))
    lines: List[str] = []
    for name in order:
        entries = by_name[name]
        lines.append(f"# HELP {name} {entries[0][0]['description']}")
        lines.append(f"# TYPE {name} {entries[0][0]['kind']}")
        for entry, extra in entries:
            _render_series(lines, name, entry, extra)
    return "\n".join(lines) + "\n"


def export_prometheus() -> str:
    """Prometheus text exposition of every registered metric (canonical
    runtime gauges refreshed first — `_private/runtime_metrics.py`)."""
    try:
        from ray_tpu_torch._private.runtime_metrics import (
            collect_runtime_metrics,
        )

        collect_runtime_metrics()
    except Exception:  # noqa: BLE001 — user metrics still export
        pass
    return render_prometheus([(snapshot_registry(), None)])
