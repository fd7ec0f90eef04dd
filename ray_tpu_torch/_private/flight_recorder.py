"""Flight recorder: bounded rings of recent activity, frozen on
degradation into one correlated post-mortem snapshot.

A burn-rate alert tells the operator a route degraded; by the time a
human looks, the queue drained and the evidence is gone. Every process
therefore keeps cheap bounded ring buffers of what just happened:

- **span ring** — recent stage spans (fed by
  ``critical_path.record_stage``: one deque append on the hot path),
- **sample ring** — periodic health samples (queue depths, SLO burn,
  memory pressure, loop lag; fed by ``collect_health_metrics`` at
  scrape/ship cadence).

When ``evaluate_health()`` flips this process ok→degraded (or an
operator hits ``/api/debug/dump``), the head freezes the moment: its
own rings, every live node's rings (a ``flight_snapshot`` RPC — nodes
answer from their deques, no recomputation), the health verdict and
reasons that triggered it, and the slowest in-flight request
waterfalls from the critical-path engine. The correlated snapshot is
written as one ``FLIGHT_<ts>.json`` under ``flight_recorder_dir``.

Auto-dump gates on ``flight_recorder_dir`` being set (default "" — a
test suite flipping verdicts must not litter the filesystem) and
debounces by ``flight_min_interval_s`` so a flapping verdict costs one
dump per window, not one per healthz poll.

Layering: imports config/worker plumbing only; ``critical_path`` is
imported lazily at snapshot time (it imports this module at top level
for the hot-path ring feed).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import ray_config

ENABLED = True

# Physical ring capacity. ``flight_ring_size`` (the shipped-snapshot
# bound) is read at freeze time so config changes apply live; the
# backing deques are sized once at the table's ceiling.
_RING_CAP = 2048

_spans: "deque[dict]" = deque(maxlen=_RING_CAP)
_samples: "deque[dict]" = deque(maxlen=_RING_CAP)

_lock = threading.Lock()
# ok→degraded edge detection + debounce for the auto-dump.
_last_status: Optional[str] = None
_last_dump_ts: float = 0.0
_dump_count: int = 0


def set_enabled(on: bool) -> None:
    """A/B kill switch (rides the same ``--ab-observability`` leg as
    the critical-path engine)."""
    global ENABLED
    ENABLED = bool(on)


def note_span(rec) -> None:
    """Hot path: one GIL-atomic bounded append. ``rec`` is the
    critical-path record tuple ``(t, trace_id, stage, dur_s, route)``
    (dicts from older callers pass through); the dict shape is built
    at freeze time, not per span."""
    if ENABLED:
        _spans.append(rec)


def _span_dict(rec) -> dict:
    if isinstance(rec, tuple):
        t, trace_id, stage, dur_s, route = rec
        return {"t": t, "trace_id": trace_id, "stage": stage,
                "dur_s": dur_s, "route": route}
    return rec


def note_sample(kind: str, data: Dict[str, Any]) -> None:
    """Scrape-cadence path: queue depths, burn rates, pressure."""
    if ENABLED:
        _samples.append({"kind": kind, "t": time.time(), **data})


def local_snapshot() -> dict:
    """Freeze this process's rings (plus its in-flight slow-request
    waterfalls) into plain data — the ``flight_snapshot`` RPC answer
    and the head's own contribution to a dump."""
    from ray_tpu_torch._private import critical_path

    critical_path.flush()  # ring is fed at fold time, not append time
    n = max(1, int(ray_config.flight_ring_size))
    spans = [_span_dict(r) for r in list(_spans)[-n:]]
    samples = list(_samples)[-n:]
    try:
        slow = critical_path.slow_requests(10, include_inflight=True)
    except Exception:
        slow = []
    return {"pid": os.getpid(), "ts": time.time(),
            "spans": spans, "samples": samples,
            "slow_requests": slow}


def _collect_node_rings(worker) -> Dict[str, dict]:
    """Per-node rings: the head's own, plus a ``flight_snapshot`` RPC
    to every live registered node. A node that fails to answer gets an
    error marker instead of poisoning the dump — a post-mortem of a
    degraded cluster must tolerate degraded nodes."""
    rings: Dict[str, dict] = {}
    local_id = getattr(worker, "node_id", None) or "head"
    rings[str(local_id)] = local_snapshot()
    head = getattr(worker, "cluster_head", None)
    if head is None:
        return rings
    raise NotImplementedError(
        "cluster mode is not ported (ROADMAP Queue 1: cluster modes)")


def dump(trigger: str, worker=None, verdict: Optional[dict] = None,
         out_dir: Optional[str] = None,
         write: Optional[bool] = None) -> dict:
    """Produce one correlated flight snapshot. Returns the payload
    (plus ``"path"`` when written). ``write`` defaults to "dir is
    configured"; ``/api/debug/dump`` passes the payload inline either
    way."""
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = worker or global_worker_or_none()
    payload: Dict[str, Any] = {
        "trigger": trigger,
        "ts": time.time(),
        "verdict": (verdict or {}).get("status", "unknown"),
        "reasons": list((verdict or {}).get("reasons") or ()),
        "nodes": _collect_node_rings(w) if w is not None
        else {"head": local_snapshot()},
    }
    # The head-wide slowest waterfalls (its critical-path engine sees
    # every proxied request plus shipped node stages) sit at top level
    # so the first page of the dump names the dominant stages.
    from ray_tpu_torch._private import critical_path

    try:
        payload["slow_requests"] = critical_path.slow_requests(
            10, include_inflight=True)
    except Exception:
        payload["slow_requests"] = []
    directory = out_dir if out_dir is not None \
        else ray_config.flight_recorder_dir
    should_write = bool(directory) if write is None else write
    if should_write and directory:
        global _dump_count
        with _lock:
            _dump_count += 1
            seq = _dump_count
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory, f"FLIGHT_{int(payload['ts'])}_{seq}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        payload["path"] = path
    return payload


def observe_verdict(verdict: dict, worker=None) -> Optional[dict]:
    """Edge-triggered auto-dump hook: ``evaluate_health`` calls this
    with every computed verdict. On the ok→degraded transition — with
    a dump directory configured and the debounce window elapsed — the
    moment is frozen to disk. Returns the dump payload when one was
    produced (tests key off it), else None."""
    global _last_status, _last_dump_ts
    if not ENABLED:
        return None
    status = verdict.get("status")
    with _lock:
        prev = _last_status
        _last_status = status
        if status != "degraded" or prev == "degraded":
            return None
        if not ray_config.flight_recorder_dir:
            return None
        now = time.time()
        if now - _last_dump_ts < ray_config.flight_min_interval_s:
            return None
        _last_dump_ts = now
    try:
        return dump("degraded", worker=worker, verdict=verdict)
    except Exception:
        return None  # the post-mortem must never break healthz


# -- test isolation -----------------------------------------------------------


def snapshot_state() -> dict:
    """Plain-data snapshot (IN PLACE restore contract — hot paths
    alias the module deques) for the conftest baseline fixture."""
    with _lock:
        return {"enabled": ENABLED, "spans": list(_spans),
                "samples": list(_samples), "last_status": _last_status,
                "last_dump_ts": _last_dump_ts,
                "dump_count": _dump_count}


def restore_state(snapshot: dict) -> None:
    global ENABLED, _last_status, _last_dump_ts, _dump_count
    with _lock:
        ENABLED = snapshot.get("enabled", True)
        _spans.clear()
        _spans.extend(snapshot.get("spans", ()))
        _samples.clear()
        _samples.extend(snapshot.get("samples", ()))
        _last_status = snapshot.get("last_status")
        _last_dump_ts = snapshot.get("last_dump_ts", 0.0)
        _dump_count = snapshot.get("dump_count", 0)


def reset() -> None:
    restore_state({"enabled": True})
