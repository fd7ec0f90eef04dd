"""Structured cluster events.

Reference: `src/ray/util/event.h` + the dashboard event module — notable
state transitions (node up/down, autoscaling decisions, serve deploys,
job state changes) land in a bounded in-memory buffer the dashboard and
state API serve, so "what happened to the cluster" has one answer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_BUFFER_MAX = 2000
_lock = threading.Lock()
_events: "deque[Dict[str, Any]]" = deque(maxlen=_BUFFER_MAX)
_counter = [0]
# Cluster-node processes forward events to the HEAD's buffer (which the
# dashboard and gcs_events serve) — a process-local buffer on a worker
# node is invisible to observers. Set by NodeRuntime at bring-up.
_forwarder = [None]


def set_forwarder(fn) -> None:
    _forwarder[0] = fn


def record_event(source: str, message: str, *,
                 severity: str = "INFO", **metadata) -> None:
    """Append one event (and forward to the head when this process is a
    cluster node); never raises — observability must not break the path
    it observes."""
    try:
        with _lock:
            _counter[0] += 1
            _events.append({
                "event_id": _counter[0],
                "timestamp": time.time(),
                "source": source,
                "severity": severity,
                "message": message,
                **({"metadata": metadata} if metadata else {}),
            })
        fwd = _forwarder[0]
        if fwd is not None:
            fwd(source=source, message=message, severity=severity,
                metadata=metadata or None)
    except Exception:
        pass


def list_events(limit: int = 200,
                source: Optional[str] = None) -> List[Dict[str, Any]]:
    with _lock:
        items = list(_events)
    if source is not None:
        items = [e for e in items if e["source"] == source]
    return items[-limit:]


def clear_events() -> None:
    with _lock:
        _events.clear()
