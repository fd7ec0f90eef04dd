"""Task event buffer: the observability substrate.

Role-equivalent to the reference's `TaskEventBuffer`
(`core_worker/task_event_buffer.h:188`) feeding GcsTaskManager: every task
execution records state transitions + timing here; the state API
(`ray_tpu_torch.experimental.state`) queries it and `ray_tpu_torch.timeline()` dumps
Chrome traces from it (reference `_private/state.py:435`).

Cluster mode: worker-node buffers ship their deltas to the head's
aggregator (`_private/obs_plane.py`) so timeline/tracing/state views are
cluster-wide. Shipping drains ``drain_updates`` — a bounded dirty set,
not a full-buffer scan — off the execution hot path.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.task_spec import trace_id_of as _trace_id_of


@dataclass
class TaskEvent:
    task_id: str
    name: str
    kind: str            # NORMAL_TASK | ACTOR_CREATION | ACTOR_TASK
    state: str           # RUNNING | FINISHED | FAILED
    start_s: float = 0.0
    end_s: Optional[float] = None
    node_id: str = ""
    worker: str = ""
    error: str = ""
    actor_id: Optional[str] = None
    # Span linkage: the task's own id is its span id.
    trace_id: str = ""
    parent_span_id: str = ""
    # Job/tenant tag carried by the spec ("" = untagged): the per-job
    # attribution key for state.job_summary(), the job-tagged metric
    # series, and timeline filtering.
    job_id: str = ""

    def duration_s(self) -> Optional[float]:
        if self.end_s is None:
            return None
        return self.end_s - self.start_s

    def to_dict(self) -> Dict[str, Any]:
        """Wire-friendly plain dict (str/float/None only — no pickle
        needed on the shipping channel)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TaskEvent":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def chrome_trace_events(events) -> List[dict]:
    """Chrome tracing format (`chrome://tracing` / Perfetto) for any
    event iterable — the buffer's own dump and the head's cluster-wide
    ``timeline()`` share this formatter."""
    out = []
    now = time.time()
    for ev in events:
        end = ev.end_s or now
        out.append({
            "name": ev.name,
            "cat": ev.kind.lower(),
            "ph": "X",
            "ts": ev.start_s * 1e6,
            "dur": (end - ev.start_s) * 1e6,
            "pid": ev.node_id[:8],
            "tid": ev.worker,
            "args": {"task_id": ev.task_id, "state": ev.state,
                     **({"job": ev.job_id} if ev.job_id else {}),
                     **({"error": ev.error} if ev.error else {})},
        })
    return out


class TaskEventBuffer:
    def __init__(self, max_events: int = 100_000):
        self._lock = threading.Lock()
        self._events: "collections.OrderedDict[str, TaskEvent]" = \
            collections.OrderedDict()
        self._max = max_events
        # task_ids updated since the last drain — THE shipping cursor
        # (drain_updates consumes it; a finish re-marks its task so the
        # terminal state ships too); bounded by _max through the same
        # eviction sweep.
        self._dirty: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        # Bumped on every insert/update: a cheap change fingerprint so
        # per-scrape aggregations (the job-metric fold) can skip their
        # full-buffer walk when nothing moved between scrapes.
        self._mutations = 0

    @property
    def capacity(self) -> int:
        return self._max

    @property
    def mutation_seq(self) -> int:
        return self._mutations

    def task_started(self, spec, node_id, worker_name: str) -> None:
        ev = TaskEvent(
            task_id=spec.task_id.hex(), name=spec.name,
            kind=spec.kind.name, state="RUNNING",
            start_s=time.time(), node_id=node_id.hex(),
            worker=worker_name,
            actor_id=spec.actor_id.hex() if spec.actor_id else None,
            trace_id=_trace_id_of(spec),
            parent_span_id=(spec.trace_parent[1] if spec.trace_parent
                            else ""),
            job_id=spec.job_id or "")
        with self._lock:
            self._mutations += 1
            self._events[ev.task_id] = ev
            self._dirty[ev.task_id] = None
            while len(self._events) > self._max:
                evicted, _ = self._events.popitem(last=False)
                self._dirty.pop(evicted, None)

    def task_finished(self, spec, error: Optional[str] = None) -> None:
        with self._lock:
            ev = self._events.get(spec.task_id.hex())
            if ev is None:
                return
            self._mutations += 1
            ev.end_s = time.time()
            ev.state = "FAILED" if error else "FINISHED"
            ev.error = error or ""
            self._dirty[ev.task_id] = None

    def record_event(self, ev: TaskEvent) -> None:
        """Insert a fully-formed event (runtime incidents that are not a
        task execution — e.g. the memory monitor's worker-kill
        decisions — use this so they show up in timeline()/state views
        and ship to the head like any task event)."""
        with self._lock:
            self._mutations += 1
            self._events[ev.task_id] = ev
            self._dirty[ev.task_id] = None
            while len(self._events) > self._max:
                evicted, _ = self._events.popitem(last=False)
                self._dirty.pop(evicted, None)

    def list_events(self, limit: int = 10_000) -> List[TaskEvent]:
        with self._lock:
            return list(self._events.values())[-limit:]

    def snapshot(self, limit: Optional[int] = None) -> List[TaskEvent]:
        """The public full-buffer view: every recorded event (or the
        most recent ``limit``), oldest first. Exporters that must not
        truncate (span export would drop trace roots out from under
        their children) use this instead of reaching into the buffer's
        internals."""
        with self._lock:
            events = list(self._events.values())
        return events if limit is None else events[-limit:]

    def drain_updates(self, limit: int = 2000) -> List[Dict[str, Any]]:
        """Up to ``limit`` event dicts updated since the previous drain
        (the node→head shipping delta). Bounded: anything beyond the
        limit stays dirty for the next cycle, so one burst can never
        produce an unbounded frame."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            while self._dirty and len(out) < limit:
                task_id, _ = self._dirty.popitem(last=False)
                ev = self._events.get(task_id)
                if ev is not None:
                    out.append(ev.to_dict())
        return out

    def remark_dirty(self, task_ids) -> None:
        """Put drained task ids back on the shipping cursor (the
        shipper's RPC failed AFTER the drain — without this, events
        completed in that window would silently never reach the head)."""
        with self._lock:
            for task_id in task_ids:
                if task_id in self._events:
                    self._dirty[task_id] = None

    def dirty_count(self) -> int:
        with self._lock:
            return len(self._dirty)

    def chrome_trace(self) -> List[dict]:
        """Chrome tracing format (`chrome://tracing` / Perfetto)."""
        return chrome_trace_events(self.snapshot())
