"""Critical-path attribution: where did a request's wall time go?

The trace plane (PR 3) can show *that* a request crossed the proxy, a
router, a replica, and an LLM engine; the SLO plane (PR 6/15) can show
*that* a route is slow. Neither can answer the operator's actual
question — *which stage* made THIS request slow — and that attribution
is the measured input every adaptive control-loop decision (ROADMAP
item 4) needs.

This module is the pure core. Hot paths call :func:`record_stage` —
ONE scalar-tuple append to a bounded deque, nothing else — at every
seam a request crosses (proxy dispatch, router assign, replica-direct
acquire, replica execute, LLM admit/kv-lookup/prefill/first-token/
decode, scheduler queue, object-plane pull/spill/restore). Everything
downstream of that append (trace accumulation, histogram folds,
exemplar upkeep, the flight ring, the ship queue) happens in
:func:`flush`, driven by a process-lifetime folder thread at ~100 ms
cadence and synchronously by every reader. The deferral is the whole
performance story: on a serial request path every instruction between
"replica produced the result" and "client read the response" is paid
at GIL-scheduling granularity, so 20 µs of inline folding measured as
~70 µs of added latency — while an append costs ~0.15 µs and the fold
runs when the loop would otherwise be idle. The proxy's request
envelope calls :func:`finish_request` once per request, which (at
fold time):

- attributes the request's wall time to its recorded stages (the
  remainder is folded as the ``unattributed`` stage, so the vector
  always sums to the measured total),
- folds each stage duration into the
  ``request_stage_seconds{route,stage}`` fast-path distribution —
  exported as ``ray_tpu_request_stage_seconds_p50/_p99`` per
  (route, stage) by ``runtime_metrics``, the per-route *attribution
  vector*,
- pins an exemplar trace-id to the slowest observation per histogram
  bucket (the Prometheus-exemplar idea, JSON-shaped), and
- retains a bounded waterfall for ``/api/slow_requests`` and the CLI
  ``ray_tpu_torch slow``.

Stage records born on worker nodes ride the existing obs shipper
(``drain_records`` → ``obs_report(stages=...)`` → :func:`ingest`), so
the head folds cluster-wide attribution — replica/engine stages land
seconds after the proxy already finished the request, which is why
late arrivals for a finished trace fold immediately against the
route the finish recorded.

Layering: imports only peer ``_private`` modules (perf_stats,
flight_recorder); never serve.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import flight_recorder, perf_stats
from ray_tpu_torch._private.config import ray_config

ENABLED = True


def _on() -> bool:
    return ENABLED and ray_config.stage_spans_enabled

# Bounded process-global state. Aliasing contract matches perf_stats:
# hot paths reference the module, tests snapshot/restore IN PLACE.
MAX_TRACES = 2048          # in-flight trace accumulators
MAX_STAGES_PER_TRACE = 64  # a runaway decode loop can't grow one trace
MAX_FINISHED = 256         # retained waterfalls for slow_requests
MAX_PENDING = 8192         # node-side records awaiting shipping

STAGE_METRIC = "request_stage_seconds"

# Attribution floor: spans shorter than this are noise at SLO scale
# (they cannot be dominant, and the tiling contract charges their time
# to ``unattributed`` regardless) — dropping them at the record site
# is the single biggest term in the recorder's fast-route overhead.
MIN_SPAN_S = 5e-5

# A record is the tuple (t, trace_id, stage, dur_s, route); the dict
# shape only exists at the edges (the obs-ship wire format, snapshots).
# A finish marker is the 6-tuple (t, trace_id, status, total_s, route,
# None) — length is the dispatch tag.
_T, _TRACE, _STAGE, _DUR, _ROUTE = range(5)

# Raw hot-path appends awaiting a fold. Sized for several fold periods
# at full serve throughput; sustained overflow drops oldest (bounded
# memory beats bounded truth for a diagnostics plane).
MAX_RAW = 65536
_raw: "deque[tuple]" = deque(maxlen=MAX_RAW)

_FOLD_PERIOD_S = 0.1
_folder_started = False
_folder_lock = threading.Lock()

_lock = threading.Lock()
# trace_id -> [stages[(stage, dur_s)], route, t0]
_traces: "OrderedDict[str, list]" = OrderedDict()
# finished waterfalls, oldest-first ("stages" holds (stage, dur) pairs)
_finished: "deque[dict]" = deque(maxlen=MAX_FINISHED)
# trace_id -> route for finished traces: late-arriving node records
# (shipped after the proxy closed the request) still fold.
_finished_routes: "OrderedDict[str, str]" = OrderedDict()
# record tuples awaiting the obs shipper. Only processes that actually
# ship (a NodeObsShipper exists) pay the append: the head folds its own
# records in place and would otherwise queue 8192 tuples for nobody.
SHIPPING = False
_pending: "deque[tuple]" = deque(maxlen=MAX_PENDING)
# (route, stage) -> {bucket_index: (dur_s, trace_id)} — slowest
# observation per histogram bucket.
_exemplars: Dict[Tuple[str, str], Dict[int, Tuple[float, str]]] = {}
# (route, stage) -> interned Dist. perf_stats mutates interned stats in
# place (never replaces them), so caching skips the sorted-tuple key
# build + registry probe on every finish_request fold.
_dist_cache: Dict[Tuple[str, str], perf_stats.Dist] = {}


def set_enabled(on: bool) -> None:
    """A/B kill switch (``perf_bench.py --ab-observability`` flips it
    to prove the stage-span tax on the serve keep-alive path)."""
    global ENABLED
    ENABLED = bool(on)


def enabled() -> bool:
    """Public gate for call sites whose *argument computation* has a
    cost (ambient trace lookup, task-spec trace extraction) — skip it
    entirely when the recorder is off."""
    return _on()


def set_shipping(on: bool) -> None:
    """Mark this process as one whose records are drained by an obs
    shipper (worker nodes). Off — the default, and the head's state —
    ``record_stage`` skips the pending queue entirely."""
    global SHIPPING
    SHIPPING = bool(on)


# Lazily-bound (circular-import-safe) collaborators of
# ambient_trace_id: resolved once, not per request — the sys.modules
# probes of a per-call import are measurable on the serve fast path.
_ambient_fns: Optional[tuple] = None


def ambient_trace_id() -> Optional[str]:
    """Trace id of the currently executing task (None outside one) —
    what in-task stage sites (replica execute, LLM engine, object
    plane) attribute their work to. Cheap: two dict lookups when a
    task context exists."""
    global _ambient_fns
    try:
        if _ambient_fns is None:
            from ray_tpu_torch._private.task_spec import trace_id_of
            from ray_tpu_torch._private.worker import global_worker_or_none
            _ambient_fns = (trace_id_of, global_worker_or_none)
        trace_id_of, global_worker_or_none = _ambient_fns

        w = global_worker_or_none()
        if w is None:
            return None
        ctx = w.task_context.current()
        if ctx is None:
            return None
        return trace_id_of(ctx["task_spec"])
    except Exception:
        return None


def _stage_dist(route: str, stage: str) -> perf_stats.Dist:
    key = (route, stage)
    d = _dist_cache.get(key)
    if d is None:
        d = perf_stats.dist(STAGE_METRIC,
                            {"route": route, "stage": stage},
                            bounds=perf_stats.SERVE_LATENCY_BOUNDS)
        _dist_cache[key] = d
    return d


# Exemplar floor: an exemplar exists so the operator can drill from a
# SLOW histogram bucket into one concrete trace. Observations below
# this land in buckets nobody ever drills into, and their upkeep
# (bisect + dict probe per stage per finish) would dominate the fold
# cost on fast routes.
_EXEMPLAR_MIN_S = 0.005


def _fold(route: str, stage: str, dur_s: float, trace_id: str) -> None:
    """One stage observation into the attribution vector + exemplars.
    Callers hold ``_lock`` (exemplar upkeep mutates a shared dict)."""
    _stage_dist(route, stage).record(dur_s)
    if dur_s < _EXEMPLAR_MIN_S:
        return
    idx = bisect.bisect_left(perf_stats.SERVE_LATENCY_BOUNDS, dur_s)
    bucket = _exemplars.setdefault((route, stage), {})
    cur = bucket.get(idx)
    if cur is None or dur_s > cur[0]:
        bucket[idx] = (dur_s, trace_id)


def record_stage(trace_id: Optional[str], stage: str, dur_s: float,
                 route: str = "") -> None:
    """Attribute ``dur_s`` seconds of ``stage`` work to ``trace_id``.

    Hot-path cost: one scalar-tuple append (GIL-atomic, no lock) —
    folding is deferred to :func:`flush`. Records without a trace id
    (object-plane work running outside any request) still reach the
    flight ring at fold time — they are real cluster activity the
    post-mortem wants — but never the attribution vectors.

    Spans under :data:`MIN_SPAN_S` are dropped at the door: a stage
    that took tens of microseconds can never be the answer to "which
    stage made this request slow", it folds into ``unattributed`` by
    the tiling contract anyway, and recording it costs exactly as much
    as recording a meaningful one — on a fast route the floor drops
    most of the per-request records."""
    if not _on() or dur_s < MIN_SPAN_S:
        return
    _raw.append((time.time(), trace_id or "", stage, float(dur_s),
                 route))
    if not _folder_started:
        _ensure_folder()


def finish_request(trace_id: Optional[str], route: str, status: str,
                   total_s: float) -> None:
    """Close a request: at fold time its stage vector (plus the
    unattributed remainder) lands in
    ``request_stage_seconds{route,stage}`` and the waterfall is
    retained. Called from the proxy's request envelope once per
    request — same one-append hot path as :func:`record_stage`."""
    if not _on() or not trace_id:
        return
    _raw.append((time.time(), trace_id, status, float(total_s), route,
                 None))
    if not _folder_started:
        _ensure_folder()


def _ensure_folder() -> None:
    """Start the process-lifetime folder thread (idempotent). It owns
    the fold cadence so no request ever pays for folding; readers
    still :func:`flush` synchronously for deterministic answers."""
    global _folder_started
    with _folder_lock:
        if _folder_started:
            return
        t = threading.Thread(target=_folder_loop, daemon=True,
                             name="critical-path-folder")
        t.start()
        _folder_started = True


def _folder_loop() -> None:
    while True:
        time.sleep(_FOLD_PERIOD_S)
        try:
            # Fold in small slices with a real sleep between them: one
            # monolithic fold of a period's backlog holds the GIL for
            # milliseconds at a stretch, and on a serial request path
            # that burst reads as added latency — the exact
            # amplification the deferral exists to remove. Sliced, the
            # folder's cost converges to its true CPU share.
            while flush(_FOLD_SLICE) == _FOLD_SLICE:
                time.sleep(0.002)
        except Exception:
            pass  # diagnostics must never take the process down


# Records folded per GIL slice in the folder thread. ~200 folds cost
# well under a millisecond; the 2ms yield between slices lets every
# in-flight request proceed before the next slice.
_FOLD_SLICE = 200


def flush(max_n: Optional[int] = None) -> int:
    """Drain raw hot-path appends into the folded state (traces, the
    flight ring, histograms, exemplars, retained waterfalls, the ship
    queue); returns the number of records folded. Idempotent and
    multi-thread safe: popleft is GIL-atomic so the folder thread and
    a concurrent reader each fold a record at most once. Readers call
    it unbounded for deterministic answers; the folder thread passes
    ``max_n`` to bound each GIL slice."""
    n = 0
    while max_n is None or n < max_n:
        try:
            rec = _raw.popleft()
        except IndexError:
            break
        if len(rec) == 5:
            _fold_span(rec)
        else:
            _fold_finish(rec)
        n += 1
    return n


def _fold_span(rec: tuple) -> None:
    trace_id = rec[_TRACE]
    flight_recorder.note_span(rec)
    if not trace_id:
        return
    if SHIPPING:
        _pending.append(rec)
    stage = rec[_STAGE]
    tr = _traces.get(trace_id)
    if tr is None:
        route_done = _finished_routes.get(trace_id)
        if route_done is not None:
            # Late arrival (node record shipped — or locally folded —
            # after the request closed): fold against the finished
            # route now.
            with _lock:
                _fold(route_done, stage, rec[_DUR], trace_id)
            return
        tr = _traces.setdefault(trace_id, [[], rec[_ROUTE], rec[_T]])
        if len(_traces) > MAX_TRACES:
            with _lock:
                while len(_traces) > MAX_TRACES:
                    _traces.popitem(last=False)
    if rec[_ROUTE] and not tr[1]:
        tr[1] = rec[_ROUTE]
    if len(tr[0]) < MAX_STAGES_PER_TRACE:
        tr[0].append((stage, rec[_DUR]))


def _fold_finish(rec: tuple) -> None:
    t, trace_id, status, total_s, route = rec[:5]
    with _lock:
        tr = _traces.pop(trace_id, None)
        stages = tr[0] if tr else []
        agg: Dict[str, float] = {}
        for stage, dur in stages:
            agg[stage] = agg.get(stage, 0.0) + dur
        for stage, dur in agg.items():
            _fold(route, stage, dur, trace_id)
        unattributed = max(0.0, total_s - sum(agg.values()))
        _fold(route, "unattributed", unattributed, trace_id)
        agg["unattributed"] = unattributed
        dominant = max(agg.items(), key=lambda kv: kv[1])[0]
        _finished.append({
            "trace_id": trace_id, "route": route, "status": status,
            "total_s": total_s, "dominant_stage": dominant,
            "unattributed_s": unattributed, "ts": t,
            "stages": stages,
        })
        _finished_routes[trace_id] = route
        while len(_finished_routes) > MAX_TRACES:
            _finished_routes.popitem(last=False)


def ingest(records: Optional[List[dict]]) -> None:
    """Head-side fold of node-shipped stage records (the
    ``obs_report(stages=...)`` path). Same accumulation as a local
    :func:`record_stage`, minus re-shipping and re-ringing — the
    origin node already ringed them."""
    if not _on() or not records:
        return
    for rec in records:
        try:
            trace_id = rec["trace_id"]
            stage = rec["stage"]
            dur_s = float(rec["dur_s"])
            route = rec.get("route") or ""
        except (KeyError, TypeError, ValueError):
            continue  # malformed entry must not poison the frame
        if not trace_id:
            continue
        tr = _traces.get(trace_id)
        if tr is None:
            route_done = _finished_routes.get(trace_id)
            if route_done is not None:
                with _lock:
                    _fold(route_done, stage, dur_s, trace_id)
                continue
            tr = _traces.setdefault(
                trace_id, [[], route, rec.get("t") or time.time()])
        if route and not tr[1]:
            tr[1] = route
        if len(tr[0]) < MAX_STAGES_PER_TRACE:
            tr[0].append((stage, dur_s))


def _wire(rec: tuple) -> dict:
    """Record tuple -> the obs-ship wire shape :func:`ingest` reads."""
    return {"trace_id": rec[_TRACE], "stage": rec[_STAGE],
            "dur_s": rec[_DUR], "route": rec[_ROUTE], "t": rec[_T]}


def drain_records(max_n: int = 1000) -> List[dict]:
    """Pop up to ``max_n`` pending records for the obs shipper (worker
    nodes), in wire (dict) shape. Popleft is GIL-atomic; an empty race
    just ends the drain."""
    flush()
    out: List[dict] = []
    while len(out) < max_n:
        try:
            out.append(_wire(_pending.popleft()))
        except IndexError:
            break
    return out


def requeue_records(records: List[dict]) -> None:
    """Put drained records back after a failed ship (bounded: the deque
    drops oldest if the head stays unreachable)."""
    _pending.extend(
        (r["t"], r["trace_id"], r["stage"], r["dur_s"], r["route"])
        for r in records)


def _waterfall(entry: dict) -> dict:
    """Presentation shape shared by the API, the CLI, and the flight
    recorder: stages plus each stage's share of the total. Retained
    entries hold (stage, dur) pairs; the dict shape is built here, at
    read time, not per request."""
    total = entry.get("total_s") or 0.0
    stages = []
    for stage, dur in entry.get("stages") or []:
        frac = (dur / total) if total > 0 else 0.0
        stages.append({"stage": stage, "dur_s": dur,
                       "frac": round(frac, 4)})
    out = dict(entry)
    out["stages"] = stages
    return out


def slow_requests(n: int = 10,
                  include_inflight: bool = False) -> List[dict]:
    """Top-``n`` slowest retained requests (waterfalls, dominant stage
    named). ``include_inflight`` adds still-open traces (their total is
    age-so-far) — what the flight recorder wants mid-incident."""
    flush()
    with _lock:
        items = [dict(e) for e in _finished]
        if include_inflight:
            now = time.time()
            for trace_id, tr in _traces.items():
                agg: Dict[str, float] = {}
                for stage, dur in tr[0]:
                    agg[stage] = agg.get(stage, 0.0) + dur
                age = max(0.0, now - tr[2])
                items.append({
                    "trace_id": trace_id, "route": tr[1],
                    "status": "in_flight", "total_s": age,
                    "dominant_stage": max(agg.items(),
                                          key=lambda kv: kv[1])[0]
                    if agg else "unattributed",
                    "unattributed_s": max(
                        0.0, age - sum(agg.values())),
                    "ts": tr[2], "in_flight": True,
                    "stages": list(tr[0]),
                })
    items.sort(key=lambda e: e.get("total_s") or 0.0, reverse=True)
    return [_waterfall(e) for e in items[:max(0, n)]]


def exemplars() -> List[dict]:
    """Exemplar trace-ids for the slowest observation in each
    (route, stage) histogram bucket — the jump-off from a p99 panel to
    the trace that caused it."""
    flush()
    bounds = perf_stats.SERVE_LATENCY_BOUNDS
    out: List[dict] = []
    with _lock:
        for (route, stage), buckets in _exemplars.items():
            for idx, (dur_s, trace_id) in buckets.items():
                le = bounds[idx] if idx < len(bounds) else float("inf")
                out.append({"route": route, "stage": stage,
                            "bucket_le": le, "dur_s": dur_s,
                            "trace_id": trace_id})
    out.sort(key=lambda e: (e["route"], e["stage"], e["dur_s"]))
    return out


def attribution_vectors() -> Dict[str, Dict[str, Dict[str, float]]]:
    """{route: {stage: {p50, p99, count, sum}}} read straight from the
    fast-path dists — the JSON twin of the Prometheus exposition, used
    by ``/api/slow_requests`` and the CLI summary header."""
    flush()
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for name, tags, stat in perf_stats.stats_items():
        if name != STAGE_METRIC or not isinstance(stat, perf_stats.Dist):
            continue
        if stat.total == 0:
            continue  # interned-but-reset series: nothing to report
        tagd = dict(tags)
        route = tagd.get("route", "")
        stage = tagd.get("stage", "")
        out.setdefault(route, {})[stage] = {
            "p50": stat.quantile(0.5), "p99": stat.quantile(0.99),
            "count": stat.total, "sum": stat.sum}
    return out


def stage_spans_for_trace(trace_id: str) -> List[dict]:
    """The recorded stages for one trace (open or finished) — what
    ``export_spans`` merges into the OTLP view as synthetic child
    spans so a trace's stage anatomy rides the same trace id."""
    flush()
    with _lock:
        tr = _traces.get(trace_id)
        if tr is not None:
            return [{"stage": s, "dur_s": d} for s, d in tr[0]]
        for entry in _finished:
            if entry["trace_id"] == trace_id:
                return [{"stage": s, "dur_s": d}
                        for s, d in entry["stages"]]
    return []


def finished_waterfalls() -> List[dict]:
    flush()
    with _lock:
        out = []
        for e in _finished:
            e = dict(e)
            e["stages"] = [{"stage": s, "dur_s": d}
                           for s, d in e["stages"]]
            out.append(e)
        return out


# -- test isolation -----------------------------------------------------------


def snapshot_state() -> dict:
    """Plain-data snapshot of this module's process-global state; with
    :func:`restore_state` (both IN PLACE — hot paths alias the module
    globals) this is the conftest-baseline API that keeps one test's
    stage recordings out of the next."""
    flush()
    with _lock:
        return {
            "enabled": ENABLED,
            "shipping": SHIPPING,
            "traces": {k: [list(v[0]), v[1], v[2]]
                       for k, v in _traces.items()},
            "finished": [dict(e) for e in _finished],
            "finished_routes": dict(_finished_routes),
            "pending": list(_pending),
            "exemplars": {k: dict(v) for k, v in _exemplars.items()},
        }


def restore_state(snapshot: dict) -> None:
    global ENABLED, SHIPPING
    with _lock:
        ENABLED = snapshot.get("enabled", True)
        SHIPPING = snapshot.get("shipping", False)
        _traces.clear()
        for k, v in snapshot.get("traces", {}).items():
            _traces[k] = [list(v[0]), v[1], v[2]]
        _finished.clear()
        _finished.extend(dict(e) for e in snapshot.get("finished", []))
        _finished_routes.clear()
        _finished_routes.update(snapshot.get("finished_routes", {}))
        _pending.clear()
        _pending.extend(snapshot.get("pending", []))
        _exemplars.clear()
        for k, v in snapshot.get("exemplars", {}).items():
            _exemplars[k] = dict(v)
        _raw.clear()
        _dist_cache.clear()


def reset() -> None:
    restore_state({"enabled": True})
