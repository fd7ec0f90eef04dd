"""Health + SLO plane: overload signals and node/cluster verdicts.

Role-equivalent to the reference's GCS health-check manager plus the
autoscaler/raylet overload heuristics, unified into one queryable
surface: the signals the scheduler, Serve router, and autoscaler need
to *react* to load — not just chart it — computed from state the
observability plane (PR 3) already collects.

Signals, all cheap and sampled on scrape (never on a hot path):

- **Serve SLO burn**: per-route multi-window burn rates computed from
  the cumulative ``serve_request_seconds`` fast-path distributions.
  ``burn = bad_fraction(window) / error_budget`` — 1.0 means the route
  is consuming its error budget exactly at the sustainable rate,
  above ``health_slo_burn_threshold`` means the SLO is actively
  burning down (the classic multi-window burn-rate alert shape).
- **Event-loop lag**: how late a timed callback fires on the Serve
  proxy / replica asyncio loops — the canonical single-threaded
  event-loop overload signal (``install_loop_lag_sampler``).
- **Scheduler queue depth**: ``LocalBackend.queue_depths()`` backlog.
- **Memory pressure**: the memory monitor's sampled usage fraction.

``evaluate_health`` produces the ``/api/healthz`` payload: this
process's verdict plus — on a cluster head — a per-node verdict read
from each node's shipped metrics snapshot, rolled up into one cluster
status whose ``reasons`` name the overloaded signal.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import perf_stats
from ray_tpu_torch._private.config import ray_config

# -- event-loop lag ----------------------------------------------------------

_LAG_LOCK = threading.Lock()
# component -> (wall ts, lag_s): the LAST sample, so the health verdict
# recovers the moment the loop does (the cumulative distribution keeps
# the history for exposition, but its p95 never comes back down).
_LAST_LAG: Dict[str, Tuple[float, float]] = {}
# component -> install token: only the NEWEST sampler for a component
# may write. A replica redeploy leaves the old loop (and its sampler)
# running as an orphan daemon thread; without the token its idle ~0
# readings would last-write-wins mask the live replica's lag.
_SAMPLER_TOKENS: Dict[str, object] = {}


def note_loop_lag(component: str, lag_s: float) -> None:
    with _LAG_LOCK:
        _LAST_LAG[component] = (time.time(), lag_s)


def recent_loop_lag(max_age_s: float = 15.0) -> Dict[str, float]:
    """Freshest lag sample per component; stale components drop out
    (a stopped proxy must not pin a degraded verdict forever)."""
    now = time.time()
    with _LAG_LOCK:
        return {c: lag for c, (ts, lag) in _LAST_LAG.items()
                if now - ts <= max_age_s}


def install_loop_lag_sampler(loop, component: str):
    """Schedule a lag sampler on an asyncio loop (which may run in
    another thread). Each tick measures scheduling delay — actual wait
    minus requested sleep — and records it to the
    ``event_loop_lag_seconds{component=...}`` distribution plus the
    last-sample table the health verdict reads. Returns the
    concurrent.futures handle (the sampler dies with its loop), or
    None when sampling is disabled."""
    import asyncio

    period = ray_config.loop_lag_sample_period_s
    if period <= 0:
        return None
    stat = perf_stats.dist("event_loop_lag_seconds",
                           tags={"component": component},
                           bounds=perf_stats.LATENCY_BOUNDS)
    token = object()
    with _LAG_LOCK:
        _SAMPLER_TOKENS[component] = token

    async def sampler():
        while True:
            t0 = loop.time()
            await asyncio.sleep(period)
            lag = max(0.0, loop.time() - t0 - period)
            with _LAG_LOCK:
                if _SAMPLER_TOKENS.get(component) is not token:
                    return  # superseded by a newer loop's sampler
                _LAST_LAG[component] = (time.time(), lag)
            stat.record(lag)

    return asyncio.run_coroutine_threadsafe(sampler(), loop)


def remove_loop_lag_component(component: str) -> None:
    """Retire a component's sampler state at orderly teardown (stopped
    replica/proxy): drops it from the last-sample table immediately
    instead of aging out over ``max_age_s``, and frees its supersede
    token so the tables don't grow with every redeploy."""
    with _LAG_LOCK:
        _LAST_LAG.pop(component, None)
        _SAMPLER_TOKENS.pop(component, None)


# -- serve SLO burn ----------------------------------------------------------


def parse_slo_targets() -> Dict[str, Tuple[float, float]]:
    """``serve_slo_targets`` is ``"route=latency_s[:objective],..."``
    (e.g. ``"/chat=0.25:0.999,/embed=0.1"``); routes not listed fall
    back to ``serve_slo_default_latency_s`` /
    ``serve_slo_default_objective``. Malformed entries are skipped —
    a config typo must not take down the scrape path."""
    out: Dict[str, Tuple[float, float]] = {}
    for part in (ray_config.serve_slo_targets or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        route, _, rest = part.partition("=")
        bits = rest.split(":")
        try:
            lat = float(bits[0])
            obj = float(bits[1]) if len(bits) > 1 \
                else ray_config.serve_slo_default_objective
        except (ValueError, IndexError):
            continue
        out[route.strip()] = (lat, obj)
    return out


class SloTracker:
    """Multi-window burn rates from cumulative route latency counts.

    The fast-path ``serve_request_seconds`` dists only ever grow, so
    windowed rates need history: each ``sample()`` snapshots the
    per-route (total, over-target) cumulative counts, and
    ``burn_rates()`` diffs the newest snapshot against the newest one
    at least a window old. A young process reports over its lifetime
    (the oldest snapshot) rather than zero."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: "deque[Tuple[float, Dict[str, Tuple[int, int]]]]" \
            = deque()

    def _cumulative(self) -> Dict[str, Tuple[int, int]]:
        """route -> (total requests, SLO-bad requests), summed across
        status tags. A request is good when it landed in a latency
        bucket whose upper bound is <= the target AND did not fail
        server-side: 5xx series — crucially including the proxy's own
        fast load-shed 503s — are bad at any latency, else a route
        rejecting most traffic would read as healthy precisely when
        the shedding it triggers should be driving the burn alert."""
        targets = parse_slo_targets()
        default_lat = ray_config.serve_slo_default_latency_s
        out: Dict[str, list] = {}
        for name, tags, stat in perf_stats.stats_items():
            if name != "serve_request_seconds" or \
                    not isinstance(stat, perf_stats.Dist):
                continue
            tagd = dict(tags)
            route = tagd.get("route", "(unmatched)")
            lat = targets.get(route, (default_lat, 0.0))[0]
            total = stat.total
            good = 0
            if not tagd.get("status", "").startswith("5"):
                for bound, c in zip(stat.bounds, stat.counts):
                    if bound > lat:
                        break
                    good += c
            cur = out.setdefault(route, [0, 0])
            cur[0] += total
            cur[1] += max(0, total - good)
        return {r: (t, b) for r, (t, b) in out.items()}

    def sample(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        cum = self._cumulative()
        horizon = ray_config.slo_burn_long_window_s * 1.5 + 1.0
        with self._lock:
            self._samples.append((now, cum))
            while self._samples and now - self._samples[0][0] > horizon:
                self._samples.popleft()

    def burn_rates(self, now: Optional[float] = None) \
            -> Dict[str, Dict[str, float]]:
        """{route: {"short": burn, "long": burn}} over the configured
        windows. burn = (over-target fraction in window) / (1 -
        objective); 0 when the route saw no traffic in the window."""
        now = time.time() if now is None else now
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {}
        latest = samples[-1][1]
        targets = parse_slo_targets()
        default_obj = ray_config.serve_slo_default_objective
        out: Dict[str, Dict[str, float]] = {}
        for wname, wlen in (
                ("short", ray_config.slo_burn_short_window_s),
                ("long", ray_config.slo_burn_long_window_s)):
            base = samples[0][1]
            for ts, cum in samples:
                if now - ts >= wlen:
                    base = cum
                else:
                    break
            for route, (total, bad) in latest.items():
                b_total, b_bad = base.get(route, (0, 0))
                d_total = total - b_total
                d_bad = bad - b_bad
                obj = targets.get(route, (0.0, default_obj))[1]
                budget = max(1e-9, 1.0 - obj)
                burn = (d_bad / d_total / budget) if d_total > 0 else 0.0
                out.setdefault(route, {})[wname] = burn
        return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


tracker = SloTracker()


# -- degraded-component providers --------------------------------------------

# Process-wide registry of component health providers: subsystems that
# KNOW about dead/degraded components (the serve controller's replica
# supervision, the proxy-fleet supervisor) register a callable
# returning current reason strings, and /api/healthz folds them in —
# the dependency points downward (serve registers into health, health
# never imports serve; same contract as register_stats_provider).
_PROVIDER_LOCK = threading.Lock()
_DEGRADED_PROVIDERS: Dict[str, Any] = {}


def register_degraded_provider(key: str, fn) -> None:
    """Register (or replace) a component-health provider. ``fn()``
    returns a list of degraded-reason strings (empty = healthy); it is
    called on every healthz evaluation and must be cheap and
    non-blocking (read a dict under a lock, never RPC)."""
    with _PROVIDER_LOCK:
        _DEGRADED_PROVIDERS[key] = fn


def unregister_degraded_provider(key: str) -> None:
    with _PROVIDER_LOCK:
        _DEGRADED_PROVIDERS.pop(key, None)


_SECTION_PROVIDERS: Dict[str, Any] = {}


def register_section_provider(key: str, fn) -> None:
    """Register a STRUCTURED healthz section: ``fn()`` returns plain
    data that lands verbatim under ``key`` in the /api/healthz payload
    (e.g. the multi-process head's per-shard verdict list). Same
    contract as degraded providers: cheap, non-blocking, no RPC."""
    with _PROVIDER_LOCK:
        _SECTION_PROVIDERS[key] = fn


def unregister_section_provider(key: str) -> None:
    with _PROVIDER_LOCK:
        _SECTION_PROVIDERS.pop(key, None)


def provider_sections() -> Dict[str, Any]:
    """Current structured sections from every registered provider; a
    broken provider degrades to absent rather than failing healthz."""
    with _PROVIDER_LOCK:
        providers = dict(_SECTION_PROVIDERS)
    sections = {}
    for key, fn in providers.items():
        try:
            sections[key] = fn()
        except Exception:
            continue
    return sections


def provider_reasons() -> list:
    """Current reasons from every registered provider; a broken
    provider degrades to absent rather than failing the endpoint."""
    with _PROVIDER_LOCK:
        providers = list(_DEGRADED_PROVIDERS.values())
    reasons = []
    for fn in providers:
        try:
            reasons.extend(str(r) for r in fn() or ())
        except Exception:
            continue
    return reasons


def snapshot_state() -> dict:
    """Plain-data snapshot of this module's process-global state: the
    global tracker's burn-rate history plus the loop-lag sample/token
    tables. With :func:`restore_state` this is the reset-capable API
    tests use to guarantee one test's health recordings (a 5xx burst,
    an installed lag sampler) never read as live signal in the next —
    the structural fix for the order-dependent healthz flake."""
    with tracker._lock:
        samples = list(tracker._samples)
    with _LAG_LOCK:
        lag = dict(_LAST_LAG)
        tokens = dict(_SAMPLER_TOKENS)
    with _PROVIDER_LOCK:
        providers = dict(_DEGRADED_PROVIDERS)
    return {"tracker_samples": samples, "loop_lag": lag,
            "sampler_components": tokens,
            "degraded_providers": providers}


def restore_state(snapshot: dict) -> None:
    """Restore :func:`snapshot_state` state. Sampler tokens are
    restored too: a sampler installed during the restored-over window
    loses its token and retires itself at its next tick (the same
    supersede mechanism a redeploy uses)."""
    with tracker._lock:
        tracker._samples.clear()
        tracker._samples.extend(snapshot["tracker_samples"])
    with _LAG_LOCK:
        _LAST_LAG.clear()
        _LAST_LAG.update(snapshot["loop_lag"])
        _SAMPLER_TOKENS.clear()
        _SAMPLER_TOKENS.update(snapshot["sampler_components"])
    with _PROVIDER_LOCK:
        _DEGRADED_PROVIDERS.clear()
        _DEGRADED_PROVIDERS.update(
            snapshot.get("degraded_providers") or {})


# -- scrape-time collection --------------------------------------------------


def collect_health_metrics() -> None:
    """Fold health signals into the metrics registry (called by
    ``collect_runtime_metrics`` on every scrape/ship): SLO burn gauges,
    last event-loop lag per component, and memory pressure. Worker
    nodes thereby ship these in their metric snapshots, which is what
    lets the head compute per-node verdicts without extra RPCs."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.memory_monitor import current_pressure
    from ray_tpu_torch._private.runtime_metrics import _gauge, _set_series

    tracker.sample()
    for route, windows in tracker.burn_rates().items():
        for wname, burn in windows.items():
            _gauge("ray_tpu_serve_slo_burn_rate",
                   "Serve SLO error-budget burn multiple by route/window",
                   tag_keys=("route", "window")).set(
                burn, tags={"route": route, "window": wname})
    # Fresh-snapshot series: a component whose sampler died (stopped
    # proxy, retired replica) must read 0, not its last value — the
    # shipped gauge is what per-node healthz verdicts are computed
    # from, and a frozen above-threshold reading would pin the node
    # degraded forever.
    _set_series("ray_tpu_event_loop_lag_last_seconds",
                "Most recent event-loop scheduling-lag sample",
                "component", recent_loop_lag())
    _gauge("ray_tpu_memory_pressure",
           "Node memory usage fraction (cgroup v2 / meminfo)").set(
        current_pressure())
    # Scheduler-pressure gauges (LocalBackend.queue_depths): a worker
    # node's snapshot carries them to the head, which is where the
    # per-node healthz verdict reads them back out.
    w = worker_mod.global_worker_or_none()
    depths = None
    if w is not None:
        try:
            depths = w.backend.queue_depths()
        except Exception:
            depths = None
        if depths:
            _gauge("ray_tpu_sched_backlog",
                   "Tasks queued but not yet dispatched").set(
                float(depths.get("backlog", 0)))
            _gauge("ray_tpu_sched_parked_for_resources",
                   "Runnable tasks parked waiting for resources").set(
                float(depths.get("parked_for_resources", 0)))
            _gauge("ray_tpu_sched_waiting_for_deps",
                   "Tasks parked on unresolved dependencies").set(
                float(depths.get("waiting_for_deps", 0)))
    # Flight-recorder sample ring: the same signals, kept as bounded
    # history per process so a degradation-triggered dump can show the
    # minutes BEFORE the verdict flipped, not just the instant of it.
    from ray_tpu_torch._private import flight_recorder

    flight_recorder.note_sample("health", {
        "memory_pressure": current_pressure(),
        "queue_depths": depths or {},
        "loop_lag": recent_loop_lag(),
        "slo_burn": {r: ws.get("short", 0.0)
                     for r, ws in tracker.burn_rates().items()},
    })


# -- verdicts ----------------------------------------------------------------


def _local_signals(worker) -> Dict[str, Any]:
    from ray_tpu_torch._private.memory_monitor import current_pressure

    # Burn rates are diffs between SNAPSHOTS of the cumulative route
    # counts: take one now, so a healthz consumer gets live burn even
    # when nothing is scraping /api/metrics (the other sampling site).
    tracker.sample()
    sig: Dict[str, Any] = {
        "memory_pressure": current_pressure(),
        "sched_backlog": 0,
        "loop_lag": recent_loop_lag(),
        "slo_burn": {r: w.get("short", 0.0)
                     for r, w in tracker.burn_rates().items()},
    }
    try:
        backend = worker.backend
        lb = getattr(backend, "local_backend", backend)
        sig["sched_backlog"] = lb.queue_depths()["backlog"]
    except Exception:
        pass
    return sig


def evaluate_signals(sig: Dict[str, Any]) -> Dict[str, Any]:
    """One node's verdict from its signal dict; every reason names the
    overloaded signal first so operators (and the scheduler/router)
    can key off it."""
    reasons = []
    pressure = float(sig.get("memory_pressure") or 0.0)
    if pressure > ray_config.health_memory_pressure_threshold:
        reasons.append(
            f"memory_pressure: usage {pressure:.2f} above threshold "
            f"{ray_config.health_memory_pressure_threshold:.2f}")
    backlog = int(sig.get("sched_backlog") or 0)
    if backlog > ray_config.health_backlog_threshold:
        reasons.append(
            f"sched_backlog: {backlog} queued tasks above threshold "
            f"{ray_config.health_backlog_threshold}")
    for comp, lag in sorted((sig.get("loop_lag") or {}).items()):
        if lag > ray_config.health_loop_lag_threshold_s:
            reasons.append(
                f"event_loop_lag: {comp} loop {lag * 1e3:.0f}ms behind "
                f"(threshold "
                f"{ray_config.health_loop_lag_threshold_s * 1e3:.0f}ms)")
    for route, burn in sorted((sig.get("slo_burn") or {}).items()):
        if burn > ray_config.health_slo_burn_threshold:
            reasons.append(
                f"slo_burn: route {route} consuming error budget at "
                f"{burn:.1f}x (threshold "
                f"{ray_config.health_slo_burn_threshold:.1f}x)")
    return {"status": "degraded" if reasons else "ok",
            "reasons": reasons, "signals": sig}


def _signals_from_snapshot(snap: dict) -> Dict[str, Any]:
    """Health signals out of a node's shipped metrics-registry snapshot
    (the gauges collect_health_metrics set on that node)."""

    def gauge_value(name: str, default: float = 0.0) -> float:
        series = (snap.get(name) or {}).get("series") or []
        return float(series[0][1]) if series else default

    def tagged(name: str, key: str) -> Dict[str, float]:
        out = {}
        for tag_pairs, v in (snap.get(name) or {}).get("series") or []:
            tags = {k: val for k, val in tag_pairs}
            out[tags.get(key, "")] = float(v)
        return out

    slo = {}
    for tag_pairs, v in (snap.get("ray_tpu_serve_slo_burn_rate")
                         or {}).get("series") or []:
        tags = {k: val for k, val in tag_pairs}
        if tags.get("window") == "short":
            slo[tags.get("route", "")] = float(v)
    return {
        "memory_pressure": gauge_value("ray_tpu_memory_pressure"),
        "sched_backlog": gauge_value("ray_tpu_sched_backlog"),
        "loop_lag": tagged("ray_tpu_event_loop_lag_last_seconds",
                           "component"),
        "slo_burn": slo,
    }


def evaluate_health(worker=None) -> Dict[str, Any]:
    """The ``/api/healthz`` payload: this process's verdict plus — on a
    cluster head — per-node verdicts from shipped snapshots, rolled up
    into one cluster status with reasons naming each overloaded
    signal. Always answers; a broken sub-signal degrades to absent
    rather than failing the endpoint."""
    from ray_tpu_torch._private.worker import global_worker

    w = worker or global_worker()
    local = evaluate_signals(_local_signals(w))
    # Component-health providers (serve replica/proxy supervision):
    # dead components degrade this process's verdict with reasons
    # naming them, and recover the moment the provider's list drains.
    extra = provider_reasons()
    if extra:
        local["reasons"] = list(local["reasons"]) + extra
        local["status"] = "degraded"
    nodes: Dict[str, Any] = {}
    head = getattr(w, "cluster_head", None)
    agg = getattr(head, "obs", None) if head is not None else None
    if agg is not None:
        for node_id, snap in sorted(agg.metrics_snapshots().items()):
            try:
                nodes[node_id] = evaluate_signals(
                    _signals_from_snapshot(snap))
            except Exception:
                continue
    reasons = list(local["reasons"])
    for node_id, verdict in nodes.items():
        reasons.extend(f"node {node_id[:8]}: {r}"
                       for r in verdict["reasons"])
    out = {"status": "degraded" if reasons else "ok",
           "reasons": reasons,
           "head": local,
           "nodes": nodes}
    # Structured sections (e.g. "head_shards": per-shard verdicts from
    # the multi-process head's coordinator) ride the payload verbatim.
    out.update(provider_sections())
    # Flight recorder: the ok→degraded edge freezes every live node's
    # rings into one correlated FLIGHT_<ts>.json (no-op unless
    # flight_recorder_dir is configured; debounced inside).
    from ray_tpu_torch._private import flight_recorder

    flight_recorder.observe_verdict(out, worker=w)
    return out
