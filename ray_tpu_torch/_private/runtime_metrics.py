"""Built-in runtime metrics (the reference's canonical stats).

Reference: `src/ray/stats/metric_defs.cc` — STATS_tasks / STATS_actors /
scheduler / object-store gauges exported alongside user metrics. Here
the same canonical series are computed ON EXPORT from live runtime state
(task-event buffer, actor registry, memory store, resources), so there's
no bookkeeping on the hot path; `collect_runtime_metrics()` refreshes
the gauges and the Prometheus endpoint calls it before rendering.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from ray_tpu_torch.util.metrics import Gauge

_gauges: Dict[str, Gauge] = {}
_prev_tags: Dict[str, set] = {}

# Library-side stats sources (serve ingress, …). The core exporter must
# not import upward into library packages (raylint R3), so libraries
# register a provider here at import time instead: ``provider() ->
# Optional[Dict[key, number]]`` plus a key -> (gauge_name, description)
# series map. A provider returning None contributes nothing this scrape.
_EXT_PROVIDERS: Dict[str, Tuple[Callable, Dict[str, Tuple[str, str]]]] = {}


def register_stats_provider(name: str, provider: Callable,
                            series: Dict[str, Tuple[str, str]]) -> None:
    _EXT_PROVIDERS[name] = (provider, series)


def unregister_stats_provider(name: str) -> None:
    """Remove a library stats provider (a redeployed/stopped library
    must be able to retire its scrape hook; raylint R7)."""
    _EXT_PROVIDERS.pop(name, None)


def reset_interned() -> None:
    """Drop the interned gauge handles and fresh-snapshot tag memory
    (raylint R7's reset-capable API for this module's registries).
    Safe at any time: ``_gauge`` re-interns on the next scrape and the
    underlying ``util.metrics`` registry keys by name, so re-created
    handles alias the same exported series."""
    _gauges.clear()
    _prev_tags.clear()


def _collect_ext_providers() -> None:
    for provider, series in list(_EXT_PROVIDERS.values()):
        try:
            stats = provider()
        except Exception:
            continue
        if stats is None:
            continue
        for key, (gauge_name, desc) in series.items():
            _gauge(gauge_name, desc).set(float(stats.get(key, 0)))


def _gauge(name: str, desc: str, tag_keys=()) -> Gauge:
    g = _gauges.get(name)
    if g is None:
        g = _gauges[name] = Gauge(name, desc, tag_keys=tag_keys)
    return g


def _set_series(name: str, desc: str, tag_key: str,
                values: Dict[str, float]) -> None:
    """Set a tagged gauge from a fresh snapshot, zeroing series whose
    tag vanished (a state with no members must read 0, not its last
    nonzero value — and a fresh session must not export the previous
    cluster's counts)."""
    _set_multi_series(name, desc, (tag_key,),
                      {(tag,): v for tag, v in values.items()})


def _set_multi_series(name: str, desc: str, tag_keys: Tuple[str, ...],
                      values: Dict[Tuple[str, ...], float]) -> None:
    """_set_series for composite tag sets (e.g. (job, state)): same
    fresh-snapshot semantics with vanished tag combinations zeroed."""
    g = _gauge(name, desc, tag_keys=tag_keys)
    current = set(values)
    for stale in _prev_tags.get(name, set()) - current:
        g.set(0.0, tags=dict(zip(tag_keys, stale)))
    for tags, v in values.items():
        g.set(float(v), tags=dict(zip(tag_keys, tags)))
    _prev_tags[name] = current


# Dists whose p99 is a first-class dashboard series: the critical-path
# attribution vectors are p50/p99 by contract, and the serve dashboard
# already charts TTFT p99.
_P99_DISTS = frozenset({"request_stage_seconds", "serve_ttft_seconds"})


def _collect_fastpath_stats() -> None:
    """Fold the lock-free fast-path stats (`_private/perf_stats.py` —
    batcher queue delay/flush size, submit→start latency, intern hit
    rate, SQLite group-commit latency, wait wake-ups, serve route
    latencies) into the registry as gauges: distributions export
    ``_p50``/``_p95``/``_count``/``_sum`` series, counters export
    ``_total``. Computed only here, on scrape — the hot paths pay two
    integer adds per observation, nothing more."""
    from ray_tpu_torch._private import perf_stats

    for name, tags, stat in perf_stats.stats_items():
        tag_keys = tuple(k for k, _ in tags)
        tag_dict = dict(tags) or None
        if isinstance(stat, perf_stats.Counter):
            _gauge(f"ray_tpu_{name}_total",
                   f"fast-path counter {name}",
                   tag_keys=tag_keys).set(float(stat.value),
                                          tags=tag_dict)
            continue
        base = f"ray_tpu_{name}"
        _gauge(f"{base}_p50", f"fast-path {name} p50",
               tag_keys=tag_keys).set(stat.quantile(0.5), tags=tag_dict)
        _gauge(f"{base}_p95", f"fast-path {name} p95",
               tag_keys=tag_keys).set(stat.quantile(0.95), tags=tag_dict)
        if name in _P99_DISTS:
            # Tail-attribution series (the dashboards chart p99 for
            # these); kept opt-in by name so every dist doesn't grow a
            # third quantile gauge.
            _gauge(f"{base}_p99", f"fast-path {name} p99",
                   tag_keys=tag_keys).set(stat.quantile(0.99),
                                          tags=tag_dict)
        _gauge(f"{base}_count", f"fast-path {name} observations",
               tag_keys=tag_keys).set(float(stat.total), tags=tag_dict)
        _gauge(f"{base}_sum", f"fast-path {name} sum",
               tag_keys=tag_keys).set(stat.sum, tags=tag_dict)


def _collect_node_stats() -> None:
    """Physical node stats (`node_stats.sample_node_stats` — the
    reporter-agent psutil sample) as ``ray_tpu_node_*`` gauges: every
    process exports its own node's sample, so worker-node snapshots
    ship them and the head's merged exposition carries one
    ``node="<id>"``-tagged series set per node."""
    from ray_tpu_torch._private.node_stats import sample_node_stats

    stats = sample_node_stats()
    for key, gauge_name, desc in (
            ("cpu_percent", "ray_tpu_node_cpu_percent",
             "Node CPU utilization percent"),
            ("cpu_count", "ray_tpu_node_cpu_count", "Node CPU count"),
            ("mem_total", "ray_tpu_node_mem_total_bytes",
             "Node total memory bytes"),
            ("mem_available", "ray_tpu_node_mem_available_bytes",
             "Node available memory bytes"),
            ("mem_percent", "ray_tpu_node_mem_percent",
             "Node memory utilization percent"),
            ("disk_total", "ray_tpu_node_disk_total_bytes",
             "Node root-disk total bytes"),
            ("disk_free", "ray_tpu_node_disk_free_bytes",
             "Node root-disk free bytes"),
            ("disk_percent", "ray_tpu_node_disk_percent",
             "Node root-disk utilization percent"),
            ("pid_count", "ray_tpu_node_pid_count",
             "Node process count")):
        v = stats.get(key)
        if v is not None:
            _gauge(gauge_name, desc).set(float(v))
    la = stats.get("load_avg")
    if la:
        _gauge("ray_tpu_node_load_1m", "Node 1-minute load average").set(
            float(la[0]))


def _collect_job_metrics(w) -> None:
    """Per-job resource accounting as ``job="<id>"``-tagged series. On
    a cluster head the task-event side is CLUSTER-wide (the shipping
    plane's merged view); object accounting is per process — node
    snapshots ship their own, node-tagged in the merged exposition.

    The event fold is fingerprint-cached: the cluster merge is O(all
    stored events) and runs every scrape/ship cycle on the head, so an
    idle cluster must not pay a repeated 200k-event walk — the buffer
    and aggregator mutation seqs tell us when nothing moved."""
    buf = getattr(w, "task_events", None)
    head = getattr(w, "cluster_head", None)
    agg = getattr(head, "obs", None) if head is not None else None
    fp = (buf.mutation_seq if buf is not None else -1,
          agg.mutation_seq if agg is not None else -1)
    cached = getattr(w, "_job_metrics_cache", None)
    if cached is not None and cached[0] == fp:
        tasks, cpu = cached[1], cached[2]
    else:
        tasks: Dict[Tuple[str, ...], float] = {}
        cpu: Dict[Tuple[str, ...], float] = {}
        # In-process the cluster-wide view is this process's buffer
        # (the observability plane that merges nodes is not ported).
        for ev in (buf.snapshot() if buf is not None else []):
            if not ev.job_id:
                continue
            key = (ev.job_id, ev.state)
            tasks[key] = tasks.get(key, 0) + 1
            dur = ev.duration_s()
            if dur:
                ckey = (ev.job_id,)
                cpu[ckey] = cpu.get(ckey, 0.0) + dur
        w._job_metrics_cache = (fp, tasks, cpu)
    _set_multi_series("ray_tpu_job_tasks", "Tasks by job and state",
                      ("job", "state"), tasks)
    _set_multi_series("ray_tpu_job_cpu_seconds",
                      "Cumulative task execution seconds by job",
                      ("job",), cpu)
    store = getattr(w, "memory_store", None)
    if store is not None and hasattr(store, "job_object_stats"):
        objs: Dict[Tuple[str, ...], float] = {}
        obj_bytes: Dict[Tuple[str, ...], float] = {}
        for job, (n, nbytes) in store.job_object_stats().items():
            if not job:
                continue  # untagged: no job="" metric series
            objs[(job,)] = float(n)
            obj_bytes[(job,)] = float(nbytes)
        _set_multi_series("ray_tpu_job_objects",
                          "Objects owned in the object store by job",
                          ("job",), objs)
        _set_multi_series("ray_tpu_job_object_store_bytes",
                          "Estimated object-store bytes owned by job",
                          ("job",), obj_bytes)
    # Tenancy enforcement state: live quota usage per job (the
    # rejection/park/rate-limit counters ride the fast-path fold as
    # ray_tpu_job_quota_*_total / ray_tpu_job_rate_limited_total).
    ledger = getattr(getattr(w, "backend", None), "quota_ledger", None)
    if ledger is not None:
        cpu_used: Dict[Tuple[str, ...], float] = {}
        queued: Dict[Tuple[str, ...], float] = {}
        parked: Dict[Tuple[str, ...], float] = {}
        for job in ledger.jobs():
            if not job:
                continue
            u = ledger.usage(job)
            cpu_used[(job,)] = float(u["cpu_milli"])
            queued[(job,)] = float(u["queued"])
            parked[(job,)] = float(u["parked"])
        _set_multi_series("ray_tpu_job_quota_cpu_milli",
                          "Running milli-CPU charged against the "
                          "job's quota", ("job",), cpu_used)
        _set_multi_series("ray_tpu_job_quota_queued",
                          "Tasks admitted against the job's "
                          "queued-task ceiling", ("job",), queued)
        _set_multi_series("ray_tpu_job_quota_parked",
                          "Tasks parked behind the job's CPU quota",
                          ("job",), parked)
    plane = getattr(w, "shm_plane", None)
    if plane is not None and hasattr(plane, "job_arena_bytes"):
        arena: Dict[Tuple[str, ...], float] = {}
        for job, nbytes in plane.job_arena_bytes().items():
            if job:
                arena[(job,)] = float(nbytes)
        _set_multi_series("ray_tpu_job_arena_bytes",
                          "Shared-arena bytes charged to the "
                          "producing job", ("job",), arena)


def collect_runtime_metrics() -> None:
    """Refresh the canonical runtime gauges from live state. Cheap
    (reads in-process tables); safe to call on every scrape."""
    from ray_tpu_torch._private import worker as worker_mod

    try:
        _collect_fastpath_stats()
    except Exception:
        pass
    _collect_ext_providers()
    try:
        _collect_node_stats()
    except Exception:
        pass
    # Health/SLO plane: burn-rate + loop-lag + pressure + scheduler
    # queue-depth gauges (what per-node /api/healthz verdicts read out
    # of shipped snapshots).
    try:
        from ray_tpu_torch._private.health import collect_health_metrics

        collect_health_metrics()
    except Exception:
        pass

    w = worker_mod.global_worker_or_none()
    if w is None:
        return

    # Tasks by state (reference STATS_tasks).
    by_state: Dict[str, float] = {}
    try:
        for ev in w.task_events.list_events():
            by_state[ev.state] = by_state.get(ev.state, 0) + 1
    except Exception:
        pass
    _set_series("ray_tpu_tasks", "Tasks by state", "state", by_state)

    # Per-job attribution series (job-tagged tasks/cpu/objects).
    try:
        _collect_job_metrics(w)
    except Exception:
        pass

    # Actors by state (reference STATS_actors).
    try:
        actors = getattr(w.backend, "_actors", {})
        a_by_state: Dict[str, float] = {}
        for actor in list(actors.values()):
            a_by_state[actor.state] = a_by_state.get(actor.state, 0) + 1
        _set_series("ray_tpu_actors", "Actors by state", "state",
                    a_by_state)
    except Exception:
        pass

    # Object store occupancy (reference object_store_memory stats).
    try:
        store = w.memory_store
        with store._lock:
            entries = list(store._entries.values())
        n_objects = len(entries)
        n_bytes = float(sum(e.size or 0 for e in entries))
        _gauge("ray_tpu_object_store_objects",
               "Objects resident in the in-process store").set(
            float(n_objects))
        _gauge("ray_tpu_object_store_bytes",
               "Estimated bytes resident in the in-process store").set(
            n_bytes)
        spilled = sum(1 for e in entries if e.spilled_url)
        _gauge("ray_tpu_object_store_spilled_objects",
               "Objects currently spilled to external storage").set(
            float(spilled))
    except Exception:
        pass

    # Resource slots (reference scheduler resource gauges).
    try:
        res = w.backend.resources
        _set_series("ray_tpu_resources_total", "Total node resources",
                    "resource", dict(res.total))
        _set_series("ray_tpu_resources_available",
                    "Available node resources", "resource",
                    dict(res.available))
    except Exception:
        pass

    # Shared-memory plane stats when installed (plasma stats role).
    try:
        plane = getattr(w, "shm_plane", None)
        if plane is not None:
            st = plane.store.stats()
            items = st.items() if isinstance(st, dict) else (
                (f, getattr(st, f)) for f in dir(st)
                if not f.startswith("_"))
            for field, val in items:
                if isinstance(val, (int, float)):
                    _gauge(f"ray_tpu_shm_{field}",
                           f"Shared-memory store {field}").set(
                        float(val))
    except Exception:
        pass
