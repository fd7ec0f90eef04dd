"""Runtime configuration flags.

Role-equivalent to the reference's ``RAY_CONFIG`` table
(`src/ray/common/ray_config_def.h`: a macro table of 193 typed tunables,
overridable per-process via ``RAY_<name>`` environment variables or
``ray.init(_system_config=...)``). Here the table is a dataclass of typed
fields; overrides come from ``RAY_TPU_<NAME>`` env vars (checked at first
access) or ``ray_tpu_torch.init(_system_config={...})``.

Usage::

    from ray_tpu_torch._private.config import ray_config
    period = ray_config.health_check_period_s
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Optional


@dataclasses.dataclass
class RayTpuConfig:
    # -- failure detection (reference: gcs_health_check_manager.h:39,
    #    ray_config_def.h health_check_* flags) ---------------------------
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 5.0
    health_check_failure_threshold: int = 3

    # -- object plane ----------------------------------------------------
    # Driver/node-side remote fetch gives up after this long without
    # locating an owner (reference: fetch_timeout_milliseconds).
    fetch_deadline_s: float = 60.0
    # Objects above this many bytes go to the shared segment / transfer
    # plane instead of inline pickle RPC.
    shm_share_threshold_bytes: int = 64 * 1024
    # Disk spill: objects spill when the in-process store exceeds this
    # fraction of its budget (reference: object_spilling_threshold).
    object_spilling_threshold: float = 0.8
    object_store_memory_bytes: int = 2 * 1024 ** 3
    min_spilling_size_bytes: int = 1024 * 1024
    # Bandwidth-aware pull bounding (reference: pull_manager.h caps
    # in-flight pull bytes): at most this many native wire pulls run at
    # once; excess callers wait for a slot (wait time lands in
    # perf_stats `object_pull_slot_wait_seconds`).
    object_pull_max_concurrent: int = 2
    # Parallel range-striped streams per native pull (transfer.h
    # pull_striped): each stream moves a disjoint byte range.
    object_pull_streams: int = 4
    # Object-arrival poll curve (cluster_utils.fetch_backoff): sleep
    # base * 1.6^attempt, capped. Sub-ms first probes — most objects
    # land within a few ms of submission — backing off for slow
    # producers.
    object_fetch_backoff_base_s: float = 0.0005
    object_fetch_backoff_cap_s: float = 0.01
    # Shared-segment arena spill: on create-failure backpressure the
    # owner spills its cold, unpinned shm objects to disk (URL on the
    # store entry, transparent restore on get) instead of looping on
    # eviction waits. Off = legacy wait-then-heap-fallback behavior.
    shm_spill_enabled: bool = True

    # -- locality-aware scheduling (reference: lease_policy.h locality-
    #    aware lease policy) ---------------------------------------------
    # Score lease placement by resident argument bytes so tasks with
    # large args run where the bytes already live instead of pulling
    # them to follow a small spec.
    locality_aware_scheduling: bool = True
    # Arguments below this many resident bytes never influence
    # placement (pulling them costs less than disturbing the pack).
    locality_min_arg_bytes: int = 1024 * 1024

    # -- lineage / reconstruction (reference: object_recovery_manager.h,
    #    task_manager.h lineage pinning) ---------------------------------
    enable_object_reconstruction: bool = True
    max_reconstruction_attempts: int = 3
    # Recursive reconstruction of a lost chain stops at this depth (a
    # lineage cycle or pathological dependency chain must terminate;
    # each OBJECT is still charged its own max_reconstruction_attempts).
    max_reconstruction_depth: int = 16

    # -- actor fault tolerance (reference: gcs_actor_manager.h restart
    #    FSM + direct_actor_task_submitter.h client-side queueing) ------
    # Calls submitted (or caught in flight) while an actor restarts park
    # this long waiting for the replacement before failing with an
    # ActorUnavailableError naming the restart state. Only calls with
    # max_task_retries > 0 park; others reject immediately.
    actor_restart_timeout_s: float = 30.0

    # -- rpc -------------------------------------------------------------
    rpc_connect_retries: int = 10
    rpc_retry_backoff_s: float = 0.5
    # Pre-allocation bound on one framed RPC message. The u32 length
    # prefix admits 4 GiB; without this cap the frame reader would
    # allocate whatever a hostile or skewed peer claims BEFORE any
    # byte of the body is validated. Over-cap frames raise
    # rpc.FrameTooLarge and drop the connection (the stream cannot be
    # resynchronized without reading the unread body).
    rpc_max_frame_bytes: int = 64 * 1024 * 1024
    # Mutual-TLS for the control plane (reference: RAY_USE_TLS +
    # RAY_TLS_SERVER_CERT/KEY/CA_CERT, rpc/grpc_server TLS creds). All
    # three paths must be set when use_tls is on; both sides verify the
    # peer against the shared CA.
    use_tls: bool = False
    tls_server_cert: str = ""
    tls_server_key: str = ""
    tls_ca_cert: str = ""

    # -- resource view sync (reference: ray_syncer.h RESOURCE_VIEW) ------
    # Nodes push availability deltas to the head at this period; the
    # scheduler reads the cached view instead of pinging per submission.
    resource_report_period_s: float = 0.1
    # A pushed report also counts as a heartbeat: nodes reporting within
    # this many periods are skipped by the active health checker.
    resource_report_fresh_periods: float = 5.0

    # -- scheduling ------------------------------------------------------
    # Pack below this node-utilization fraction, then prefer spreading
    # (reference: scheduler_spread_threshold, hybrid_scheduling_policy.h).
    scheduler_spread_threshold: float = 0.5
    # Compact queued representation: queued-but-undispatched normal
    # tasks are held as interned-template headers (QueuedTaskHeader)
    # and materialized to a full TaskSpec only at dispatch, so a
    # million-task backlog costs header bytes, not spec bytes
    # (reference: the serialize-once TaskSpec + raylet queued-lease
    # shape). Off = every submission builds the full spec up front.
    sched_compact_queue: bool = True
    # Shared-executor actors: sync max_concurrency=1 in-process actors
    # are served by the grow-on-demand executor pool (one activation at
    # a time per actor preserves mailbox order) instead of a dedicated
    # thread per actor, so 10k actors cost 10k mailboxes, not 10k
    # threads. Async / multi-concurrency / process-isolated actors
    # keep dedicated threads. Off = legacy thread-per-actor.
    sched_actor_executor_pool: bool = True
    # Group-committed actor creation: cluster-dispatched creations ride
    # the per-node CoalescingBatcher (submit_batch frames) and head
    # re-registrations batch into one report_actors RPC, so N actors
    # register in O(batches) head round trips. Restart-gate semantics
    # are unchanged (same record_lineage/ActorRestartGate.register
    # calls, batched transport). Off = one synchronous RPC per actor.
    sched_group_actor_creation: bool = True
    # Multi-slot pooled actors: sync in-process actors with
    # max_concurrency>1 (serve replicas declare it) are ALSO served by
    # the executor pool — up to max_concurrency concurrent drain
    # passes per actor instead of max_concurrency standing threads.
    # Off = only max_concurrency=1 actors pool (PR 13 behavior).
    sched_actor_pool_multislot: bool = True
    # Lock partitioning for the head's hot scheduling tables (inflight,
    # object directory, lineage, lease grants): shard count (rounded up
    # to a power of two). 1 = effectively a single lock per table.
    sched_head_shards: int = 16
    # Multi-PROCESS head control plane (distinct from the in-process
    # lock partitioning above): the hot row tables — object directory +
    # sizes, inflight, lineage edges, lease registrations — stream to N
    # head shard PROCESSES by stable key hash, each owning its own
    # group-commit durability window (_private/head_shards.py). 1 =
    # no shard processes, today's single-process head byte-for-byte.
    head_shards: int = 1
    # Each shard's sqlite group-commit window (its durability loss
    # bound on a hard crash). <= 0 means "inherit
    # gcs_commit_interval_s".
    head_shard_commit_interval_s: float = 0.0
    # Directory for the per-shard sqlite dbs; empty = a temp dir per
    # head (rows then survive shard restarts but not host cleanup).
    head_shard_db_dir: str = ""
    # Lease cache: a granted (job, shape) lease is returned after this
    # long idle (reference: lease return on idle worker).
    sched_lease_idle_s: float = 2.0
    # Spillback: a leased node whose reported backlog exceeds this many
    # queued-undispatched tasks triggers a spill lease on a better
    # target (reference: raylet backlog-driven spillback).
    sched_spillback_backlog: int = 128

    # -- memory monitor / worker killing (reference: memory_monitor.h) ---
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 250

    # -- observability plane ---------------------------------------------
    # Worker nodes ship task-event deltas + metric-registry snapshots to
    # the head's aggregator at this period (reference: the GCS task
    # manager / OpenCensus export cadence). 0 disables shipping.
    obs_ship_period_s: float = 0.5
    # Max task events per shipping cycle — the rest stay queued for the
    # next cycle, so one burst never produces an unbounded frame.
    obs_ship_max_events: int = 2000
    # Head-side cluster event store bound (events beyond this are
    # evicted oldest-first).
    obs_head_max_events: int = 200_000
    # Serve HTTP access log: one structured line per request on the
    # "ray_tpu_torch.serve.access" logger (method, route, status, latency_ms,
    # trace_id, job_id). Off by default — the ingress hot path stays
    # log-free.
    serve_access_log: bool = False

    # -- critical path / flight recorder (_private/critical_path.py,
    #    _private/flight_recorder.py) ------------------------------------
    # Stage-span recording at every request hop (the per-route
    # attribution vectors behind ray_tpu_request_stage_seconds and
    # /api/slow_requests). The --ab-observability bench flips this to
    # prove the tax on the serve keep-alive path stays under budget.
    stage_spans_enabled: bool = True
    # Where degradation-triggered FLIGHT_<ts>.json snapshots land.
    # Empty (the default) disables the auto-dump entirely — only an
    # explicit /api/debug/dump?write=1 or CLI request writes files.
    flight_recorder_dir: str = ""
    # Debounce: at most one auto-dump per this many seconds, so a
    # flapping verdict costs one snapshot per window, not one per
    # healthz poll.
    flight_min_interval_s: float = 60.0
    # Ring entries (spans / health samples) each process contributes
    # to a frozen snapshot.
    flight_ring_size: int = 512

    # -- serve data plane (proxy fleet + replica-direct dispatch) --------
    # Replica-direct dispatch: the HTTP proxy's steady-state fast path
    # dispatches proxy→replica over the long-poll-fed membership table
    # (no router lock, no per-request pruning, no head involvement),
    # falling back to the routed path on cache miss / saturation /
    # replica death. Read per request, so an A/B can flip it live.
    serve_replica_direct: bool = True
    # Priority-class load shedding (X-Priority: high|normal|low or
    # 0|1|2): class c is admitted while proxy in-flight < max_in_flight
    # * fraction[c], so the lowest class sheds first as load rises.
    # Defaults keep high/normal at the full cap (pre-priority behavior
    # for untagged traffic) and shed low-priority work at half load.
    serve_priority_shed_fractions: str = "1.0,1.0,0.5"
    # Optional per-class ingress token buckets ("low=50:100;normal=200",
    # rate[:burst] per second): a class over its rate sheds 503 +
    # Retry-After at the proxy even when in-flight headroom exists.
    serve_priority_rates: str = ""
    # Replica-health supervision: the controller pings each replica
    # every period; this many consecutive failures (timeout
    # serve_replica_health_timeout_s each) marks the replica dead — it
    # is removed from membership (broadcast FIRST, so routers and
    # direct tables stop dispatching), reported in /api/healthz, and
    # replaced by the reconcile loop.
    serve_replica_health_period_s: float = 1.0
    serve_replica_health_timeout_s: float = 2.0
    serve_replica_health_failures: int = 2
    # Proxy-fleet supervision period (ProxyFleet): dead proxies are
    # reported degraded and restarted on their original port.
    serve_proxy_supervise_period_s: float = 1.0
    # SLO-burn-driven autoscaling: a deployment whose route burns its
    # error budget past this multiple (short window; status-aware, so
    # load-shed 503s count) scales up one replica per cooldown even
    # when the queue signal alone would not — and never scales down
    # while burning. 0 disables the burn input (queue-only, PR 6
    # behavior).
    serve_autoscale_burn_threshold: float = 2.0
    serve_autoscale_cooldown_s: float = 3.0

    # -- SLO / health plane (_private/health.py) -------------------------
    # Per-route latency SLO targets: "route=latency_s[:objective],..."
    # (e.g. "/chat=0.25:0.999,/embed=0.1"). Routes not listed use the
    # defaults below. The burn-rate gauges and /api/healthz verdicts
    # are computed against these.
    serve_slo_targets: str = ""
    serve_slo_default_latency_s: float = 0.5
    serve_slo_default_objective: float = 0.99
    # Multi-window burn rates (the classic short/long burn-rate alert
    # shape) diffed from periodic cumulative-count snapshots.
    slo_burn_short_window_s: float = 30.0
    slo_burn_long_window_s: float = 300.0
    # Event-loop lag sampling period on the Serve proxy/replica loops
    # (0 disables the sampler).
    loop_lag_sample_period_s: float = 0.25
    # Degraded-verdict thresholds: memory usage fraction, scheduler
    # backlog (queued undispatched tasks), event-loop scheduling lag,
    # and SLO burn multiple (1.0 = burning the error budget exactly at
    # the sustainable rate).
    health_memory_pressure_threshold: float = 0.92
    health_backlog_threshold: int = 2000
    health_loop_lag_threshold_s: float = 0.25
    health_slo_burn_threshold: float = 4.0

    # -- tenancy enforcement (_private/tenancy.py; the enforcement half
    #    of the PR 6 attribution plane — reference: scheduling policies
    #    at lease grant + Serve ingress limits) --------------------------
    # Master switch: quotas, WFQ, ingress rate limits, and arena-budget
    # victim ordering all gate on this (attribution/metering is always
    # on). Off = PR 6 behavior exactly.
    tenancy_enforcement: bool = False
    # Per-job quotas: "jobA=cpus:2,queued:100,leases:2;jobB=cpus:1".
    # cpus bounds concurrently RUNNING CPU slots (over-quota tasks park
    # behind the job's own limit), queued bounds admitted-not-started
    # tasks (beyond it submits fail with JobQuotaExceededError), leases
    # bounds concurrently held pipelined dispatch leases.
    job_quotas: str = ""
    # WFQ weights for the scheduler's runnable queue and the serve
    # router: "jobA=4,jobB=1". Unlisted (and untagged) traffic uses
    # job_default_weight.
    job_weights: str = ""
    job_default_weight: float = 1.0
    # Ingress token buckets: "jobA=rate[:burst];..." per second, shed
    # with 429 + Retry-After BEFORE the router. 0 default rate = only
    # explicitly listed jobs are limited.
    ingress_rate_limits: str = ""
    ingress_default_rate_per_s: float = 0.0
    ingress_default_burst: float = 0.0
    # Optional shared-secret ingress auth: when set, requests must
    # carry "Authorization: Bearer <token>" or "X-Auth-Token: <token>"
    # or are refused with 401 before any routing work happens.
    ingress_auth_token: str = ""
    # Per-job shared-arena budgets: "jobA=64m;jobB=1g". A job over its
    # budget has ITS cold objects spilled first under arena pressure,
    # so its oversized working set cannot evict another tenant's.
    job_arena_budgets: str = ""

    # -- LLM serving (serve/llm.py + _private/kv_cache.py) ---------------
    # Prefix/KV cache: prefill skips the shared prompt head by copying
    # matched KV blocks from the host-side prefix cache into the slot
    # and prefilling only the tail. Off = every request prefills its
    # full prompt (pre-cache behavior; the bench A/B flips this).
    llm_prefix_cache: bool = True
    # Tokens per KV block (the prefix-match granularity; only full
    # blocks are cached, the partial tail chunk never is).
    llm_kv_block_tokens: int = 16
    # Host-side prefix cache capacity per engine; LRU unpinned blocks
    # evict past it (warm evictees fall to the shm tier below).
    llm_prefix_cache_bytes: int = 256 * 1024 * 1024
    # Shm-plane warm tier: evicted blocks persist as spill-backed
    # shared objects (charged to the owning tenant's arena budget) so
    # a cache hit on another replica restores via the object plane
    # instead of recomputing the prefill.
    llm_prefix_shm_tier: bool = True
    # Cache-affinity routing: replicas export hot prefix-head digests
    # through the membership long-poll; the replica-direct path scores
    # candidates by matched-prefix bytes (tie → least-loaded).
    llm_affinity_routing: bool = True
    # How many MRU block keys a replica exports in its digest.
    llm_digest_blocks: int = 32
    # How often the controller polls replicas for fresh digests (and
    # rebroadcasts the digests:: channel on change).
    llm_digest_refresh_s: float = 2.0
    # Multi-model cold-start SLA: a weight swap (load + device put)
    # exceeding this deadline fails the request with
    # ModelSwapDeadlineError (the loaded weights stay cached, so a
    # retry is warm). 0 disables the deadline.
    llm_model_swap_deadline_s: float = 30.0

    # -- GCS storage (reference: store_client/; "" = in-memory, a file
    #    path selects the durable SQLite backend in Redis's role) -------
    gcs_storage_path: str = ""
    # Durable-write group-commit window: registry writes landing within
    # this many seconds share ONE disk transaction (the reference's
    # async GCS-storage write path); 0 = synchronous commit per write.
    # flush() / graceful teardown force durability at the boundary.
    gcs_commit_interval_s: float = 0.005

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)
        _apply_env_overrides(self)


def _coerce(raw: str, target_type: type) -> Any:
    if target_type is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return target_type(raw)


def _apply_env_overrides(cfg: RayTpuConfig) -> None:
    for f in dataclasses.fields(cfg):
        env = os.environ.get(f"RAY_TPU_{f.name.upper()}")
        if env is not None:
            try:
                setattr(cfg, f.name, _coerce(env, type(f.default)))
            except (TypeError, ValueError):
                pass


_lock = threading.Lock()
ray_config = RayTpuConfig()
_apply_env_overrides(ray_config)


def apply_system_config(overrides: Optional[Dict[str, Any]]) -> None:
    """``init(_system_config={...})`` hook: named overrides win over env."""
    if not overrides:
        return
    valid = {f.name for f in dataclasses.fields(ray_config)}
    with _lock:
        for key, value in overrides.items():
            if key not in valid:
                raise ValueError(
                    f"unknown _system_config key {key!r}; valid keys: "
                    f"{sorted(valid)}")
            setattr(ray_config, key, value)
