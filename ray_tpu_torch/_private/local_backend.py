"""In-process execution backend: resource-aware scheduler + worker threads.

This is the single-node substrate the public API runs on by default. It
reproduces the *semantics* of the reference's raylet + core-worker pair —
dependency-gated dispatch (``LocalTaskManager``, reference
``src/ray/raylet/local_task_manager.cc:91``), resource accounting, ordered
per-actor queues (``direct_actor_task_submitter.h``), blocked-worker CPU
release (the block/unblock notifications in ``raylet_client.h``) — with
threads in one process instead of forked worker processes. The multiprocess
node (``cluster.py``) layers real process isolation and the shared-memory
object store on the same TaskSpec/scheduling interfaces.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import queue
import threading
from typing import Any, Dict, Optional

from time import monotonic as _monotonic

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import critical_path as _critical_path
from ray_tpu_torch._private import perf_stats as _perf_stats
from ray_tpu_torch._private import sched_state, tenancy
from ray_tpu_torch._private.ids import ActorID, NodeID, ObjectID
from ray_tpu_torch._private.resources import ResourceSet, spec_milli, to_milli
from ray_tpu_torch._private.task_spec import (
    DefaultSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    QueuedTaskHeader,
    TaskKind,
    TaskSpec,
)
from ray_tpu_torch._private.task_spec import trace_id_of as _trace_id_of

logger = logging.getLogger(__name__)

# Submit→execution-start latency (normal tasks: scheduler queue +
# dispatch; actor tasks: mailbox wait) — module-level so both execute
# paths share one distribution.
_SCHED_LATENCY = _perf_stats.latency("sched_submit_to_start_seconds")
# Compact-queue observability (ray_tpu_sched_* after the runtime-
# metrics fold): header-queued submissions + their approximate queued
# footprint, and the header→spec materialization cost at dispatch.
_HEADERS_QUEUED = _perf_stats.counter("sched_headers_queued")
_HEADER_BYTES = _perf_stats.counter("sched_queued_header_bytes")
_MATERIALIZE = _perf_stats.latency("sched_materialize_seconds")


class _BlockedState(threading.local):
    """Per-thread record of resources released while blocked in get()."""

    def __init__(self):
        self.stack = []


# Actor-death observers: modules holding per-actor registries keyed by
# actor id (util.collective's group tables) register a cleanup callable
# here so a dying actor's rows don't outlive it. Process-wide, called
# with the ActorID from every local death path; unregister provided
# (reset-capable).
_ACTOR_DEATH_HOOKS: list = []


def register_actor_death_hook(fn) -> None:
    if fn not in _ACTOR_DEATH_HOOKS:
        _ACTOR_DEATH_HOOKS.append(fn)


def unregister_actor_death_hook(fn) -> None:
    if fn in _ACTOR_DEATH_HOOKS:
        _ACTOR_DEATH_HOOKS.remove(fn)


def _fire_actor_death_hooks(actor_id: "ActorID") -> None:
    for fn in list(_ACTOR_DEATH_HOOKS):
        try:
            fn(actor_id)
        except Exception:
            pass


class ActorState:
    ALIVE = "ALIVE"
    DEAD = "DEAD"
    RESTARTING = "RESTARTING"
    PENDING = "PENDING_CREATION"


class _Actor:
    """Server side of one actor: mailbox + executor thread(s)."""

    def __init__(self, backend: "LocalBackend", spec: TaskSpec):
        self.backend = backend
        self.spec = spec
        self.actor_id: ActorID = spec.actor_id
        self.state = ActorState.PENDING
        self.instance: Any = None
        self.mailbox: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        self.death_cause = ""
        self.num_restarts = 0
        # Guards state transitions vs. mailbox puts (kill/submit race),
        # and — in pool mode — the activation slot count.
        self.mb_lock = threading.Lock()
        # Pool mode: serializes construction against a (theoretical)
        # concurrent second activation; never held during serving.
        self.ctor_lock = threading.Lock()
        self.is_async = bool(sched_state.class_is_async(spec.func))
        # Shared-executor serving (sched_actor_executor_pool): sync
        # in-process actors are drained by the backend's grow-on-demand
        # executor pool instead of dedicated threads, so 10k actors
        # cost 10k mailboxes and ZERO standing threads. max_concurrency
        # bounds CONCURRENT drain passes per actor (multi-slot —
        # sched_actor_pool_multislot; serve replicas declare
        # max_concurrency>1 and used to pin that many standing threads
        # each); at max_concurrency=1 a single activation at a time
        # preserves strict mailbox order exactly as before. Async /
        # process-isolated actors keep the dedicated-thread path.
        from ray_tpu_torch._private.config import ray_config

        self.pool_mode = bool(
            ray_config.sched_actor_executor_pool and not self.is_async
            and not spec.isolate_process
            and (spec.max_concurrency <= 1
                 or ray_config.sched_actor_pool_multislot))
        # Pool mode: drain passes (slots) currently scheduled/running,
        # bounded by max_slots. Guarded by mb_lock.
        self.max_slots = max(1, spec.max_concurrency) \
            if self.pool_mode else 1
        self._active_count = 0
        self._threads: list[threading.Thread] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # Dedicated forked worker when spec.isolate_process is set.
        self._proc = None

    def start(self):
        if self.pool_mode:
            # Constructor + queued calls run as one drain pass on the
            # shared executor pool (no per-actor thread).
            self.backend._activate_actor(self)
            return
        n = max(1, self.spec.max_concurrency) if not self.is_async else 1
        for i in range(n):
            t = threading.Thread(
                target=self._run_loop, name=f"actor-{self.actor_id.hex()[:8]}-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _construct(self) -> bool:
        """Run the constructor; returns True on success. Pushes task
        context (so tasks submitted from __init__ join the caller's
        trace) and records a construction span."""
        spec = self.spec
        ctx = self.backend.worker.task_context
        events = self.backend.worker.task_events
        ctx.push(task_spec=spec, node_id=self.backend.node_id, pool=None,
                 request=None)
        events.task_started(spec, self.backend.node_id,
                            threading.current_thread().name)
        try:
            # Constructor args resolve top-level ObjectRefs exactly like
            # method args (reference: core_worker actor creation task).
            args, kwargs = self.backend.worker.resolve_args(spec)
            if spec.isolate_process:
                # The instance lives in a dedicated worker process; the
                # node only holds the command socket. "spawn" execs a
                # fresh interpreter (pristine process globals — needed
                # for jax.distributed ranks); True forks.
                self._proc = self.backend.worker_pool.dedicated(
                    spawn=spec.isolate_process == "spawn", meta=spec)
                self._proc.request(("init", spec.func, args,
                                    kwargs, spec.runtime_env))
            else:
                self.instance = spec.func(*args, **kwargs)
            self.state = ActorState.ALIVE
            self.backend.worker.store_task_outputs(spec, [None])
            events.task_finished(spec)
            return True
        except BaseException as e:  # noqa: BLE001 - constructor error kills actor
            self.state = ActorState.DEAD
            self.death_cause = f"constructor raised {type(e).__name__}: {e}"
            err = exc.TaskError(e, spec.describe())
            self.backend.worker.store_task_outputs(spec, None, error=err)
            events.task_finished(spec, error=f"{type(e).__name__}: {e}")
            self.backend._on_actor_death(self, err)
            return False
        finally:
            ctx.pop()

    def _run_loop(self):
        # Only the first thread constructs; others wait until alive.
        is_primary = threading.current_thread() is self._threads[0] if self._threads else True
        if is_primary or self.state == ActorState.PENDING:
            with self.backend._actor_ctor_lock:
                if self.state == ActorState.PENDING:
                    if not self._construct():
                        return
        if self.is_async:
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
        while True:
            try:
                item = self.mailbox.get(timeout=0.5)
            except queue.Empty:
                # Sentinel counting can undercount when a kill races
                # start() mid-spawn; the periodic state check guarantees
                # every executor thread exits after death regardless.
                if self.state == ActorState.DEAD:
                    return
                continue
            if item is None:
                return
            if self.state == ActorState.DEAD:
                self.backend.worker.store_task_outputs(
                    item, None,
                    error=exc.ActorDiedError(self.actor_id.hex()[:8], self.death_cause),
                )
                continue
            self.backend._execute_actor_task(self, item)

    def stop(self, cause: str = "killed") -> list:
        """Transition to DEAD; returns specs that were still queued.

        Under mb_lock so no submit can slip a spec in between the drain and
        the shutdown sentinels (which would leave its caller hanging).
        """
        with self.mb_lock:
            already_dead = self.state == ActorState.DEAD
            self.state = ActorState.DEAD
            self.death_cause = self.death_cause if already_dead else cause
            drained = []
            try:
                while True:
                    item = self.mailbox.get_nowait()
                    if item is not None:
                        drained.append(item)
            except queue.Empty:
                pass
            if not already_dead and not self.pool_mode:
                # Wake every dedicated executor thread (pool-mode
                # actors have none to wake: an active drain pass
                # observes DEAD at its next item and retires).
                for _ in (self._threads or [None]):
                    self.mailbox.put(None)
        # Abrupt-stop hook, OUTSIDE mb_lock (it may take the instance's
        # own locks): an instance that spawned background threads or
        # parked waiters has no other way to learn it was killed — a
        # real process death would reap them, but this runtime's actors
        # are threads, so an un-hooked kill leaks every one of them
        # (the leak sanitizer caught the serve controller's reconciler
        # and long-poll waiters surviving crash-simulation kills).
        if not already_dead:
            hook = getattr(self.instance, "_on_actor_stop", None)
            if hook is not None:
                try:
                    hook()
                except Exception:
                    pass
        return drained


class LocalBackend:
    """One node's scheduler and execution engine, in-process."""

    def __init__(self, worker, resources: Dict[str, float],
                 node_id: Optional[NodeID] = None):
        self.worker = worker
        self.node_id = node_id or NodeID.from_random()
        self.resources = ResourceSet(resources)
        # Dependency-parked work: a pure decision core with exactly-
        # once handoff between the ready path and the death sweep
        # (raymc dep_sweep scenario proves the claim protocol; ROADMAP
        # FT gap d). Items are queued forms — headers or full specs.
        self._deps = sched_state.DepTable()
        # Demand of dep-parked work, charged at park and released at
        # claim (ready or sweep). NOT part of the backlog signal (the
        # work is not runnable yet) but head-local placement of
        # lifetime-pinned creations must see it — a dep-blocked
        # creation burst otherwise over-lands on the head and the
        # overflow parks forever once the deps resolve.
        self._dep_demand = sched_state.PendingCounter()
        # Runnable queue: per-job virtual-time WFQ when tenancy
        # enforcement + weights are configured, byte-identical FIFO
        # otherwise (one class). Same put/get/get_nowait surface as the
        # queue.Queue it replaces.
        self._ready = tenancy.FairTaskQueue()
        # Per-job quota ledger (tenancy enforcement): queued-task
        # ceiling at admission, CPU-slot gate at dispatch. One ledger
        # per head process — the cluster mixin shares it through
        # __getattr__ delegation so a job's usage is one number whether
        # its tasks run here or ride a lease. Node processes disable
        # theirs (the head already enforced at grant).
        self.quota_ledger = tenancy.QuotaLedger()
        self._waiting_for_resources: list[TaskSpec] = []
        # Incremental queued-demand accounting (reference: raylet
        # backlog) under its own small lock — the submit hot path's
        # add/remove never contends with the dep table or the parked
        # list. Scanning the ready queue per submission made the
        # local-fit check O(queue) -> O(n^2) over a fan-out burst.
        self._pending = sched_state.PendingCounter()
        # Grow-on-demand executor pool for normal tasks (see _launch).
        self._exec_q: "queue.Queue" = queue.Queue()
        self._exec_idle = 0
        self._exec_lock = threading.Lock()
        # Materialization-latency sampling tick (1/32; benign race —
        # a lost increment only shifts which dispatch gets timed).
        self._mat_tick = 0
        # Every executor thread ever spawned (pruned of dead ones at
        # spawn): shutdown() wakes each blocked get() with a None
        # sentinel — without it an idle executor sits out its full 10s
        # poll after shutdown, which the leak sanitizer rightly calls a
        # leaked thread.
        self._exec_threads: list[threading.Thread] = []
        self._actors: dict[ActorID, _Actor] = {}
        self._cancelled: set[bytes] = set()
        self._lock = threading.Lock()
        self._actor_ctor_lock = threading.Lock()
        self._blocked = _BlockedState()
        self._shutdown = threading.Event()
        # Per-bundle resource sets for placement groups: (pg_id, index) -> ResourceSet
        self.bundle_resources: dict[tuple, ResourceSet] = {}
        # Forked-worker pool for isolate_process tasks/actors, created on
        # first use (reference: worker_pool.h:156).
        self._worker_pool = None
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="raylet-dispatch", daemon=True
        )
        self._dispatcher.start()

    @property
    def worker_pool(self):
        if self._worker_pool is None:
            raise NotImplementedError(
                "process isolation (isolate_process) is not ported "
                "(ROADMAP Queue 1: process isolation)")
        return self._worker_pool

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------

    def submit(self, spec: TaskSpec) -> None:
        # Scheduling-latency stamp (submit→start, measured at execution
        # start): one monotonic read + attribute write — cheap enough
        # for the submit hot path, gated for the A/B overhead bench.
        if _perf_stats.ENABLED:
            spec._submit_monotonic = _monotonic()
        if spec.kind == TaskKind.ACTOR_TASK:
            self._submit_actor_task(spec)
            return
        # Tenancy admission: a job at its queued-task ceiling is
        # rejected HERE, with a typed error, before the spec costs the
        # scheduler anything (idempotent per spec — cluster-mixin
        # admission and dep-park resubmits never double-charge).
        reason = self.quota_ledger.note_queued(spec)
        if reason is not None:
            self.worker.store_task_outputs(
                spec, None, error=exc.JobQuotaExceededError(
                    spec.job_id or "", reason))
            return
        if spec.kind == TaskKind.ACTOR_CREATION:
            existing = self._actors.get(spec.actor_id)
            if existing is not None and \
                    existing.state != ActorState.DEAD:
                # Duplicate creation (e.g. a node-death sweep re-driving
                # a spec that also took the normal path): creating a
                # second instance would strand queued calls in a mailbox
                # whose creation can never get resources. Release the
                # admission charge taken above — a swallowed duplicate
                # must not hold a phantom queued slot forever.
                self.quota_ledger.note_dequeued(spec)
                return
            # Register the mailbox immediately so method calls submitted
            # before the creation task is dispatched are queued, mirroring
            # the reference's client-side queueing while an actor is
            # PENDING_CREATION (direct_actor_task_submitter.h).
            self._actors[spec.actor_id] = _Actor(self, spec)
        elif type(spec) is QueuedTaskHeader and _perf_stats.ENABLED:
            _HEADERS_QUEUED.inc()
            _HEADER_BYTES.inc(spec.approx_nbytes())
        deps = spec.dependencies()
        unresolved = [d for d in deps if not self.worker.memory_store.contains(d)]
        if unresolved:
            # Charge the dep-parked demand BEFORE parking: the claim
            # (which releases it) can only happen after park, so the
            # counter never goes negative.
            self._dep_demand.add(self._spec_milli(spec))
            # Park before registering callbacks: a dep landing between
            # the contains() probe and on_ready registration fires the
            # callback inline, and dep_ready must find the entry.
            self._deps.park(spec.task_id.binary(), spec, unresolved)
            for d in unresolved:
                self.worker.memory_store.on_ready(d, self._on_dep_ready)
        else:
            if self._try_fast_dispatch(spec):
                return
            self._pending_add(spec)
            self._ready.put(spec)

    def _try_fast_dispatch(self, spec: TaskSpec) -> bool:
        """Submit-side dispatch bypass: a dependency-free normal task
        with the default strategy, no queue ahead of it, resources free,
        AND a warm idle executor goes straight to the executor pool —
        one thread handoff instead of three (submitter ->
        raylet-dispatch -> executor). This is the in-process analog of
        the reference's pipelined direct task submission. The idle-
        executor gate matters: without it a deep fan-out pays executor
        THREAD CREATION on the submit thread (measured 4x submit-rate
        loss at 30k-task bursts); the dispatcher loop remains the slow
        path for those, for parked work, placement groups, actor
        creations and infeasible requests."""
        if spec.kind != TaskKind.NORMAL_TASK:
            return False
        if type(spec.scheduling_strategy) is not DefaultSchedulingStrategy:
            return False
        # Racy reads are safe: a stale pending/idle value only routes
        # this task to the (always-correct) dispatcher path, or lets a
        # concurrently-submitted task (unordered anyway) jump the
        # queue; a task queued EARLIER by this thread always bumped
        # the pending count synchronously.
        if self._pending.count_approx != 0 or self._exec_idle == 0:
            return False
        if self._cancelled and spec.task_id.binary() in self._cancelled:
            return False
        try:
            request = self._spec_milli(spec)
        except Exception:
            return False  # malformed request: let the dispatcher report it
        if not self.resources.try_acquire(request):
            return False
        if not self.quota_ledger.try_acquire_cpu(spec):
            # Job at its CPU quota: the dispatcher path parks it behind
            # the job's own limit instead of the fast path running it.
            self.resources.release(request)
            return False
        self._launch(spec, self.resources, request)
        return True

    def _on_dep_ready(self, object_id: ObjectID) -> None:
        for spec in self._deps.dep_ready(object_id):
            self._dep_demand.remove(self._spec_milli(spec))
            self._pending_add(spec)
            self._ready.put(spec)

    def _submit_actor_task(self, spec: TaskSpec) -> None:
        actor = self._actors.get(spec.actor_id)
        if actor is None:
            self.worker.store_task_outputs(
                spec, None,
                error=exc.ActorDiedError(
                    spec.actor_id.hex()[:8], "actor handle refers to unknown actor"
                ),
            )
            return
        # State check and enqueue are atomic w.r.t. stop(): otherwise a kill
        # between the check and the put leaves this caller hanging forever.
        with actor.mb_lock:
            enqueued = actor.state != ActorState.DEAD
            if enqueued:
                # Dependencies still gate execution; ordering is preserved by
                # the mailbox (the actor executor blocks on unresolved deps
                # at dequeue time).
                actor.mailbox.put(spec)
                # Multi-slot actors admit up to max_slots concurrent
                # drain passes; a surplus activation that finds the
                # mailbox already drained simply retires.
                needs_activation = actor.pool_mode and \
                    actor.state == ActorState.ALIVE and \
                    actor._active_count < actor.max_slots
            cause = actor.death_cause
        if enqueued:
            if needs_activation:
                # Idle pool-mode actor: schedule a drain pass. PENDING
                # actors drain when their creation dispatches, and an
                # active pass sees this item before deactivating —
                # puts and the deactivation check share mb_lock.
                self._activate_actor(actor)
            return
        self.worker.store_task_outputs(
            spec, None, error=exc.ActorDiedError(spec.actor_id.hex()[:8], cause)
        )

    # ------------------------------------------------------------------
    # Dispatch loop (normal tasks + actor creations)
    # ------------------------------------------------------------------

    def _resource_pool_for(self, spec: TaskSpec) -> ResourceSet:
        strat = spec.scheduling_strategy
        if isinstance(strat, PlacementGroupSchedulingStrategy) and strat.placement_group is not None:
            idx = strat.placement_group_bundle_index
            pg_id = strat.placement_group.id
            if idx >= 0:
                pool = self.bundle_resources.get((pg_id, idx))
                if pool is None:
                    raise exc.PlacementGroupSchedulingError(
                        f"bundle {idx} of placement group {pg_id} is not reserved on this node"
                    )
                return pool
            # index -1: any bundle; pick first that can fit
            request = to_milli(spec.resources)
            for (gid, _i), pool in sorted(self.bundle_resources.items()):
                if gid == pg_id and pool.can_fit_total(request):
                    return pool
            raise exc.PlacementGroupSchedulingError(
                f"no bundle of placement group {pg_id} fits {spec.resources}"
            )
        return self.resources

    def _dispatch_loop(self):
        while not self._shutdown.is_set():
            try:
                if self._waiting_for_resources:
                    # Parked tasks exist: never block on the intake
                    # queue — resource releases (wait_for_change below)
                    # are the wake signal, and sleeping 0.1s here gated
                    # deep-queue drain to slots/0.1s regardless of how
                    # fast tasks actually finish.
                    spec = self._ready.get_nowait()
                else:
                    spec = self._ready.get(timeout=0.1)
            except queue.Empty:
                spec = None
            with self._lock:
                candidates = self._waiting_for_resources
                self._waiting_for_resources = []
            if spec is not None:
                candidates.append(spec)
                # Group-committed dispatch: drain whatever else is
                # already runnable into THIS pass (bounded), so a
                # burst of N queued creations/tasks costs O(N/batch)
                # loop iterations — not one full pass each. Order is
                # preserved (appended in queue order).
                try:
                    for _ in range(255):
                        candidates.append(self._ready.get_nowait())
                except queue.Empty:
                    pass
            still_waiting = []
            for s in candidates:
                if s.task_id.binary() in self._cancelled:
                    self._pending_remove(s)
                    self.quota_ledger.release_cpu(s)
                    self.worker.store_task_outputs(
                        s, None, error=exc.TaskCancelledError(s.describe())
                    )
                    continue
                try:
                    pool = self._resource_pool_for(s)
                    request = self._spec_milli(s)
                except Exception as e:  # malformed spec must not kill dispatch
                    self._pending_remove(s)
                    self.worker.store_task_outputs(
                        s, None,
                        error=e if isinstance(e, exc.RayTpuError)
                        else exc.RayTpuError(f"failed to schedule {s.describe()}: {e}"),
                    )
                    continue
                if not pool.can_fit_total(request):
                    self._pending_remove(s)
                    self.quota_ledger.release_cpu(s)
                    self.worker.store_task_outputs(
                        s, None, error=exc.RayTpuError(
                            f"task {s.describe()} requests {s.resources} which can "
                            f"never be satisfied by this node (total: {pool.total})"
                        )
                    )
                    continue
                if pool.try_acquire(request):
                    # Quota gate AFTER the pool acquire (same order as
                    # _try_fast_dispatch, pool rolled back on denial):
                    # the quota bounds concurrently RUNNING slots, so
                    # a spec that cannot run yet must not hold a
                    # charge that starves its job's smaller tasks.
                    # Actor CREATIONS are charged too (an actor holds
                    # its CPU slots for life — exempting them would
                    # let a tenant run its whole flood as actors);
                    # their charge releases on actor death, not task
                    # completion.
                    if s.kind in (TaskKind.NORMAL_TASK,
                                  TaskKind.ACTOR_CREATION) and \
                            not self.quota_ledger.try_acquire_cpu(s):
                        pool.release(request)
                        still_waiting.append(s)
                        continue
                    self._pending_remove(s)
                    self._launch(s, pool, request)
                else:
                    still_waiting.append(s)
            if still_waiting:
                with self._lock:
                    self._waiting_for_resources = still_waiting + self._waiting_for_resources
                if spec is None:
                    # nothing new arrived; wait for a release instead of spinning
                    self.resources.wait_for_change(timeout=0.05)

    def _launch(self, spec: TaskSpec, pool: ResourceSet, request: Dict[str, int]):
        self.quota_ledger.note_dequeued(spec)  # left the queue: dispatching
        if spec.kind == TaskKind.ACTOR_CREATION:
            actor = self._actors[spec.actor_id]
            if actor.state == ActorState.DEAD:  # killed while pending
                pool.release(request)
                self.quota_ledger.release_cpu(spec)
                return
            actor._held_pool = pool
            actor._held_request = request
            actor.start()
            return
        if type(spec) is QueuedTaskHeader:
            # Compact-queue dispatch boundary: the full TaskSpec exists
            # from here on (and only from here on). Latency is SAMPLED
            # 1/32 — two clock reads per dispatch would tax the path
            # the distribution exists to watch.
            tick = self._mat_tick = self._mat_tick + 1
            if tick & 31:
                spec = spec.materialize()
            else:
                t0 = _monotonic()
                spec = spec.materialize()
                _MATERIALIZE.record(_monotonic() - t0)
        # Reusable executor pool (reference: the worker pool keeps
        # warm workers; here threads): a thread PER task made thread
        # creation the single biggest per-task cost at fan-out
        # rates. Grows on demand (a task blocking in get() holds its
        # thread, idle==0 spawns another), shrinks on idle timeout.
        self._exec_submit(("task", spec, pool, request))

    def _exec_submit(self, item, spawn: bool = True) -> bool:
        """Enqueue one executor work item — a ("task", spec, pool,
        request) dispatch or an ("actor", actor) drain pass — growing
        the pool when no idle executor is promised to serve it.
        ``spawn=False`` is for re-activations from INSIDE an executor
        (that thread returns to the loop and serves the item itself —
        spawning would leak a thread per drain slice).

        Returns True when the item is accounted (an idle promise was
        consumed or a thread spawned). A ``spawn=False`` enqueue at
        idle==0 returns False: the item rides the CALLER's return to
        the loop, so the caller must skip its post-serve idle credit
        or the item double-counts as a phantom idle thread."""
        with self._exec_lock:
            self._exec_q.put(item)  # raylint: disable=R2 -- _exec_q is unbounded, so put() cannot block; enqueue + idle-count bookkeeping must be one atomic step or _exec_loop's retire check double-counts idle threads
            if self._exec_idle == 0:
                if not spawn:
                    return False
                t = threading.Thread(target=self._exec_loop,
                                     name="task-exec", daemon=True)
                self._exec_threads = [
                    th for th in self._exec_threads if th.is_alive()]
                self._exec_threads.append(t)
                t.start()
            else:
                self._exec_idle -= 1
            return True

    def _exec_loop(self):
        while not self._shutdown.is_set():
            try:
                item = self._exec_q.get(timeout=10.0)
            except queue.Empty:
                with self._exec_lock:
                    if not self._exec_q.empty():
                        continue  # a promised item landed: serve it
                    if self._exec_idle > 0:
                        self._exec_idle -= 1  # surplus: retire
                        return
                continue
            if item is None:
                return  # shutdown sentinel: retire immediately
            if item[0] == "actor":
                rode_this_thread = self._drain_actor(item[1])
            else:
                self._execute_normal_task(item[1], item[2], item[3])
                rode_this_thread = False
            with self._exec_lock:
                if not rode_this_thread:
                    self._exec_idle += 1

    # -- shared-executor actor serving (pool mode) ---------------------

    def _activate_actor(self, actor: "_Actor") -> None:
        """Schedule one drain pass for a pool-mode actor, bounded by
        its slot count (``max_slots`` = ``max_concurrency``): at
        max_concurrency=1 a single active pass preserves strict
        mailbox order; multi-slot actors serve up to max_slots items
        concurrently — the slot accounting, not thread count, is the
        concurrency bound."""
        with actor.mb_lock:
            if actor._active_count >= actor.max_slots:
                return
            actor._active_count += 1
        self._exec_submit(("actor", actor))

    # Mailbox items served per drain slice before the pass re-enqueues
    # itself, so one chatty actor cannot monopolize an executor while
    # other work queues.
    _ACTOR_DRAIN_SLICE = 64

    def _drain_actor(self, actor: "_Actor") -> bool:
        """One activation: construct if pending, then serve the mailbox
        until empty (deactivating under mb_lock, atomic with puts) or
        the fairness slice expires (re-enqueue, still active).

        Returns True when the slice re-enqueued itself UNACCOUNTED
        (``_exec_submit(spawn=False)`` at idle==0): the continuation
        rides this thread's return to the loop, so _exec_loop must not
        also credit the thread as idle."""
        if actor.state == ActorState.PENDING:
            # Only the creation-dispatch activation ever sees PENDING
            # (submits gate activation on ALIVE), but multi-slot makes
            # the invariant worth enforcing rather than assuming: a
            # PER-ACTOR ctor guard + re-check — the dedicated path's
            # global ctor lock would serialize a 10k-actor creation
            # storm across the whole pool.
            constructed = True
            with actor.ctor_lock:
                if actor.state == ActorState.PENDING:
                    constructed = actor._construct()
            if not constructed:
                # Constructor failed: _on_actor_death already drained
                # and poisoned the queued calls; retire the activation.
                with actor.mb_lock:
                    actor._active_count -= 1
                return False
        if actor.max_slots > 1:
            # Multi-slot fan-out: items that queued while this actor
            # was PENDING (or while every slot was busy) never
            # triggered an activation — bring concurrent passes up to
            # min(backlog, max_slots) so a burst actually uses the
            # slots. _activate_actor enforces the bound.
            backlog = actor.mailbox.qsize() - 1  # this pass serves one
            while backlog > 0:
                with actor.mb_lock:
                    if actor._active_count >= actor.max_slots:
                        break
                self._activate_actor(actor)
                backlog -= 1
        served = 0
        while True:
            try:
                item = actor.mailbox.get_nowait()
            except queue.Empty:
                with actor.mb_lock:
                    if actor.mailbox.empty():
                        actor._active_count -= 1
                        return False
                continue
            if item is None:
                continue  # stray dedicated-path sentinel: ignore
            if actor.state == ActorState.DEAD:
                self.worker.store_task_outputs(
                    item, None,
                    error=exc.ActorDiedError(actor.actor_id.hex()[:8],
                                             actor.death_cause))
                continue
            self._execute_actor_task(actor, item)
            served += 1
            if served >= self._ACTOR_DRAIN_SLICE and \
                    not self._shutdown.is_set():
                accounted = self._exec_submit(("actor", actor),
                                              spawn=False)
                # Still active: the re-enqueued pass continues. When
                # unaccounted, it continues ON THIS THREAD.
                return not accounted

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    def _execute_normal_task(self, spec: TaskSpec, pool: ResourceSet,
                             request: Dict[str, int]):
        ctx = self.worker.task_context
        ctx.push(task_spec=spec, node_id=self.node_id, pool=pool, request=request)
        events = self.worker.task_events
        events.task_started(spec, self.node_id,
                            threading.current_thread().name)
        submitted = getattr(spec, "_submit_monotonic", None)
        if submitted is not None:
            _SCHED_LATENCY.record(_monotonic() - submitted)
            if _critical_path.enabled():
                _critical_path.record_stage(
                    _trace_id_of(spec), "sched.queue",
                    _monotonic() - submitted)
        try:
            from ray_tpu_torch._private.runtime_env import applied_runtime_env

            args, kwargs = self.worker.resolve_args(spec)
            if spec.isolate_process:
                # Crash isolation: run in a worker process so an
                # os._exit / segfault fails this task, not the node.
                # "spawn" = one-shot fresh interpreter.
                result = self.worker_pool.run(
                    spec.func, args, kwargs, spec.runtime_env,
                    spawn=spec.isolate_process == "spawn", meta=spec)
            else:
                with applied_runtime_env(spec.runtime_env):
                    result = spec.func(*args, **kwargs)
            self.worker.store_task_outputs(spec, self._split_returns(spec, result))
            events.task_finished(spec)
        except BaseException as e:  # noqa: BLE001 - any user failure → object error
            events.task_finished(spec, error=f"{type(e).__name__}: {e}")
            self._handle_task_failure(spec, e)
        finally:
            ctx.pop()
            pool.release(request)
            # Tenancy CPU-slot release (token-guarded no-op for
            # unquota'd jobs): the job's parked work may dispatch now.
            self.quota_ledger.release_cpu(spec)

    def _execute_actor_task(self, actor: _Actor, spec: TaskSpec):
        ctx = self.worker.task_context
        ctx.push(task_spec=spec, node_id=self.node_id, pool=None, request=None)
        events = self.worker.task_events
        events.task_started(spec, self.node_id,
                            threading.current_thread().name)
        submitted = getattr(spec, "_submit_monotonic", None)
        if submitted is not None:
            # For actor tasks this is mailbox queue delay — the actor-
            # path backpressure signal.
            _SCHED_LATENCY.record(_monotonic() - submitted)
            if _critical_path.enabled():
                _critical_path.record_stage(
                    _trace_id_of(spec), "sched.queue",
                    _monotonic() - submitted)
        try:
            args, kwargs = self.worker.resolve_args(spec)
            if actor._proc is not None:
                result = actor._proc.request(("method", spec.func, args,
                                              kwargs))
            else:
                method = getattr(actor.instance, spec.func)
                if inspect.iscoroutinefunction(method):
                    result = actor._loop.run_until_complete(method(*args, **kwargs)) \
                        if actor._loop else asyncio.run(method(*args, **kwargs))
                else:
                    result = method(*args, **kwargs)
            self.worker.store_task_outputs(spec, self._split_returns(spec, result))
            events.task_finished(spec)
        except exc.WorkerCrashedError as e:
            # The actor's worker process died mid-call: restart the
            # actor (within max_restarts) — reference:
            # gcs_actor_manager.h restart FSM on worker failure. The
            # call itself replays on the replacement when its own
            # max_task_retries budget covers it (the restart-window
            # mailbox contract), else rejects naming the budget.
            events.task_finished(spec, error=f"WorkerCrashedError: {e}")
            self._handle_actor_crash(actor, str(e), inflight_spec=spec)
        except BaseException as e:  # noqa: BLE001
            events.task_finished(spec, error=f"{type(e).__name__}: {e}")
            err = e if isinstance(e, exc.TaskError) else exc.TaskError(e, spec.describe())
            self.worker.store_task_outputs(spec, None, error=err)
        finally:
            ctx.pop()

    def _split_returns(self, spec: TaskSpec, result: Any) -> list:
        if spec.num_returns == "dynamic":
            # Generator task (reference num_returns="dynamic"): each
            # yielded value becomes its own object at return indices
            # 1..k (index 0 is the generator ref itself); the task's
            # single return value is an ObjectRefGenerator over them.
            # Yielded objects are recorded on the spec so the cluster
            # report hook advertises their locations too.
            from ray_tpu_torch._private.ids import ObjectID
            from ray_tpu_torch.object_ref import ObjectRef, ObjectRefGenerator

            if not hasattr(result, "__iter__"):
                raise ValueError(
                    f"task {spec.describe()} declared "
                    "num_returns='dynamic' but returned non-iterable "
                    f"{type(result).__name__}")
            refs = []
            dynamic_ids = []
            try:
                for i, value in enumerate(result):
                    oid = ObjectID.for_task_return(spec.task_id, i + 1)
                    self.worker.memory_store.put(oid, value,
                                                 job_id=spec.job_id or "")
                    dynamic_ids.append(oid)
                    refs.append(ObjectRef(oid))
            except BaseException:
                # Mid-iteration failure: drop the partial puts — no ref
                # will ever exist for them, so leaving them would leak
                # store/shm memory proportional to what was yielded.
                refs.clear()  # handles unregister before eviction
                self.worker.memory_store.evict(dynamic_ids)
                raise
            spec.dynamic_return_ids = dynamic_ids
            return [ObjectRefGenerator(refs)]
        if spec.num_returns == 1:
            return [result]
        if spec.num_returns == 0:
            return []
        if not isinstance(result, (tuple, list)) or len(result) != spec.num_returns:
            raise ValueError(
                f"task {spec.describe()} declared num_returns={spec.num_returns} "
                f"but returned {type(result).__name__}"
            )
        return list(result)

    def _handle_task_failure(self, spec: TaskSpec, e: BaseException):
        retryable = False
        if spec.retry_exceptions is True:
            retryable = True
        elif isinstance(spec.retry_exceptions, (list, tuple)):
            retryable = isinstance(e, tuple(spec.retry_exceptions))
        if retryable and spec.max_retries != 0:
            spec.max_retries -= 1
            logger.warning(
                "task %s failed with %s, retrying (%s retries left)",
                spec.describe(), type(e).__name__, spec.max_retries,
            )
            self.submit(spec)
            return
        # Errors arriving from a dependency are already TaskErrors; propagate
        # them unchanged so the original cause surfaces at every get() site.
        err = e if isinstance(e, exc.TaskError) else exc.TaskError(e, spec.describe())
        self.worker.store_task_outputs(spec, None, error=err)

    def _handle_actor_crash(self, actor: _Actor, cause: str,
                            inflight_spec: Optional[TaskSpec] = None):
        """Worker-process death: restart in place if budget remains —
        queued calls survive onto the replacement, and the call that
        was EXECUTING replays ahead of them iff its own
        max_task_retries budget covers it (caller-visible
        replay-or-reject; the reject names the remaining budgets) —
        else die."""
        spec = actor.spec
        # Budget = in-place worker restarts here PLUS head-driven
        # node-death restarts recorded on the spec (restarts_used): the
        # two consume ONE max_restarts allowance, not one each.
        used = actor.num_restarts + getattr(spec, "restarts_used", 0)
        can_restart = spec.max_restarts == -1 or \
            used < spec.max_restarts
        drained = actor.stop(f"worker process crashed: {cause}")
        if actor._proc is not None:
            self.worker_pool.release_dedicated(actor._proc)
            actor._proc = None
        if can_restart:
            pool = getattr(actor, "_held_pool", None)
            if pool is not None:
                actor._held_pool = None
                pool.release(actor._held_request)
            replacement = _Actor(self, spec)
            replacement.num_restarts = actor.num_restarts + 1
            self._actors[actor.actor_id] = replacement
            if inflight_spec is not None:
                if inflight_spec.max_retries != 0:
                    # Replay FIRST — it was dispatched before everything
                    # still queued — charging its per-call budget.
                    if inflight_spec.max_retries > 0:
                        inflight_spec.max_retries -= 1
                    inflight_spec.attempt = getattr(
                        inflight_spec, "attempt", 0) + 1
                    replacement.mailbox.put(inflight_spec)
                else:
                    restarts_left = "-1 (infinite)" \
                        if spec.max_restarts == -1 else str(
                            spec.max_restarts - actor.num_restarts - 1)
                    self.worker.store_task_outputs(
                        inflight_spec, None,
                        error=exc.ActorUnavailableError(
                            f"call {inflight_spec.describe()} was "
                            f"executing when the actor's worker "
                            f"crashed and has no retries left "
                            f"(max_task_retries budget exhausted); "
                            f"actor is RESTARTING "
                            f"({restarts_left} restarts left)"))
            for item in drained:
                replacement.mailbox.put(item)
            self._pending_add(spec)
            self._ready.put(spec)
            return
        if inflight_spec is not None:
            self.worker.store_task_outputs(
                inflight_spec, None,
                error=exc.ActorDiedError(
                    actor.actor_id.hex()[:8],
                    f"{actor.death_cause}; restart budget exhausted "
                    f"(max_restarts={spec.max_restarts})"))
        for item in drained:
            self.worker.store_task_outputs(
                item, None,
                error=exc.ActorDiedError(actor.actor_id.hex()[:8],
                                         actor.death_cause))
        self._on_actor_death(actor, exc.ActorDiedError(
            actor.actor_id.hex()[:8], actor.death_cause))

    def _on_actor_death(self, actor: _Actor, error: BaseException):
        _fire_actor_death_hooks(actor.actor_id)
        if actor._proc is not None:
            self.worker_pool.release_dedicated(actor._proc)
            actor._proc = None
        # Idempotent: release lifetime resources exactly once — the
        # tenancy CPU charge is lifetime-held like the pool slots
        # (restarts keep it; only true death frees it).
        self.quota_ledger.release_cpu(actor.spec)
        pool = getattr(actor, "_held_pool", None)
        if pool is not None:
            actor._held_pool = None
            pool.release(actor._held_request)
        # Free the actor's name for reuse (a dead actor must not poison it).
        self.worker.gcs.remove_named_actor_by_id(actor.actor_id)
        # Fail everything that was still queued at death.
        drained = actor.stop(actor.death_cause or "actor died")
        # Death sweep over the dep-park table: a creation spec of THIS
        # actor still parked on unresolved deps is claimed here — or by
        # a racing _on_dep_ready, never both (DepTable's exactly-once
        # handoff; the loser's path is a no-op). Un-swept it would hold
        # its queued-ceiling admission forever if its dep never fires.
        aid = actor.actor_id
        for item in self._deps.sweep(
                lambda s: getattr(s, "actor_id", None) == aid):
            self._dep_demand.remove(self._spec_milli(item))
            self.quota_ledger.note_dequeued(item)
            drained.append(item)
        for item in drained:
            self.worker.store_task_outputs(
                item, None,
                error=exc.ActorDiedError(actor.actor_id.hex()[:8], actor.death_cause),
            )

    # ------------------------------------------------------------------
    # Control operations
    # ------------------------------------------------------------------

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        actor = self._actors.get(actor_id)
        if actor is None:
            return
        spec = actor.spec
        can_restart = not no_restart and (
            spec.max_restarts == -1
            or actor.num_restarts < spec.max_restarts)
        drained = actor.stop("killed via kill()")
        if actor._proc is not None:
            self.worker_pool.release_dedicated(actor._proc)
            actor._proc = None
        if can_restart:
            # Reference semantics (`gcs_actor_manager.h` restart FSM):
            # re-run the constructor; queued calls survive the restart.
            restarts = actor.num_restarts + 1
            pool = getattr(actor, "_held_pool", None)
            if pool is not None:
                actor._held_pool = None
                pool.release(actor._held_request)
            replacement = _Actor(self, spec)
            replacement.num_restarts = restarts
            self._actors[actor_id] = replacement
            for item in drained:
                replacement.mailbox.put(item)
            self._pending_add(spec)
            self._ready.put(spec)
            return
        for item in drained:
            self.worker.store_task_outputs(
                item, None,
                error=exc.ActorDiedError(actor_id.hex()[:8], actor.death_cause),
            )
        self._on_actor_death(actor, exc.ActorDiedError(actor_id.hex()[:8], "killed"))

    # Template-cached milli-demand (shared core with the head's
    # placement/reservation accounting — resources.spec_milli).
    _spec_milli = staticmethod(spec_milli)

    def _pending_add(self, spec) -> None:
        self._pending.add(self._spec_milli(spec))

    def _pending_remove(self, spec) -> None:
        self.quota_ledger.note_dequeued(spec)
        self._pending.remove(self._spec_milli(spec))

    def pending_demand_milli(self) -> Dict[str, int]:
        """Resource demand of tasks queued but not yet dispatched — the
        backlog signal the cluster scheduler and autoscaler consume
        (reference: raylet backlog reporting in lease requests).
        Maintained incrementally: O(1) per read. Header-queued and
        spec-queued work charge identically (both flow _pending_add
        with the template-cached milli conversion)."""
        return self._pending.demand_milli()

    def backlog_count(self) -> int:
        return self._pending.count()

    def dep_parked_demand_milli(self) -> Dict[str, int]:
        """Demand of dependency-parked work — not runnable yet, so not
        in the backlog signal, but placement of lifetime-pinned work
        (actor creations) must reserve for it."""
        return self._dep_demand.demand_milli()

    def queue_depths(self) -> Dict[str, int]:
        """Scheduler-pressure snapshot for the health plane: tasks
        queued but not dispatched (``backlog``), the subset parked
        waiting for resources, and tasks parked on unresolved
        dependencies (headers and full specs count identically).
        O(1) except the parked list length."""
        with self._lock:
            parked = len(self._waiting_for_resources)
        return {
            "backlog": self._pending.count(),
            "parked_for_resources": parked,
            "waiting_for_deps": self._deps.waiting_count(),
        }

    def actor_state(self, actor_id: ActorID) -> str:
        actor = self._actors.get(actor_id)
        return actor.state if actor else ActorState.DEAD

    def cancel(self, task_id) -> None:
        self._cancelled.add(task_id.binary())

    # -- blocked-worker resource release (block/unblock protocol) --------

    def notify_blocked(self):
        """Called when a worker thread blocks in get(): temporarily release
        its CPU share so other tasks can run (avoids nested-get deadlock)."""
        ctx = self.worker.task_context.current()
        if ctx is None or ctx.get("pool") is None:
            return
        request = ctx.get("request") or {}
        cpu_part = {k: v for k, v in request.items() if k == "CPU" and v > 0}
        if cpu_part:
            ctx["pool"].release(cpu_part)
            self._blocked.stack.append((ctx["pool"], cpu_part))

    def notify_unblocked(self):
        if not getattr(self._blocked, "stack", None):
            return
        pool, cpu_part = self._blocked.stack.pop()
        # Reacquire before continuing; spin on the condition variable.
        while not pool.try_acquire(cpu_part):
            pool.wait_for_change(timeout=0.05)

    def shutdown(self):
        self._shutdown.set()
        # Head role with a sharded control plane: drain the write-behind
        # replication stream first, so a GRACEFUL exit establishes the
        # acked-durable boundary (crash exits intentionally skip this —
        # their loss bound is each shard's open group-commit window).
        head = getattr(self, "head", None)
        router = getattr(head, "shard_router", None) \
            if head is not None else None
        if router is not None:
            try:
                router.flush()
            except Exception:
                pass
        for actor in list(self._actors.values()):
            actor.stop("node shutdown")
            if actor._proc is not None:
                if self._worker_pool is not None:
                    self._worker_pool.release_dedicated(actor._proc)
                else:
                    actor._proc.kill()
                actor._proc = None
        if getattr(self, "_memory_monitor", None) is not None:
            self._memory_monitor.stop()
        if self._worker_pool is not None:
            self._worker_pool.shutdown()
        # Wake every executor blocked in its 10s mailbox poll with a
        # sentinel, then join what can be joined (bounded; never joins
        # the calling thread — shutdown can arrive from a task). A
        # daemon thread would die with the process anyway, but a
        # LONG-LIVED process (a test suite, a driver serving many jobs)
        # must get its threads back at shutdown, not at exit — the leak
        # sanitizer enforces exactly this.
        with self._exec_lock:
            exec_threads = [t for t in self._exec_threads
                            if t.is_alive()]
            for _ in exec_threads:
                self._exec_q.put(None)  # raylint: disable=R2 -- _exec_q is unbounded so put() cannot block; the sentinel count must match the thread census taken under this same hold
        self._dispatcher.join(timeout=1.0)
        me = threading.current_thread()
        joinable = exec_threads + [
            t for actor in list(self._actors.values())
            for t in actor._threads]
        deadline = _monotonic() + 2.0  # shared budget, not per-thread
        for t in joinable:
            if t is not me:
                t.join(timeout=max(0.0, deadline - _monotonic()))
