"""Router + ServeHandle: the data plane.

Reference: `serve/_private/router.py:263` (`assign_replica :224` —
round-robin skipping replicas at `max_concurrent_queries`) and
`serve/handle.py`. Replica membership arrives via long-poll; in-flight
refs are tracked per replica so the cap is enforced client-side.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Any, Dict, List

# Every live Router (weakly held: handles are GC'd freely). Routers own
# two daemon threads each (metrics reporter + long-poll listener), and
# ServeHandles are minted ad hoc — by drivers, replicas, deployment
# graphs — with nothing above them tracking lifetime, so
# ``serve.shutdown()`` sweeps this registry to take the threads back
# down (the leak sanitizer caught them outliving every serve test).
_ROUTERS: "weakref.WeakSet[Router]" = weakref.WeakSet()


def shutdown_all_routers() -> None:
    """Stop every live router's reporter/long-poll threads. Called by
    ``serve.shutdown()`` BEFORE the controller is killed: stop flags
    are set here, then the controller's death errors any in-flight
    long-poll listen, so both threads exit promptly instead of timing
    out a 30s poll."""
    for router in list(_ROUTERS):
        try:
            router.shutdown()
        except Exception:
            pass

import ray_tpu_torch
from ray_tpu_torch._private import critical_path
from ray_tpu_torch._private import sanitize_hooks
from ray_tpu_torch._private import tenancy
from ray_tpu_torch._private.config import ray_config
from ray_tpu_torch._private.task_spec import (set_ambient_job_id,
                                        set_ambient_trace_parent)
from ray_tpu_torch.serve._private import membership


class QueueSaturatedError(TimeoutError):
    """No replica slot freed within the queue timeout. A TimeoutError
    subclass for caller compatibility, but distinguishable from a
    TimeoutError raised BY a deployment — the proxy maps only THIS to
    503 load-shedding; application timeouts stay 500s."""


class Router:
    def __init__(self, controller, deployment_name: str,
                 max_concurrent_queries: int = 100, external_load=None):
        self._controller = controller
        self._deployment = deployment_name
        self._max_concurrent = max_concurrent_queries
        self._replicas: List[Any] = []
        self._rr = itertools.count()
        self._in_flight: Dict[Any, List] = {}
        # Slots claimed under the lock but whose dispatch RPC is still
        # being sent OUTSIDE it (see _try_assign): counted against the
        # per-replica cap so concurrent dispatchers can't oversubscribe
        # a replica while a send is in flight.
        self._reserved: Dict[Any, int] = {}
        # Per-replica in-flight the router did NOT dispatch (the
        # replica-direct fast path's slot table): counted against the
        # cap so the routed fallback cannot oversubscribe a replica the
        # direct path already saturated. ``_external_total`` is the
        # table's whole in-flight count, folded into the autoscaling
        # report (direct traffic must pressure the queue signal).
        self._external_load = external_load
        self._external_total = None
        self._lock = threading.Condition()
        # Per-job weighted fair arbitration over contended replica
        # slots (tenancy enforcement): when requests of several jobs
        # wait for a slot, the job with the smallest virtual time
        # dispatches next — a flood job saturates only its weight
        # share. No-op (one lock read) when enforcement is off.
        self._fair = tenancy.FairShare()
        # Shared per-process membership stream: one long-poll client
        # per (controller, deployment) feeds every router AND the
        # replica-direct table — membership changes fan out once.
        self._watch_sub = membership.watch_replicas(
            controller, deployment_name,
            lambda _seq, snapshot: self._update_replicas(snapshot),
            on_controller=self._set_controller)
        self._last_report = 0.0
        self._waiting = 0  # callers blocked on a free replica slot
        # Periodic reporter: long-running requests dispatch once and then
        # produce no assign_request traffic, which would let the metric
        # go stale while replicas are mid-request (the controller reads
        # stale as idle). Reports continue while anything is in flight
        # and send one final 0 when drained.
        self._reporter_stop = threading.Event()
        self._reporter = threading.Thread(
            target=self._report_loop, daemon=True,
            name=f"router-metrics-{deployment_name}")
        self._reporter.start()
        _ROUTERS.add(self)

    def _set_controller(self, handle):
        """Controller replacement found by the shared watch's reresolve:
        swap the metrics-report target so autoscaling signals resume."""
        self._controller = handle

    def set_external_load(self, fn, total=None) -> None:
        """Late cross-wiring (direct dispatcher created after this
        router — e.g. serve_replica_direct flipped on live)."""
        self._external_load = fn
        self._external_total = total

    def _update_replicas(self, replicas):
        with self._lock:
            self._replicas = list(replicas or [])
            for r in self._replicas:
                self._in_flight.setdefault(r, [])
            self._lock.notify_all()

    def discard_replica(self, replica) -> None:
        """A caller observed this replica die (ActorDiedError) before
        the membership broadcast caught up: stop round-robining onto
        it now. The next long-poll snapshot replaces the list
        wholesale either way."""
        with self._lock:
            if replica in self._replicas:
                self._replicas = [r for r in self._replicas
                                  if r is not replica]

    def _prune(self, replica) -> int:
        refs = self._in_flight.get(replica, [])
        if refs:
            _, not_ready = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0)
            self._in_flight[replica] = list(not_ready)
        return len(self._in_flight.get(replica, []))

    def replica_load(self, replica) -> int:
        """Routed-path in-flight for one replica, UNPRUNED (no
        ray_tpu_torch.wait on the direct fast path): an overestimate only
        makes the direct table decline and the request take the routed
        path, which prunes and decides exactly. Stale refs decay within
        a reporter tick (~1s) or the next routed dispatch attempt."""
        with self._lock:
            return len(self._in_flight.get(replica, ())) \
                + self._reserved.get(replica, 0)

    def _try_assign(self, method: str, args: tuple, kwargs: dict,
                    trace=None, job=None):
        """One round-robin dispatch attempt; returns the ref or None if
        every replica is at its in-flight cap. On success the waiting
        count drops under the SAME lock hold as the slot accounting —
        counting a request as both waiting and in-flight would double
        it in the autoscaling signal.

        The dispatch RPC itself runs OUTSIDE the lock (raylint R2: a
        `.remote()` submission can stall on batcher backpressure, and
        the router lock serializes every other dispatcher). The slot is
        claimed under the lock via ``_reserved`` first, so the cap
        stays exact while the send is in flight.

        ``trace`` is the request's (trace_id, parent_span_id): it rides
        the dispatching thread's ambient trace context so the replica's
        actor task — and every task the replica then submits — joins
        the HTTP request's trace. ``job`` rides the ambient job tag the
        same way: the replica call's spec carries it, so one tenant's
        serve traffic stays attributable through the tasks it fans
        into."""
        # WFQ turn gate: under contention only the minimum-virtual-time
        # job may claim the next slot (the fast path with no waiters
        # always passes). Sits BEFORE any slot probing so a flood job's
        # requests cannot race a freed slot away from a higher-weight
        # tenant parked for it.
        if not self._fair.may_dispatch(job or ""):
            return None
        with self._lock:
            replicas = list(self._replicas)
        if not replicas:
            return None
        n = len(replicas)
        start = next(self._rr)
        for i in range(n):
            replica = replicas[(start + i) % n]
            # Direct-path load read OUTSIDE the router lock (the table
            # has its own leaf lock; nesting the two would add a lock
            # order for no benefit — a slightly stale count only shifts
            # which replica this dispatch probes).
            ext = self._external_load(replica) \
                if self._external_load is not None else 0
            with self._lock:
                load = self._prune(replica) \
                    + self._reserved.get(replica, 0) + ext
                if load >= self._max_concurrent:
                    continue
                self._reserved[replica] = \
                    self._reserved.get(replica, 0) + 1
            dispatched = False
            try:
                prev = set_ambient_trace_parent(trace) \
                    if trace is not None else None
                prev_job = set_ambient_job_id(job) \
                    if job is not None else None
                try:
                    ref = replica.handle_request.remote(
                        method, args, kwargs)
                finally:
                    if trace is not None:
                        set_ambient_trace_parent(prev)
                    if job is not None:
                        set_ambient_job_id(prev_job)
                dispatched = True
            finally:
                # Reserved→in-flight handoff under ONE hold: a gap
                # between the decrement and the append would leave the
                # dispatched request counted by neither, letting a
                # concurrent dispatcher oversubscribe the cap. The
                # yield point marks the handoff boundary for the
                # deterministic-schedule harness: raysan's regression
                # fixture parks a dispatcher here and proves a
                # concurrent one still sees the reserved slot.
                sanitize_hooks.sched_point("router.handoff")
                with self._lock:
                    self._reserved[replica] -= 1
                    if dispatched:
                        self._in_flight.setdefault(
                            replica, []).append(ref)
                        self._waiting -= 1
                        total = self._pending_report_locked()
            if dispatched:
                # Advance the job's virtual time: its next contended
                # turn moves back by 1/weight.
                self._fair.charge(job or "")
                # Trace-plane hop accounting: this request paid a
                # router hop (the replica-direct A/B reads the ratio).
                membership.hop_counter("router").inc()
            self._send_report(total)
            return ref
        return None

    def assign_request(self, method: str, args: tuple, kwargs: dict,
                       timeout: float = 30.0, trace=None, job=None):
        t_enter = time.monotonic()
        deadline = t_enter + timeout
        dispatched = False
        with self._lock:
            self._waiting += 1
        # Fair-share wait registration: while parked, this job's
        # virtual time competes for the next freed slot.
        self._fair.enter_wait(job or "")
        try:
            while True:
                ref = self._try_assign(method, args, kwargs, trace, job)
                if ref is not None:
                    dispatched = True
                    critical_path.record_stage(
                        trace[0] if trace else None, "router.assign",
                        time.monotonic() - t_enter)
                    return ref
                if time.monotonic() > deadline:
                    raise QueueSaturatedError(
                        f"no replica available for {self._deployment} "
                        f"within {timeout}s")
                # Saturated: no dispatch happens, but pressure must
                # still reach the autoscaler — waiting requests ARE the
                # scale-up signal (reference: handle queue metrics count
                # queued + ongoing, `_private/autoscaling_metrics.py`).
                with self._lock:
                    total = self._pending_report_locked()
                self._send_report(total)
                time.sleep(0.005)
        finally:
            self._fair.exit_wait(job or "")
            if not dispatched:
                with self._lock:
                    self._waiting -= 1

    def try_assign_request(self, method: str, args: tuple,
                           kwargs: dict, trace=None, job=None):
        """Non-blocking dispatch: the ref if a replica slot is free
        right now, else None. The event-loop proxy's fast path — no
        coroutine, no parking; saturation falls back to
        :meth:`assign_request_async`."""
        t_enter = time.monotonic()
        with self._lock:
            self._waiting += 1
        ref = self._try_assign(method, args, kwargs, trace, job)
        if ref is None:
            with self._lock:
                self._waiting -= 1
        else:
            critical_path.record_stage(
                trace[0] if trace else None, "router.assign",
                time.monotonic() - t_enter)
        return ref

    async def assign_request_async(self, method: str, args: tuple,
                                   kwargs: dict, timeout: float = 30.0,
                                   trace=None, job=None):
        """Event-loop completion path (the asyncio HTTP proxy's bridge):
        identical dispatch and autoscaling accounting to
        :meth:`assign_request`, but saturation parks the coroutine with
        ``await asyncio.sleep`` instead of blocking the loop thread."""
        import asyncio

        t_enter = time.monotonic()
        deadline = t_enter + timeout
        dispatched = False
        with self._lock:  # raylint: disable=R1 -- microsecond critical section guarding state shared with sync dispatch threads; an asyncio.Lock cannot serialize against them
            self._waiting += 1
        self._fair.enter_wait(job or "")
        try:
            while True:
                ref = self._try_assign(method, args, kwargs, trace, job)
                if ref is not None:
                    dispatched = True
                    critical_path.record_stage(
                        trace[0] if trace else None, "router.assign",
                        time.monotonic() - t_enter)
                    return ref
                if time.monotonic() > deadline:
                    raise QueueSaturatedError(
                        f"no replica available for {self._deployment} "
                        f"within {timeout}s")
                with self._lock:  # raylint: disable=R1 -- microsecond critical section guarding state shared with sync dispatch threads; an asyncio.Lock cannot serialize against them
                    total = self._pending_report_locked()
                self._send_report(total)
                await asyncio.sleep(0.002)
        finally:
            self._fair.exit_wait(job or "")
            if not dispatched:
                with self._lock:  # raylint: disable=R1 -- microsecond critical section guarding state shared with sync dispatch threads; an asyncio.Lock cannot serialize against them
                    self._waiting -= 1

    def _pending_report_locked(self):
        """Under the lock: the metric total to ship, or None inside the
        rate-limit window. The RPC itself (`_send_report`) happens with
        the lock RELEASED — a slow/backpressured controller send must
        never stall request dispatch (raylint R2)."""
        now = time.monotonic()
        if now - self._last_report < 0.5:
            return None
        self._last_report = now
        ext = 0
        if self._external_total is not None:
            try:
                ext = int(self._external_total())
            except Exception:
                ext = 0
        return float(sum(len(v) for v in self._in_flight.values())
                     + self._waiting + ext)

    def _send_report(self, total):
        if total is None:
            return
        try:
            self._controller.record_handle_metrics.remote(
                self._deployment, total)
        except Exception:
            pass

    def _report_loop(self):
        was_busy = False
        while not self._reporter_stop.wait(1.0):
            total = None
            ext_busy = False
            if self._external_total is not None:
                try:
                    ext_busy = self._external_total() > 0
                except Exception:
                    ext_busy = False
            with self._lock:
                busy = ext_busy or self._waiting > 0 or any(
                    self._prune(r) for r in list(self._in_flight))
                if busy or was_busy:  # final 0 on the drain edge
                    self._last_report = 0.0  # bypass the rate limit
                    total = self._pending_report_locked()
                was_busy = busy
            self._send_report(total)

    def shutdown(self):
        self._reporter_stop.set()
        self._watch_sub.unsubscribe()
        _ROUTERS.discard(self)


class ServeHandle:
    """Reference: `serve/handle.py` — `handle.remote(...)`,
    `handle.method_name.remote(...)`."""

    def __init__(self, controller, deployment_name: str,
                 max_concurrent_queries: int = 100, _method: str = ""):
        self._controller = controller
        self._deployment = deployment_name
        self._method = _method
        self._router_holder: Dict[str, Router] = {}
        self._max_concurrent = max_concurrent_queries

    def _direct(self):
        """The deployment's replica-direct dispatcher (shared across
        method handles, like the router) — or None while
        ``serve_replica_direct`` is off. Config is read per call so an
        A/B (or an operator) can flip the fast path live; an existing
        dispatcher keeps its membership subscription either way."""
        if not ray_config.serve_replica_direct:
            return None
        d = self._router_holder.get("d")
        if d is None:
            d = membership.DirectDispatcher(
                self._controller, self._deployment, self._max_concurrent)
            self._router_holder["d"] = d
            # A router may already exist (the knob was flipped on
            # LIVE, after routed traffic created one): cross-wire the
            # two NOW — each path must count the other's per-replica
            # load or the shared cap splits into two.
            r = self._router_holder.get("r")
            if r is not None:
                d.set_router_load(r.replica_load)
                r.set_external_load(d.table.slots_of,
                                    total=d.table.total_in_flight)
        return d

    def _router(self) -> Router:
        r = self._router_holder.get("r")
        if r is None:
            # The router counts the direct table's slots against the
            # per-replica cap, so the two dispatch paths share one
            # concurrency budget per replica. Created through the
            # holder so the dispatcher (and its membership
            # subscription) exists whenever the router does.
            d = self._direct()
            r = Router(self._controller, self._deployment,
                       self._max_concurrent,
                       external_load=d.table.slots_of
                       if d is not None else None)
            if d is not None:
                d.set_router_load(r.replica_load)
                r.set_external_load(d.table.slots_of,
                                    total=d.table.total_in_flight)
            self._router_holder["r"] = r
        return r

    def try_direct(self, *args, _trace=None, _job=None, **kwargs):
        """Replica-direct fast path: ``(ref, token)`` dispatched
        straight to a replica with a free slot (no router, no head), or
        ``(None, None)`` — cold table, saturation, or the fast path
        disabled — in which case the caller takes the routed path. The
        caller MUST release (or, on replica death, invalidate) the
        token when the request completes."""
        d = self._direct()
        if d is None:
            return None, None
        return d.dispatch(self._method or "__call__", args, kwargs,
                          trace=_trace, job=_job)

    def direct_release(self, token) -> None:
        d = self._router_holder.get("d")
        if d is not None:
            d.release(token)

    def direct_invalidate(self, token) -> None:
        d = self._router_holder.get("d")
        if d is not None:
            d.invalidate(token)
        # The routed FALLBACK must not round-robin onto the replica
        # this caller just watched die: drop it from the router's
        # list too, ahead of the membership broadcast.
        r = self._router_holder.get("r")
        if r is not None and token is not None:
            r.discard_replica(token.replica)

    def remote(self, *args, _trace=None, _job=None, **kwargs):
        return self._router().assign_request(self._method or "__call__",
                                             args, kwargs, trace=_trace,
                                             job=_job)

    def remote_async(self, *args, _queue_timeout_s: float = 30.0,
                     _trace=None, _job=None, **kwargs):
        """Awaitable dispatch for event-loop callers (the asyncio HTTP
        proxy): resolves to the ObjectRef once a replica slot frees,
        without ever blocking the calling loop. ``_queue_timeout_s``
        bounds the wait for a slot — the proxy maps its expiry to
        ``503 Retry-After`` (load shedding, not an error). ``_trace``
        is the request's (trace_id, parent_span_id); the replica call
        joins that trace. ``_job`` is the request's job/tenant tag —
        the replica call (and tasks it submits) carries it."""
        return self._router().assign_request_async(
            self._method or "__call__", args, kwargs,
            timeout=_queue_timeout_s, trace=_trace, job=_job)

    def try_remote(self, *args, _trace=None, _job=None, **kwargs):
        """Non-blocking dispatch: the ref now, or None when every
        replica is at its cap (caller then awaits
        :meth:`remote_async` or sheds)."""
        return self._router().try_assign_request(
            self._method or "__call__", args, kwargs, trace=_trace,
            job=_job)

    def __getattr__(self, name: str) -> "ServeHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        h = ServeHandle(self._controller, self._deployment,
                        self._max_concurrent, _method=name)
        h._router_holder = self._router_holder  # share router + caps
        return h

    def __reduce__(self):
        return (ServeHandle, (self._controller, self._deployment,
                              self._max_concurrent, self._method))
