"""Shared replica membership + the replica-direct dispatch plane.

Reference: `serve/_private/long_poll.py` feeding `http_state.py` /
`router.py` — ONE long-poll subscription per (controller, deployment)
per process, fanned out to every consumer. Before this module each
``Router`` owned its own ``LongPollClient`` (N handles = N identical
long-poll streams); now membership changes arrive once per process and
fan out locally to:

- every ``Router`` of the deployment (the routed path's replica list);
- the deployment's :class:`ReplicaDirectTable` — the proxy fleet's
  steady-state fast path: a versioned membership + per-replica slot
  table the proxy dispatches through DIRECTLY (proxy→replica, no
  router lock, no per-request ref pruning, no head involvement),
  falling back to the routed path only on saturation, empty
  membership, or replica death.

Cache-invalidation rule (the one that matters for correctness): a
long-poll version bump REPLACES the table's membership atomically
under the table lock — an ``acquire`` that observes the new version
can never return a replica whose removal that version committed. The
raymc ``replica_direct`` scenario proves this (plus exact slot
accounting) over every bounded interleaving of the
``serve.direct.acquire`` / ``serve.direct.update`` /
``serve.direct.release`` seams.

:class:`ReplicaDirectTable` is a pure decision core in the
``tenancy.py`` / ``actor_gate.py`` discipline: locks and counters, no
RPC, no threads — the product wiring (long-poll thread, actor calls)
lives in :class:`DirectDispatcher` and the watch registry around it.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import perf_stats as _perf_stats
from ray_tpu_torch._private import sanitize_hooks

# Control-plane hops per dispatched request, the trace-plane proof that
# replica-direct steady state skips the router: the routed path crosses
# "router" once per dispatch, the fast path crosses "direct", and a
# direct dispatch that died under the caller and re-dispatched through
# the router crosses "fallback". ray_tpu_serve_hops_total{hop} after
# the runtime-metrics fold.
def hop_counter(hop: str):
    return _perf_stats.counter("serve_hops", {"hop": hop})


class DirectToken:
    """One claimed replica slot. ``release`` / ``invalidate`` consume
    it exactly once (idempotent — a double release must not free
    somebody else's slot)."""

    __slots__ = ("replica", "version", "consumed")

    def __init__(self, replica: Any, version: int):
        self.replica = replica
        self.version = version
        self.consumed = False


class ReplicaDirectTable:
    """Versioned replica membership + per-replica in-flight slots.

    Invariants (raymc ``replica_direct``):

    - an ``acquire`` never returns a replica absent from the CURRENT
      committed membership — once ``update(v)`` removing ``r`` returns,
      no later acquire yields ``r``;
    - per-replica slots never exceed ``cap`` and never go negative —
      releases of tokens for since-removed replicas are dropped, not
      miscounted against the replacement membership.
    """

    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self.cap = max(1, int(cap))
        self.version = -1
        self._members: List[Any] = []
        self._slots: Dict[Any, int] = {}
        self._rr = 0
        # Cache-affinity hints: replica actor name -> prefix-digest doc
        # ({"seed", "block_tokens", "block_bytes", "keys", "model"}),
        # fed by the controller's digests:: long-poll channel. Purely
        # advisory — acquire() without an affinity hint (or with no
        # digests) keeps the round-robin contract the raymc
        # replica_direct scenario proves.
        self._digests: Dict[str, dict] = {}
        # Replicas a CALLER observed dead before long-poll caught up:
        # filtered out of every snapshot until a committed membership
        # no longer contains them (then the tombstone drops — the name
        # could in principle be reused).
        self._dead: set = set()

    def update(self, version: int, replicas) -> bool:
        """Commit a membership snapshot. Stale (<= current) versions
        are ignored — the long-poll channel delivers in order, but a
        racing manual refresh must never regress the table."""
        sanitize_hooks.sched_point("serve.direct.update")
        with self._lock:
            if version <= self.version:
                return False
            self.version = version
            members = [r for r in (replicas or []) if r not in self._dead]
            self._dead = {r for r in self._dead
                          if r in (replicas or [])}
            self._members = members
            # Slot rows of removed replicas drop with the membership:
            # their outstanding tokens release into the void (guarded
            # in release()), never against a replacement's accounting.
            self._slots = {r: self._slots.get(r, 0) for r in members}
            return True

    def set_digests(self, digests: Optional[Dict[str, dict]]) -> None:
        """Replace the affinity-hint table (controller broadcast). A
        malformed snapshot degrades to no hints, never to an error on
        the dispatch path."""
        if not isinstance(digests, dict):
            digests = {}
        with self._lock:
            self._digests = {str(k): v for k, v in digests.items()
                             if isinstance(v, dict)}

    @staticmethod
    def _affinity_order(members, slots, digests, affinity_tokens):
        """Reorder `members` by matched-prefix bytes against each
        replica's exported digest keys (desc), tie-broken by fewest
        held slots. Members without a positive score keep their
        round-robin relative order at the tail. Pure: called on
        SNAPSHOTS, outside the table lock."""
        from ray_tpu_torch._private.kv_cache import chain_keys

        chains: Dict[tuple, list] = {}
        scored = []
        for pos, r in enumerate(members):
            doc = digests.get(str(getattr(r, "_actor_name", "")) or "")
            score = 0
            if doc:
                try:
                    bt = int(doc.get("block_tokens", 0))
                    seed = doc.get("seed", "")
                    keys = doc.get("keys") or ()
                    if bt > 0 and keys:
                        ck = (seed, bt)
                        chain = chains.get(ck)
                        if chain is None:
                            chain = chains[ck] = chain_keys(
                                affinity_tokens, bt, seed)
                        keyset = set(keys)
                        matched = 0
                        for key in chain:
                            if key not in keyset:
                                break
                            matched += 1
                        score = matched * int(doc.get("block_bytes", 1))
                except Exception:
                    score = 0
            scored.append((-score, slots.get(r, 0), pos, r))
        scored.sort(key=lambda t: t[:3])
        return [t[3] for t in scored], bool(scored and -scored[0][0] > 0)

    def acquire(self, extra_load=None,
                affinity_tokens=None) -> Optional[DirectToken]:
        """Claim one slot on a member with headroom (round-robin), or
        None when every member is at cap / membership is empty.

        ``extra_load(replica)`` is the ROUTED path's per-replica
        in-flight count (unpruned, so an overestimate — when in doubt
        the request routes, which is always correct): the two dispatch
        paths share one per-replica concurrency budget from both
        sides. It is called OUTSIDE the table lock; the claim re-checks
        membership under the lock, so a replica removed between the
        snapshot and the claim is skipped — the no-stale-dispatch
        property the raymc scenario proves.

        ``affinity_tokens`` (an LLM request's prompt head) reorders the
        candidates by matched-prefix bytes against each replica's
        exported digests — a prefix-cache hit skips the shared-head
        prefill, which dwarfs any load-skew cost. Capacity still wins:
        a scored replica at cap falls through to the next candidate."""
        with self._lock:
            members = list(self._members)
            start = self._rr
            self._rr += 1
            digests = dict(self._digests) if affinity_tokens else None
            slots_snap = dict(self._slots) if affinity_tokens else None
        # The yield point sits IN the race window: membership snapshot
        # taken, claim not yet committed — the interleaving raymc
        # orders an update's removal into (the under-lock containment
        # re-check below is what keeps the property true).
        sanitize_hooks.sched_point("serve.direct.acquire")
        n = len(members)
        order = [members[(start + i) % n] for i in range(n)]
        affine = False
        if affinity_tokens and digests:
            order, affine = self._affinity_order(
                order, slots_snap, digests, affinity_tokens)
        for idx, replica in enumerate(order):
            ext = extra_load(replica) if extra_load is not None else 0
            with self._lock:
                held = self._slots.get(replica)
                if held is None:
                    continue  # removed since the snapshot: never claim
                if held + ext < self.cap:
                    self._slots[replica] = held + 1
                    if affine:
                        _perf_stats.counter(
                            "serve_affinity_routed",
                            {"placed": "best" if idx == 0
                             else "spill"}).inc()
                    if affinity_tokens:
                        # Hit = the request landed on its best-scored
                        # cache-affine replica; anything else (no
                        # digest overlap, or the best replica was at
                        # cap and the claim spilled) is a miss the
                        # hit-rate panel should see.
                        hit = affine and idx == 0
                        _perf_stats.counter(
                            "serve_affinity_hits" if hit
                            else "serve_affinity_misses").inc()
                    return DirectToken(replica, self.version)
        if affinity_tokens:
            _perf_stats.counter("serve_affinity_misses").inc()
        return None

    def release(self, token: Optional[DirectToken]) -> None:
        if token is None or token.consumed:
            return
        token.consumed = True
        sanitize_hooks.sched_point("serve.direct.release")
        with self._lock:
            held = self._slots.get(token.replica)
            if held is not None and held > 0:
                self._slots[token.replica] = held - 1
            # else: the replica left membership while the token was
            # out — its row is gone and stays gone.

    def invalidate(self, token: Optional[DirectToken]) -> None:
        """A dispatch through ``token`` failed with replica death: drop
        the replica from membership NOW (long-poll will confirm) and
        release the slot."""
        if token is None:
            return
        with self._lock:
            replica = token.replica
            if replica in self._slots:
                self._members = [r for r in self._members
                                 if r is not replica]
                self._slots.pop(replica, None)
            self._dead.add(replica)
        token.consumed = True

    def slots_of(self, replica: Any) -> int:
        """Direct-path in-flight for one replica — the router adds this
        to its own accounting so the per-replica cap spans BOTH
        dispatch paths."""
        with self._lock:
            return self._slots.get(replica, 0)

    def total_in_flight(self) -> int:
        """All direct-path in-flight — folded into the router's
        autoscaling report so a fleet serving entirely via the fast
        path still pressures the controller's queue signal (without
        this the autoscaler reads ~0 and scales a loaded fleet down)."""
        with self._lock:
            return sum(self._slots.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"version": self.version,
                    "members": len(self._members),
                    "in_flight": sum(self._slots.values())}


# -- shared long-poll membership watches -------------------------------------


class _SubEntry:
    """Per-subscriber delivery state: monotonic in seq, so a
    subscribe-time replay racing a live delivery can never regress the
    subscriber to an older snapshot."""

    __slots__ = ("cb", "seq", "lock")

    def __init__(self, cb: Callable):
        self.cb = cb
        self.seq = -1
        self.lock = threading.Lock()

    def deliver(self, seq: int, snapshot) -> None:
        with self.lock:
            if seq <= self.seq:
                return
            self.seq = seq
            try:
                self.cb(seq, snapshot)
            except Exception:
                pass


class _DeploymentWatch:
    """One long-poll subscription per (controller, channel) in this
    process; subscribers (routers, direct tables) get every snapshot —
    and the latest one immediately on subscribe."""

    def __init__(self, key, controller, channel: str):
        from ray_tpu_torch.serve._private.long_poll import LongPollClient

        self._key = key
        self._channel = channel
        self._controller = controller
        self._lock = threading.Lock()
        self._subs: List[_SubEntry] = []
        self._controller_subs: List[Callable] = []
        self._last = None
        self._seq = 0  # local commit counter: the table's version feed
        self._stopped = False  # set by retire; subscribe refuses after
        self._client = LongPollClient(
            controller, channel, self._on_change,
            reresolve=self._reresolve)

    def _reresolve(self):
        from ray_tpu_torch.serve._private.controller import (
            resolve_live_controller,
        )

        handle = resolve_live_controller()
        if handle is not None:
            with self._lock:
                self._controller = handle
                listeners = list(self._controller_subs)
            # Consumers that talk to the controller themselves (router
            # metrics reports) retarget to the replacement.
            for cb in listeners:
                try:
                    cb(handle)
                except Exception:
                    pass
        return handle

    def _on_change(self, snapshot):
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._last = (seq, snapshot)
            subs = list(self._subs)
        for entry in subs:
            entry.deliver(seq, snapshot)

    def subscribe(self, cb: Callable, on_controller: Optional[Callable]
                  = None) -> Optional["_Subscription"]:
        """None when this watch lost a race with its retirement (the
        last unsubscribe stopped the long-poll stream between the
        registry lookup and this call) — the caller creates a fresh
        watch instead of riding a stopped stream forever."""
        entry = _SubEntry(cb)
        with self._lock:
            if self._stopped:
                return None
            self._subs.append(entry)
            if on_controller is not None:
                self._controller_subs.append(on_controller)
            last = self._last
        if last is not None:
            entry.deliver(*last)
        return _Subscription(self, entry, on_controller)

    def _unsubscribe(self, entry, on_controller) -> bool:
        """Returns True when this was the last subscriber (the caller
        retires the watch)."""
        with self._lock:
            if entry in self._subs:
                self._subs.remove(entry)
            if on_controller is not None and \
                    on_controller in self._controller_subs:
                self._controller_subs.remove(on_controller)
            return not self._subs

    def stop(self):
        self._client.stop()


class _Subscription:
    __slots__ = ("_watch", "_entry", "_on_controller", "_done")

    def __init__(self, watch, entry, on_controller):
        self._watch = watch
        self._entry = entry
        self._on_controller = on_controller
        self._done = False

    def unsubscribe(self):
        if self._done:
            return
        self._done = True
        if self._watch._unsubscribe(self._entry, self._on_controller):
            _retire_watch(self._watch)


_WATCH_LOCK = threading.Lock()
_WATCHES: Dict[Any, _DeploymentWatch] = {}


def _controller_key(controller) -> Any:
    aid = getattr(controller, "_actor_id", None)
    return aid.binary() if aid is not None else id(controller)


def watch_channel(controller, channel: str, cb: Callable,
                  on_controller: Optional[Callable] = None
                  ) -> _Subscription:
    """Subscribe ``cb(seq, snapshot)`` to any controller long-poll
    channel, sharing one stream per (controller, channel) in this
    process. The last unsubscribe stops the stream; a subscriber
    racing that retirement retries against a fresh watch (subscribe on
    a stopped watch returns None, never a dead subscription)."""
    key = (_controller_key(controller), channel)
    while True:
        with _WATCH_LOCK:
            watch = _WATCHES.get(key)
            if watch is None:
                watch = _WATCHES[key] = _DeploymentWatch(
                    key, controller, channel)
        sub = watch.subscribe(cb, on_controller)
        if sub is not None:
            return sub
        # Lost the race with _retire_watch: drop the stopped watch
        # from the registry ourselves (the retiring thread may not
        # have reached its delete yet) so the next iteration builds a
        # fresh one instead of spinning on the corpse.
        with _WATCH_LOCK:
            if _WATCHES.get(key) is watch:
                del _WATCHES[key]


def watch_replicas(controller, deployment: str, cb: Callable,
                   on_controller: Optional[Callable] = None
                   ) -> _Subscription:
    """Subscribe ``cb(seq, replicas)`` to the deployment's membership
    channel (see :func:`watch_channel`)."""
    return watch_channel(controller, f"replicas::{deployment}", cb,
                         on_controller)


def _retire_watch(watch: _DeploymentWatch) -> None:
    # Commit the stop under the WATCH lock, re-checking for a
    # subscriber that slipped in after the last unsubscribe: either
    # the late subscriber lands first (subs non-empty — the watch
    # stays live) or the stop commits first (the late subscriber's
    # subscribe() sees _stopped and retries on a fresh watch). No
    # interleaving leaves a subscriber on a stopped stream.
    with watch._lock:
        if watch._subs:
            return
        watch._stopped = True
    with _WATCH_LOCK:
        if _WATCHES.get(watch._key) is watch:
            del _WATCHES[watch._key]
    watch.stop()


def shutdown_all_watches() -> None:
    """Stop every membership stream (serve.shutdown's safety net for
    watches whose subscribers never unsubscribed)."""
    with _WATCH_LOCK:
        watches = list(_WATCHES.values())
        _WATCHES.clear()
    for watch in watches:
        watch.stop()


# -- the dispatcher (product wiring around the table) ------------------------


# Live dispatchers, for serve.shutdown (weak: handles are GC'd freely).
_DISPATCHERS: "weakref.WeakSet[DirectDispatcher]" = weakref.WeakSet()


def shutdown_all_dispatchers() -> None:
    for d in list(_DISPATCHERS):
        try:
            d.shutdown()
        except Exception:
            pass


class DirectDispatcher:
    """Replica-direct dispatch for one deployment: claim a slot in the
    shared table, fire the actor call with the request's ambient
    trace/job context, and hand the caller a token to release (or
    invalidate) on completion. The routed path stays the fallback for
    saturation, cold tables, and replica death."""

    def __init__(self, controller, deployment: str, cap: int):
        self._deployment = deployment
        self.table = ReplicaDirectTable(cap)
        # The routed path's per-replica in-flight probe (set when the
        # deployment's Router exists): both paths see each other's
        # load, so neither can oversubscribe a replica the other
        # saturated.
        self._router_load = None
        self._sub = watch_replicas(controller, deployment,
                                   self.table.update)
        # Cache-affinity hints ride their own channel (hot prefix
        # digests change far more often than membership — versioning
        # them through update() would churn the slot table).
        self._dig_sub = watch_channel(
            controller, f"digests::{deployment}",
            lambda _seq, snap: self.table.set_digests(snap))
        _DISPATCHERS.add(self)

    @staticmethod
    def _affinity_hint(args: tuple, kwargs: dict):
        """An LLM request's prompt head (the affinity key), or None for
        non-LLM payloads. Sniffed, not schema'd: the dispatcher serves
        arbitrary deployments and must never fail on shape."""
        from ray_tpu_torch._private.config import ray_config

        if not ray_config.llm_affinity_routing:
            return None
        payload = args[0] if args else kwargs.get("request")
        if not isinstance(payload, dict):
            return None
        toks = payload.get("prompt_ids")
        if not isinstance(toks, (list, tuple)) or not toks:
            return None
        # The digest match only needs the head; hashing a megaprompt
        # per candidate scoring pass would tax the dispatch path.
        return list(toks[:512])

    def set_router_load(self, fn) -> None:
        self._router_load = fn

    def dispatch(self, method: str, args: tuple, kwargs: dict,
                 trace=None, job=None):
        """(ref, token) on success, (None, None) when the table has no
        free member (caller falls back to the routed path)."""
        from ray_tpu_torch._private import critical_path
        from ray_tpu_torch._private.task_spec import (set_ambient_job_id,
                                                set_ambient_trace_parent)

        t_acquire = time.monotonic()
        token = self.table.acquire(
            extra_load=self._router_load,
            affinity_tokens=self._affinity_hint(args, kwargs))
        if token is None:
            return None, None
        # Stage span: slot claim incl. the affinity-scoring pass (the
        # dispatch RPC below is charged to the proxy's dispatch stage).
        critical_path.record_stage(
            trace[0] if trace else None, "direct.acquire",
            time.monotonic() - t_acquire)
        try:
            prev = set_ambient_trace_parent(trace) \
                if trace is not None else None
            prev_job = set_ambient_job_id(job) if job is not None else None
            try:
                ref = token.replica.handle_request.remote(
                    method, args, kwargs)
            finally:
                if trace is not None:
                    set_ambient_trace_parent(prev)
                if job is not None:
                    set_ambient_job_id(prev_job)
        except BaseException:
            self.table.release(token)
            raise
        hop_counter("direct").inc()
        return ref, token

    def release(self, token) -> None:
        self.table.release(token)

    def invalidate(self, token) -> None:
        """Caller observed the token's replica die: drop it from the
        table ahead of the long-poll confirmation."""
        _perf_stats.counter(
            "serve_direct_invalidations",
            {"deployment": self._deployment}).inc()
        self.table.invalidate(token)

    def shutdown(self) -> None:
        self._sub.unsubscribe()
        self._dig_sub.unsubscribe()
