"""Scheduler-state cores: the dep-park table and lock-partitioned maps.

Two building blocks for O(small) per-task control-plane cost at
1M-queued-task / 10k-actor scale:

- :class:`DepTable` — the dependency-parked work ledger, extracted from
  ``LocalBackend``'s inline dict pair into a pure decision core (same
  discipline as ``actor_gate.py`` / ``tenancy.py``: locks and counters,
  no RPC, no threads, no product imports) so the bounded model checker
  (``tools/raymc`` ``dep_sweep`` scenario) can prove the
  exactly-once-handoff invariant between the ready path and a death
  sweep over every interleaving at small scope — ROADMAP FT gap (d).
  Reference role: ``dependency_manager.h`` queued-task bookkeeping.

- :class:`ShardedTable` — a dict partitioned over independently-locked
  shards, the lock-partitioned form of the head's hot scheduling
  tables (in-flight dispatches, object directory, lineage). Concurrent
  submit batches and node object reports touch different shards and
  stop serializing on one head lock; per-key operations stay atomic
  under their shard's lock. Reference role: the GCS tables are
  per-component services with independent locks, not one mutex.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import sanitize_hooks


def round_up_pow2(n: int) -> int:
    """Smallest power of two >= max(1, n) — shard counts must be
    powers of two so ``hash(key) & mask`` partitions evenly."""
    out = 1
    while out < max(1, int(n)):
        out <<= 1
    return out


def stable_shard_of(key: bytes, n_shards: int) -> int:
    """Process-stable key -> shard partition (crc32, NOT the builtin
    ``hash`` — that one is salted per process). This is the map the
    multi-process head (``_private/head_shards.py``) routes by: the
    same key must land on the same shard across coordinator restarts
    so a failed-over head finds durable rows where its predecessor
    left them. In-process ``ShardedTable`` partitioning keeps the
    cheaper salted hash — its shards share one address space and never
    outlive the process."""
    if n_shards <= 1:
        return 0
    if not isinstance(key, (bytes, bytearray)):
        key = repr(key).encode()
    import zlib

    return zlib.crc32(key) % n_shards


def milli_add(acc: Dict[str, int], milli: Dict[str, int]) -> None:
    """Accumulate a milli-resource request into ``acc`` in place."""
    for k, v in milli.items():
        acc[k] = acc.get(k, 0) + v


def milli_sub(acc: Dict[str, int], milli: Dict[str, int]) -> None:
    """Subtract a milli-resource request from ``acc`` in place,
    pruning keys at (or clamping below) zero."""
    for k, v in milli.items():
        left = acc.get(k, 0) - v
        if left > 0:
            acc[k] = left
        else:
            acc.pop(k, None)


class DepTable:
    """Dependency-parked queued work with exactly-once handoff.

    A parked item is CLAIMED exactly once — either by the ready path
    (its last unresolved dependency arrived; :meth:`dep_ready` returns
    it) or by a sweep (its actor died, the node is shutting down;
    :meth:`sweep` returns it) — never both, never neither. The loser of
    a ready/sweep race observes nothing. Claim state is the presence of
    the item's remaining-count row: both paths delete it atomically
    under the one lock, and per-dep list entries whose row is gone are
    stale and skipped (and purged by the next sweep), so an item parked
    under several dependencies is still handed out once.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # dep key -> [(item key, item)] still parked under that dep.
        self._by_dep: Dict[Any, List[Tuple[bytes, Any]]] = {}
        # item key -> remaining unresolved deps; presence IS the claim.
        self._counts: Dict[bytes, int] = {}

    def park(self, key: bytes, item: Any, deps: List[Any]) -> None:
        """Park ``item`` until every dep in ``deps`` has fired (caller
        guarantees ``deps`` is non-empty and de-duplicated)."""
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.dep.park", "call", self,
                                   (key, item, deps))
        with self._lock:
            self._counts[key] = len(deps)
            for dep in deps:
                self._by_dep.setdefault(dep, []).append((key, item))
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.dep.park", "ret", self, None)

    def dep_ready(self, dep: Any) -> List[Any]:
        """One dependency resolved: returns the items this completes
        (claimed — the caller now owns dispatching them)."""
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.dep.ready", "call", self, dep)
        sanitize_hooks.sched_point("sched.dep_ready")
        out: List[Any] = []
        with self._lock:
            for key, item in self._by_dep.pop(dep, ()):
                left = self._counts.get(key)
                if left is None:
                    continue  # claimed by a sweep while parked
                if left > 1:
                    self._counts[key] = left - 1
                else:
                    del self._counts[key]
                    out.append(item)
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.dep.ready", "ret", self, out)
        return out

    def sweep(self, match: Callable[[Any], bool]) -> List[Any]:
        """Claim and return every still-parked item ``match`` selects
        (death sweep / shutdown). Purges the claimed items' entries
        from every per-dep list — a dep that never fires must not pin
        swept items forever."""
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.dep.sweep", "call", self, None)
        sanitize_hooks.sched_point("sched.dep_sweep")
        out: List[Any] = []
        with self._lock:
            claimed: set = set()
            for dep in list(self._by_dep):
                kept = []
                for key, item in self._by_dep[dep]:
                    if key in claimed:
                        continue  # claimed via an earlier dep's list
                    if key not in self._counts:
                        continue  # stale: already handed out — purge
                    if match(item):
                        del self._counts[key]
                        claimed.add(key)
                        out.append(item)
                    else:
                        kept.append((key, item))
                if kept:
                    self._by_dep[dep] = kept
                else:
                    del self._by_dep[dep]
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.dep.sweep", "ret", self, out)
        return out

    def waiting_count(self) -> int:
        """Items parked and unclaimed (the ``waiting_for_deps`` gauge)."""
        with self._lock:
            return len(self._counts)

    def parked_entries(self) -> int:
        """Total per-dep list entries (leak canary for tests: stale
        entries of claimed items must not accumulate unboundedly)."""
        with self._lock:
            return sum(len(v) for v in self._by_dep.values())


class ShardedTable:
    """A mapping partitioned over independently-locked dict shards.

    Per-key operations (get/set/pop/contains) are atomic under the
    key's shard lock only, so operations on different shards run
    concurrently. Iteration (:meth:`items` / :meth:`values`) snapshots
    shard-by-shard — consistent per shard, not across shards — which is
    the contract the head's sweep/scan users already tolerate (a report
    racing a death sweep could always land wholly before or after it).
    Callers holding an UNRELATED outer lock may call in (shard locks
    are leaf locks: nothing is acquired while one is held).
    """

    __slots__ = ("_shards", "_locks", "_mask")

    def __init__(self, shards: int = 16):
        n = round_up_pow2(shards)
        self._mask = n - 1
        self._shards: List[dict] = [{} for _ in range(n)]
        self._locks = [threading.Lock() for _ in range(n)]

    def _ix(self, key) -> int:
        return hash(key) & self._mask

    # Per-key ops carry rayspec taps (spec.table.*): the recorded
    # concurrent history must refine ONE flat dict — the spec the
    # lock-partitioned form exists to preserve. Iteration stays
    # untapped: its contract is explicitly weaker (per-shard, not
    # cross-shard, consistency) and outside the refinement map.

    def get(self, key, default=None):
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.get", "call", self, key)
        i = self._ix(key)
        with self._locks[i]:
            out = self._shards[i].get(key, default)
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.get", "ret", self, (key, out))
        return out

    def __contains__(self, key) -> bool:
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.contains", "call", self, key)
        i = self._ix(key)
        with self._locks[i]:
            out = key in self._shards[i]
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.contains", "ret", self,
                                   (key, out))
        return out

    def __setitem__(self, key, value) -> None:
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.set", "call", self,
                                   (key, value))
        i = self._ix(key)
        with self._locks[i]:
            self._shards[i][key] = value
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.set", "ret", self, (key, None))

    def __getitem__(self, key):
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.get", "call", self, key)
        i = self._ix(key)
        with self._locks[i]:
            out = self._shards[i][key]
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.get", "ret", self, (key, out))
        return out

    def pop(self, key, default=None):
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.pop", "call", self, key)
        i = self._ix(key)
        with self._locks[i]:
            out = self._shards[i].pop(key, default)
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.pop", "ret", self, (key, out))
        return out

    def setdefault(self, key, default):
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.setdefault", "call", self,
                                   (key, default))
        i = self._ix(key)
        with self._locks[i]:
            out = self._shards[i].setdefault(key, default)
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.table.setdefault", "ret", self,
                                   (key, out))
        return out

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def items(self) -> List[tuple]:
        out: List[tuple] = []
        for i, shard in enumerate(self._shards):
            with self._locks[i]:
                out.extend(shard.items())
        return out

    def values(self) -> List[Any]:
        return [v for _, v in self.items()]

    def keys(self) -> List[Any]:
        return [k for k, _ in self.items()]


class PendingCounter:
    """Incremental queued-demand accounting under its own small lock
    (split off the backend's dep/bookkeeping lock so the submit fast
    path's add/remove never contends with dep parking): total queued
    count plus summed milli-resource demand — the backlog signal
    (reference: raylet backlog reporting in lease requests)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._milli: Dict[str, int] = {}
        self._count = 0

    def add(self, milli: Dict[str, int]) -> None:
        with self._lock:
            self._count += 1
            milli_add(self._milli, milli)

    def remove(self, milli: Dict[str, int]) -> None:
        with self._lock:
            self._count = max(0, self._count - 1)
            milli_sub(self._milli, milli)

    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def count_approx(self) -> int:
        """Lock-free read for racy fast-path gates (a stale value only
        routes work to the always-correct slow path)."""
        return self._count

    def demand_milli(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._milli)


def class_is_async(cls) -> Optional[bool]:
    """Cached "does this actor class define any coroutine method"
    probe: the inspect.getmembers scan costs ~100µs per call, which at
    10k-actor creation rates was a visible per-creation tax. Bounded
    cache (dynamically minted classes must not pin forever); None when
    ``cls`` is not a class."""
    import inspect

    if not inspect.isclass(cls):
        return None
    cached = _ASYNC_CACHE.get(cls)
    if cached is None:
        cached = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(
                cls, predicate=inspect.isfunction))
        with _ASYNC_CACHE_LOCK:
            if len(_ASYNC_CACHE) >= 4096:
                _ASYNC_CACHE.clear()
            _ASYNC_CACHE[cls] = cached
    return cached


_ASYNC_CACHE: Dict[type, bool] = {}
_ASYNC_CACHE_LOCK = threading.Lock()
