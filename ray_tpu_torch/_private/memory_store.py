"""In-process object store: the future/value table behind ObjectRefs.

Equivalent in role to the reference's CoreWorker memory store
(``src/ray/core_worker/store_provider/memory_store/memory_store.h``): it
holds resolved values (or errors) for object IDs owned by this process and
lets callers block or register callbacks on unresolved ones. Values are
stored as Python objects (zero-copy; jax/numpy arrays are immutable in
practice), with promotion to the shared-memory store handled a level up.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch._private import perf_stats as _perf_stats
from ray_tpu_torch._private import sanitize_hooks
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectLostError

# Wait-path observability: how often wait() resolves from the snapshot
# pass alone vs. parking on a _WaitGroup wake-up — the event-driven
# completion path PR 2 introduced (a wake-up storm here means waiters
# are subscribing faster than completions batch).
_WAIT_CALLS = _perf_stats.counter("wait_calls")
_WAIT_SNAPSHOT_HITS = _perf_stats.counter("wait_snapshot_hits")
_WAIT_WAKEUPS = _perf_stats.counter("wait_wakeups")


@dataclass
class _Entry:
    event: threading.Event = field(default_factory=threading.Event)
    value: Any = None
    error: Optional[BaseException] = None
    ready: bool = False
    callbacks: list = field(default_factory=list)
    # number of ObjectRef handles alive in this process (best-effort GC)
    local_refs: int = 0
    # primary-copy pin (cluster nodes pin task outputs until the head's
    # free — orthogonal to handle refs so borrow edge-detection stays
    # count==1/count==0)
    pinned: bool = False
    # spilling bookkeeping: estimated in-memory size; disk URL once the
    # value has been spilled (value is then None until restored)
    size: int = 0
    last_access: float = 0.0
    spilled_url: Optional[str] = None
    # value is a zero-copy view over the node's shm segment (the bytes
    # live in the arena, not this heap): excluded from the heap spill
    # budget and from heap spill candidacy — the SharedPlane owns its
    # lifecycle (pin released on entry drop, arena spill under
    # pressure).
    shm_backed: bool = False
    # the shm-backed value has been handed to an in-process reader
    # (get/peek/get_many) since the swap: such a reader may retain an
    # INNER array viewing the arena pages (invisible to a refcount
    # check on the container), so the entry is no longer arena-spill
    # eligible — its block must never be reused under a live view.
    shm_read: bool = False
    # Job/tenant tag of the task (or driver put) that produced this
    # object — the per-job object-store accounting key ("" = untagged).
    job_id: str = ""


class _WaitGroup:
    """One completion-event subscriber shared across a whole wait() call
    (the completion-event queue role of the reference's memory-store
    GetAsync path): entries signal it as they resolve, and it fires once
    the countdown hits zero. Replaces the old per-ref callback + shared
    condition scheme, whose cost was O(refs) lock/condvar round trips per
    wait even when every ref was already resolved."""

    __slots__ = ("event", "_needed", "_lock")

    def __init__(self, needed: int):
        self.event = threading.Event()
        self._needed = needed
        self._lock = threading.Lock()

    def on_ready(self, _object_id) -> None:
        with self._lock:
            self._needed -= 1
            if self._needed > 0:
                return
        self.event.set()


class MemoryStore:
    def __init__(self, spill_manager=None):
        # RLock: ObjectRef.__del__ can fire from GC while this process holds
        # the lock (allocation inside _entry triggers collection), re-entering
        # remove_local_ref on the same thread.
        self._lock = threading.RLock()
        self._entries: dict[ObjectID, _Entry] = {}
        # Optional SpillManager (ray_tpu_torch._private.spilling): set by the
        # worker when an object-store budget is configured.
        self.spill_manager = spill_manager
        # Optional spill observer fn(object_id, url): cluster mode wires
        # this to the head's spill-URL directory so a lost object with a
        # surviving disk copy restores instead of re-executing. Called
        # OUTSIDE the store lock, best-effort.
        self.on_spilled = None

    def _entry(self, object_id: ObjectID) -> _Entry:
        entry = self._entries.get(object_id)
        if entry is None:
            entry = _Entry()
            self._entries[object_id] = entry
        return entry

    def put(self, object_id: ObjectID, value: Any,
            error: Optional[BaseException] = None,
            job_id: str = "", shm: bool = False) -> None:
        """``shm=True`` marks the value as a zero-copy view over the
        node segment (a shm/transfer fetch): its bytes are arena-
        resident, so it is excluded from the heap spill budget and the
        plane's pin (released on entry drop) owns its lifetime."""
        sanitize_hooks.sched_point("store.put")
        manager = self.spill_manager
        with self._lock:
            entry = self._entry(object_id)
            if entry.ready:
                return  # immutable once written
            entry.value = value
            entry.error = error
            entry.ready = True
            entry.shm_backed = shm and error is None
            if job_id:
                entry.job_id = job_id
            entry.last_access = time.monotonic()
            if manager is not None and error is None:
                from ray_tpu_torch._private.spilling import estimate_size

                entry.size = estimate_size(value)
                if not entry.shm_backed:
                    manager.note_put(entry.size)
            callbacks = entry.callbacks
            entry.callbacks = []
        entry.event.set()
        for cb in callbacks:
            cb(object_id)
        if manager is not None and manager.over_threshold():
            manager.maybe_spill()

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.ready

    def job_object_stats(self) -> dict:
        """Per-job object accounting: job_id -> (objects, bytes) over
        resident entries (spilled values count — the job still owns
        them). Untagged entries roll up under ``""`` so the per-job
        rows always sum to the store's real footprint. Sizes are only
        estimated when a spill budget is configured; counts are always
        exact."""
        out: dict = {}
        with self._lock:
            for entry in self._entries.values():
                if not entry.ready:
                    continue
                n, b = out.get(entry.job_id, (0, 0))
                out[entry.job_id] = (n + 1, b + (entry.size or 0))
        return out

    def on_ready(self, object_id: ObjectID, callback: Callable[[ObjectID], None]) -> None:
        """Invoke callback when object resolves (immediately if already done)."""
        with self._lock:
            entry = self._entry(object_id)
            if not entry.ready:
                entry.callbacks.append(callback)
                return
        callback(object_id)

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        """Block for and return the value; raises the stored error if any."""
        with self._lock:
            entry = self._entry(object_id)
        if not entry.event.wait(timeout):
            raise GetTimeoutError(
                f"get() timed out after {timeout}s waiting for {object_id}"
            )
        # Snapshot value+url together under the lock: a concurrent
        # spiller setting value=None between two bare reads must not be
        # observable as a silent None result.
        with self._lock:
            error, value, url = entry.error, entry.value, entry.spilled_url
            entry.last_access = time.monotonic()
            if entry.shm_backed and value is not None:
                entry.shm_read = True
        if error is not None:
            raise error
        if url is not None and value is None:
            return self._restore(object_id, entry, url)
        return value

    def peek(self, object_id: ObjectID):
        """Return (ready, value, error) without blocking (except a
        transparent disk restore for spilled values)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.ready:
                return False, None, None
            error, value, url = entry.error, entry.value, entry.spilled_url
            entry.last_access = time.monotonic()
            if entry.shm_backed and value is not None:
                entry.shm_read = True
        if error is None and url is not None and value is None:
            return True, self._restore(object_id, entry, url), None
        return True, value, error

    def _restore(self, object_id: ObjectID, entry: _Entry, url: str):
        """Load a spilled value back (reference: restore IO worker path,
        `external_storage.py` restore_spilled_objects). Uses the caller's
        snapshotted url — a concurrent free()/evict() may clear the entry
        and delete the file, which must surface as the entry's error (or
        a typed loss), never a raw file error."""
        try:
            value = self.spill_manager.restore(url)
        except OSError:
            with self._lock:
                error = entry.error
            if error is not None:
                raise error
            raise ObjectLostError(
                object_id.hex(),
                f"spilled copy of {object_id} disappeared (released "
                f"concurrently?)")
        with self._lock:
            if entry.error is not None:
                raise entry.error
            if entry.value is None:
                entry.value = value
                entry.last_access = time.monotonic()
                self.spill_manager.note_put(entry.size)
            return entry.value

    def wait(self, object_ids: list[ObjectID], num_returns: int,
             timeout: Optional[float]) -> tuple[list[ObjectID], list[ObjectID]]:
        """Block until ``num_returns`` of ``object_ids`` are ready.

        Returns (ready, not_ready) preserving input order, matching the
        semantics of ``ray.wait`` (reference ``_private/worker.py:2565``).
        Event-driven: one lock pass snapshots what is already resolved;
        only unresolved entries get a (single, shared) completion
        subscriber, so a wait over N resolved refs costs one lock
        acquisition, not N callback registrations.
        """
        sanitize_hooks.sched_point("store.wait")
        target = min(num_returns, len(object_ids))
        group: Optional[_WaitGroup] = None
        entries = self._entries
        with self._lock:
            ready = []
            unresolved: list[ObjectID] = []
            for oid in object_ids:
                entry = entries.get(oid)
                if entry is not None and entry.ready:
                    ready.append(oid)
                else:
                    unresolved.append(oid)
            if len(ready) < target and (timeout is None or timeout > 0):
                group = _WaitGroup(target - len(ready))
                for oid in unresolved:
                    self._entry(oid).callbacks.append(group.on_ready)
        _WAIT_CALLS.inc()
        if group is None:
            _WAIT_SNAPSHOT_HITS.inc()
        else:
            group.event.wait(timeout)
            _WAIT_WAKEUPS.inc()
            # Re-snapshot: completions that raced the wakeup count.
            with self._lock:
                ready_set = {
                    oid for oid in object_ids
                    if (e := entries.get(oid)) is not None and e.ready
                }
            ready = [oid for oid in object_ids if oid in ready_set]
        # At most num_returns ready refs are returned (ray.wait
        # contract); extras stay in not_ready even if resolved.
        if len(ready) > num_returns:
            ready = ready[:num_returns]
        if not unresolved and len(ready) == len(object_ids):
            return ready, []
        ready_out = set(ready)
        not_ready = [oid for oid in object_ids if oid not in ready_out]
        return ready, not_ready

    def get_many(self, object_ids: list[ObjectID],
                 timeout: Optional[float] = None) -> list:
        """Values for every id, in order. One lock pass serves the
        already-resolved plain entries (the fan-out-get hot path:
        ``get([N refs])`` after completion was N lock+event round trips);
        pending, errored, or spilled entries fall back to the blocking
        per-object ``get`` under a shared deadline."""
        values = [None] * len(object_ids)
        slow: list[int] = []
        now = time.monotonic()
        with self._lock:
            for i, oid in enumerate(object_ids):
                entry = self._entries.get(oid)
                if entry is not None and entry.ready \
                        and entry.error is None \
                        and not (entry.spilled_url is not None
                                 and entry.value is None):
                    values[i] = entry.value
                    entry.last_access = now
                    if entry.shm_backed and entry.value is not None:
                        entry.shm_read = True
                else:
                    slow.append(i)
        if slow:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            for i in slow:
                remaining = None
                if deadline is not None:
                    remaining = max(0.0, deadline - time.monotonic())
                values[i] = self.get(object_ids[i], remaining)
        return values

    # -- shm-backed entries (SharedPlane swap/spill) ----------------------

    def swap_to_shm(self, object_id: ObjectID, shm_value: Any) -> bool:
        """Replace a resident heap value with its zero-copy shm view
        (the producer just published it into the arena): the heap copy
        is released and the entry's bytes stop counting against the
        heap spill budget. True when the entry is (now) shm-backed."""
        manager = self.spill_manager
        heap_size = 0
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.ready or \
                    entry.error is not None:
                return False
            if entry.shm_backed:
                return True  # idempotent: already swapped
            if entry.value is None or entry.spilled_url is not None:
                return False
            entry.value = shm_value
            entry.shm_backed = True
            # Pre-swap readers got the HEAP value; view-retention
            # tracking restarts with the fresh shm view.
            entry.shm_read = False
            heap_size = entry.size
        if manager is not None and heap_size:
            manager.note_drop(heap_size)
        return True

    def entry_job(self, object_id: ObjectID) -> str:
        """Producing job of a ready entry ("" = untagged/unknown) — how
        the shared arena charges object bytes to tenants."""
        with self._lock:
            entry = self._entries.get(object_id)
            return "" if entry is None else entry.job_id

    def entry_size(self, object_id: ObjectID) -> int:
        """Estimated payload size of a ready entry (0 when unknown) —
        what object-location reports carry for locality scoring."""
        with self._lock:
            entry = self._entries.get(object_id)
            return 0 if entry is None else (entry.size or 0)

    def spill_shm_entry(self, object_id: ObjectID, plane) -> Optional[int]:
        """Spill a swapped (shm-backed) entry's payload to disk and
        flip the entry to URL-backed, so the caller (the plane's
        pressure sweep) can drop its pin and reclaim the arena block.
        Returns the payload size, or None when the entry is ineligible:
        not shm-backed, errored, or possibly still viewed by an
        in-process reader (whose zero-copy arrays would dangle if the
        arena block were reused) — any local read since the swap
        disqualifies it, since a reader may retain an INNER array the
        container's refcount cannot witness."""
        import sys

        manager = self.spill_manager
        if manager is None:
            return None
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.ready or \
                    entry.error is not None or not entry.shm_backed \
                    or entry.value is None or entry.shm_read:
                return None
            # Belt over the read-tracking braces: entry.value slot +
            # getrefcount's argument temporary = 2; anything above
            # means someone holds the container right now.
            if sys.getrefcount(entry.value) > 2:
                return None
        payload = plane.payload_bytes(object_id.binary())
        if payload is None:
            return None
        url = manager.spill_payload(object_id, payload)
        sanitize_hooks.sched_point("spill.mark")
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.ready or entry.value is None \
                    or not entry.shm_backed or entry.shm_read \
                    or sys.getrefcount(entry.value) > 2:
                stale = True
            else:
                entry.value = None
                entry.spilled_url = url
                entry.shm_backed = False
                stale = False
        if stale:
            manager.delete([url])
            return None
        self._notify_spilled(object_id, url)
        return len(payload)

    # -- spilling hooks (called by SpillManager) --------------------------

    def spill_candidates(self):
        """Cold→hot list of (oid, value, size, existing_url) eligible to
        spill: ready, no error, value resident, big enough."""
        from ray_tpu_torch._private.config import ray_config

        with self._lock:
            out = [
                (e.last_access, oid, e.value, e.size, e.spilled_url)
                for oid, e in self._entries.items()
                if e.ready and e.error is None and e.value is not None
                and not e.shm_backed
                and e.size >= ray_config.min_spilling_size_bytes
            ]
        # last_access captured under the lock: entries may be deleted
        # concurrently, and the sort must not reach back into the dict.
        out.sort(key=lambda item: item[0])
        return [(oid, value, size, url)
                for _, oid, value, size, url in out]

    def mark_spilled(self, object_id: ObjectID, url: str) -> bool:
        """Drop the in-memory value, keeping the disk URL. Returns False
        if the entry disappeared (released meanwhile) — or became
        shm-backed (a publish swap raced the sweep's snapshot: the
        arena owns the bytes now, the heap sweep must not flip it)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.ready or entry.value is None \
                    or entry.shm_backed:
                return False
            entry.value = None
            entry.spilled_url = url
        self._notify_spilled(object_id, url)
        return True

    def _notify_spilled(self, object_id: ObjectID, url: str) -> None:
        hook = self.on_spilled
        if hook is not None:
            try:
                hook(object_id, url)
            except Exception:
                pass

    def _drop_entry_locked(self, entry: _Entry) -> Optional[str]:
        """Common release path: account the dropped bytes, hand back any
        spill URL for deletion."""
        manager = self.spill_manager
        if manager is not None and entry.ready and entry.error is None \
                and entry.value is not None and not entry.shm_backed:
            manager.note_drop(entry.size)
        return entry.spilled_url

    # -- local reference counting (process-lifetime GC) ------------------

    def add_local_ref(self, object_id: ObjectID) -> int:
        """Returns the new local handle count (1 = first handle)."""
        with self._lock:
            entry = self._entry(object_id)
            entry.local_refs += 1
            return entry.local_refs

    def local_ref_count(self, object_id: ObjectID) -> int:
        with self._lock:
            entry = self._entries.get(object_id)
            return 0 if entry is None else max(entry.local_refs, 0)

    def remove_local_ref(self, object_id: ObjectID) -> bool:
        """Returns True when this drop took the handle count to zero."""
        url = None
        zero = False
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                return False
            entry.local_refs -= 1
            if entry.local_refs <= 0:
                zero = True
                if entry.ready and not entry.pinned:
                    url = self._drop_entry_locked(entry)
                    del self._entries[object_id]
        if url is not None and self.spill_manager is not None:
            self.spill_manager.delete([url])
        return zero

    def pin_object(self, object_id: ObjectID) -> None:
        """Keep the local copy regardless of handle count (plasma
        primary-copy role); released by `unpin_object` or `evict`."""
        with self._lock:
            self._entry(object_id).pinned = True

    def unpin_object(self, object_id: ObjectID) -> None:
        url = None
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                return
            entry.pinned = False
            if entry.local_refs <= 0 and entry.ready:
                url = self._drop_entry_locked(entry)
                del self._entries[object_id]
        if url is not None and self.spill_manager is not None:
            self.spill_manager.delete([url])

    def evict(self, object_ids: list[ObjectID]) -> None:
        """Drop local copies entirely (unlike `free`, which poisons the
        entry): a later get blocks until the object is re-fetched or
        reconstructed. Used by the cluster cache and spilling."""
        urls = []
        with self._lock:
            for oid in object_ids:
                entry = self._entries.pop(oid, None)
                if entry is not None:
                    url = self._drop_entry_locked(entry)
                    if url is not None:
                        urls.append(url)
        if urls and self.spill_manager is not None:
            self.spill_manager.delete(urls)

    def free(self, object_ids: list[ObjectID]) -> None:
        urls = []
        with self._lock:
            for oid in object_ids:
                entry = self._entries.get(oid)
                if entry is not None and entry.ready:
                    url = self._drop_entry_locked(entry)
                    if url is not None:
                        urls.append(url)
                        entry.spilled_url = None
                    entry.value = None
                    entry.shm_backed = False
                    entry.error = ObjectLostError(oid.hex(), f"object {oid} was freed")
        if urls and self.spill_manager is not None:
            self.spill_manager.delete(urls)

    def num_objects(self) -> int:
        with self._lock:
            return len(self._entries)
