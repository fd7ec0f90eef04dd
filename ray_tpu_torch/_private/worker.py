"""The per-process runtime singleton and the public API implementation.

Role-equivalent to the reference's ``python/ray/_private/worker.py`` plus the
CoreWorker it wraps: owns the memory store, assigns object IDs for puts and
task returns, resolves task arguments, and implements ``init / shutdown /
get / put / wait / kill / cancel``. Execution is delegated to a backend: the
in-process ``LocalBackend`` by default, or a multiprocess cluster backend.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Any, Dict, Optional, Sequence

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import state as state_mod
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.local_backend import LocalBackend
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch.object_ref import ObjectRef

logger = logging.getLogger(__name__)

_global_worker: Optional["Worker"] = None
_init_lock = threading.Lock()


class _TaskContext(threading.local):
    """Per-thread stack of executing tasks (nested via reentrant get)."""

    def _stack(self):
        if not hasattr(self, "stack"):
            self.stack = []
        return self.stack

    def push(self, **kw):
        self._stack().append(kw)

    def pop(self):
        self._stack().pop()

    def current(self) -> Optional[dict]:
        s = self._stack()
        return s[-1] if s else None


class Worker:
    """The runtime embedded in the driver (and, conceptually, each worker)."""

    # Compact queued submissions (QueuedTaskHeader) are accepted by the
    # in-process backends; the thin ray-client proxy is not marked, so
    # remote() keeps building full specs there (the client wire contract
    # ships TaskSpec).
    supports_compact_submit = True

    def __init__(self, resources: Dict[str, float], namespace: Optional[str] = None):
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.from_random()
        self.namespace = namespace or f"ns-{self.job_id.hex()}"
        self.memory_store = MemoryStore()
        # Disk spilling under memory pressure (reference:
        # local_object_manager.h:41 + external_storage.py). The manager
        # object is cheap; its spill directory is only created on the
        # first actual spill. Budget/thresholds live in the config table.
        from ray_tpu_torch._private.spilling import SpillManager

        self.memory_store.spill_manager = SpillManager(self.memory_store)
        self.task_context = _TaskContext()
        from ray_tpu_torch._private.task_events import TaskEventBuffer

        self.task_events = TaskEventBuffer()
        self._put_counter_lock = threading.Lock()
        self._put_counters: dict[bytes, int] = {}
        self._driver_task_id = TaskID.from_random()
        # Set by SharedPlane.install in cluster mode: large values are
        # published to the node's shm segment for zero-copy cross-process
        # reads (plasma-provider role).
        # The port has no shm plane (ROADMAP Queue 1): it stays None.
        self.shm_plane = None
        self.backend = LocalBackend(self, resources)
        # Named actors / placement groups / KV — the "GCS" of this runtime.
        self.gcs = state_mod.GlobalState(self)

    # ------------------------------------------------------------------
    # Object plumbing
    # ------------------------------------------------------------------

    def current_task_id(self) -> TaskID:
        ctx = self.task_context.current()
        if ctx is not None:
            return ctx["task_spec"].task_id
        return self._driver_task_id

    def next_put_id(self) -> ObjectID:
        task_id = self.current_task_id()
        with self._put_counter_lock:
            idx = self._put_counters.get(task_id.binary(), 0) + 1
            self._put_counters[task_id.binary()] = idx
        return ObjectID.for_put(task_id, idx)

    def put_object(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError(
                "Calling put() on an ObjectRef is not allowed; pass the ref directly."
            )
        from ray_tpu_torch._private.task_spec import job_id_for_submit

        ctx = self.task_context.current()
        oid = self.next_put_id()
        self.memory_store.put(
            oid, value,
            job_id=job_id_for_submit(ctx["task_spec"] if ctx else None))
        return ObjectRef(oid)

    def get_objects(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None):
        self.backend.notify_blocked()
        try:
            return self.memory_store.get_many([r.id for r in refs], timeout)
        except exc.TaskError as e:
            raise e.as_instanceof_cause() from None
        finally:
            self.backend.notify_unblocked()

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        self.backend.notify_blocked()
        try:
            ready_ids, _ = self.memory_store.wait(
                [r.id for r in refs], num_returns, timeout
            )
        finally:
            self.backend.notify_unblocked()
        # Two-pointer merge: the store returns ready ids as an ordered
        # subsequence of the input, so refs partition in one pass (a
        # by-id dict rebuilt per call was measurable at 1k-ref scale).
        ready, not_ready = [], []
        pos, n_ready = 0, len(ready_ids)
        for ref in refs:
            if pos < n_ready and ref.id == ready_ids[pos]:
                ready.append(ref)
                pos += 1
            else:
                not_ready.append(ref)
        return ready, not_ready

    # ------------------------------------------------------------------
    # Task plumbing (called by the backend)
    # ------------------------------------------------------------------

    def resolve_args(self, spec: TaskSpec):
        """Replace top-level ObjectRefs in args/kwargs with their values.

        Nested refs (inside containers) are passed through as refs —
        borrowing semantics, matching the reference.
        """

        def _resolve(v):
            if isinstance(v, ObjectRef):
                return self.memory_store.get(v.id)
            return v

        args = tuple(_resolve(a) for a in spec.args)
        kwargs = {k: _resolve(v) for k, v in spec.kwargs.items()}
        return args, kwargs

    def store_task_outputs(self, spec: TaskSpec, values, error=None):
        job = getattr(spec, "job_id", "") or ""
        if error is not None:
            for oid in spec.return_ids:
                self.memory_store.put(oid, None, error=error, job_id=job)
            return
        for oid, value in zip(spec.return_ids, values):
            self.memory_store.put(oid, value, job_id=job)

    def submit(self, spec: TaskSpec) -> list[ObjectRef]:
        refs = [ObjectRef(oid) for oid in spec.assign_return_ids()]
        self.backend.submit(spec)
        return refs

    # -- local handle refcounting ---------------------------------------

    def register_object_ref(self, ref: ObjectRef) -> int:
        return self.memory_store.add_local_ref(ref.id)

    def unregister_object_ref(self, oid: ObjectID) -> bool:
        return self.memory_store.remove_local_ref(oid)

    def shutdown(self):
        # Cluster-driver plumbing first (fetch dispatcher + release
        # batcher, installed by ClusterDriverMixin): both block on
        # their own wakeups and must be told the worker is going away.
        stop_plumbing = getattr(self, "stop_cluster_plumbing", None)
        if stop_plumbing is not None:
            stop_plumbing()
        self.backend.shutdown()
        # Drain deferred durable writes before the process lets go of
        # the store (group-commit makes the window between accept and
        # commit a few ms; shutdown is a durability boundary).
        close = getattr(self.gcs, "close_storage", None)
        if close is not None:
            close()
        manager = self.memory_store.spill_manager
        if manager is not None:
            manager.storage.destroy()


# ----------------------------------------------------------------------
# Module-level API (exported via ray_tpu_torch/__init__.py)
# ----------------------------------------------------------------------


def global_worker() -> Worker:
    if _global_worker is None:
        # Auto-init may race with another thread's first API call; the lock
        # inside init() makes the loser reuse the winner's worker.
        init(ignore_reinit_error=True)
    return _global_worker


def global_worker_or_none() -> Optional[Worker]:
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None


def init(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: Optional[str] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    address: Optional[Any] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    **kwargs,
) -> "Worker":
    """Start (or connect to) the runtime.

    Reference: ``ray.init`` (``python/ray/_private/worker.py:1096``). Here a
    single-node in-process runtime is brought up, with the CUDA devices
    that torch sees counted as ``"GPU"`` (``num_gpus`` overrides the
    count). The cluster and client (``address=``) modes are not ported:
    ``address`` raises ``NotImplementedError``.
    """
    global _global_worker
    with _init_lock:
        if _global_worker is not None:
            if ignore_reinit_error:
                return _global_worker
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True "
                "or call ray_tpu_torch.shutdown() first."
            )
        if address is not None:
            raise NotImplementedError(
                "client mode (init(address=...)) is not ported (ROADMAP "
                "Queue 1: client mode)")
        from ray_tpu_torch._private.config import apply_system_config

        apply_system_config(_system_config)
        total: Dict[str, float] = {"CPU": float(num_cpus if num_cpus is not None
                                                else os.cpu_count() or 1)}
        import torch

        gpus = torch.cuda.device_count()
        total["GPU"] = float(num_gpus) if num_gpus is not None else float(gpus)
        if object_store_memory:
            total["object_store_memory"] = float(object_store_memory)
        total.update(resources or {})
        total = {k: v for k, v in total.items() if v > 0 or k == "CPU"}
        _global_worker = Worker(total, namespace=namespace)
        atexit.register(shutdown)
        return _global_worker


def shutdown():
    global _global_worker
    with _init_lock:
        if _global_worker is not None:
            _global_worker.shutdown()
            _global_worker = None


def get(refs, *, timeout: Optional[float] = None):
    w = global_worker()
    if isinstance(refs, ObjectRef):
        return w.get_objects([refs], timeout)[0]
    if isinstance(refs, list):
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r).__name__}")
        return w.get_objects(refs, timeout)
    raise TypeError(f"get() expects an ObjectRef or list, got {type(refs).__name__}")


def put(value) -> ObjectRef:
    return global_worker().put_object(value)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None,
         fetch_local: bool = True):
    if not isinstance(refs, list) or not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("wait() expects a list of ObjectRefs")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns <= 0 or num_returns > len(refs):
        raise ValueError(
            f"num_returns must be in [1, {len(refs)}], got {num_returns}"
        )
    return global_worker().wait(refs, num_returns, timeout, fetch_local)


def kill(actor_handle, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    w = global_worker()
    w.gcs.remove_named_actor_by_id(actor_handle._actor_id)
    w.backend.kill_actor(actor_handle._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    global_worker().backend.cancel(ref.task_id())
