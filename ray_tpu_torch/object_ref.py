"""ObjectRef: a handle to a (possibly pending) immutable object.

Mirrors ``python/ray/includes/object_ref.pxi`` in the reference: holds the
binary object ID, participates in local reference counting (handle count in
the owning process), and is serializable so refs can be passed as task
arguments or stored inside other objects (borrowing).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from ray_tpu_torch._private.ids import ObjectID, TaskID

if TYPE_CHECKING:
    pass


class ObjectRef:
    __slots__ = ("_id", "_owned", "__weakref__")

    def __init__(self, object_id: ObjectID, _register: bool = True):
        self._id = object_id
        self._owned = False
        if _register:
            from ray_tpu_torch._private import worker as _worker_mod

            w = _worker_mod.global_worker_or_none()
            if w is not None:
                w.register_object_ref(self)
                self._owned = True

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self) -> TaskID:
        return self._id.task_id()

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        import concurrent.futures

        from ray_tpu_torch._private import worker as _worker_mod

        fut: concurrent.futures.Future = concurrent.futures.Future()
        w = _worker_mod.global_worker()

        def _on_ready(_oid):
            ready, value, error = w.memory_store.peek(self._id)
            assert ready
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(value)

        w.memory_store.on_ready(self._id, _on_ready)
        return fut

    def as_future(self, loop=None):
        """Return an ``asyncio.Future`` on ``loop`` (default: the running
        loop) resolving to the value. Unlike :meth:`future` +
        ``asyncio.wrap_future`` this is one cross-thread hop
        (``call_soon_threadsafe``) per completion, which matters on the
        event-loop ingress hot path. Task failures resolve to the
        user-level exception, matching ``ray_tpu_torch.get``."""
        import asyncio

        from ray_tpu_torch import exceptions as _exc
        from ray_tpu_torch._private import worker as _worker_mod

        if loop is None:
            loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()
        w = _worker_mod.global_worker()

        def _on_ready(_oid):
            ready, value, error = w.memory_store.peek(self._id)
            assert ready
            if isinstance(error, _exc.TaskError):
                error = error.as_instanceof_cause()

            def _set():
                if fut.cancelled():
                    return
                if error is not None:
                    fut.set_exception(error)
                else:
                    fut.set_result(value)

            try:
                loop.call_soon_threadsafe(_set)
            except RuntimeError:
                # Loop closed (e.g. proxy shutdown mid-request): the
                # future's consumer is gone; do not break the store's
                # callback chain for other waiters.
                pass

        w.memory_store.on_ready(self._id, _on_ready)
        return fut

    def __await__(self):
        import asyncio

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.wrap_future(self.future()).__await__()
        return self.as_future().__await__()

    def __hash__(self) -> int:
        return hash(self._id)

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()[:16]})"

    def __reduce__(self):
        # Deserialization re-registers the handle with the local worker,
        # which is how borrowed refs enter the local refcount.
        return (ObjectRef, (self._id,))

    def __del__(self):
        if self._owned:
            try:
                from ray_tpu_torch._private import worker as _worker_mod

                w = _worker_mod.global_worker_or_none()
                if w is not None:
                    w.unregister_object_ref(self._id)
            except Exception:  # interpreter shutdown
                pass


class ObjectRefGenerator:
    """The value of a ``num_returns="dynamic"`` task: an iterable of the
    ObjectRefs created for the task's yielded outputs (reference:
    ``ray._raylet.ObjectRefGenerator``). Holding the generator (or any
    ref from it) keeps the corresponding objects alive."""

    __slots__ = ("_refs",)

    def __init__(self, refs):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self) -> int:
        return len(self._refs)

    def __getitem__(self, i) -> "ObjectRef":
        return self._refs[i]

    def __repr__(self) -> str:
        return f"ObjectRefGenerator({len(self._refs)} refs)"
