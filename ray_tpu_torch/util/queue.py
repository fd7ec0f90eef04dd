"""Actor-backed distributed Queue (reference `python/ray/util/queue.py`)."""

from __future__ import annotations

import queue as _pyqueue
import threading
from typing import Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self.q = _pyqueue.Queue(maxsize=maxsize)

    def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            self.q.put(item, timeout=timeout, block=timeout is not None)
            return True
        except _pyqueue.Full:
            return False

    def put_nowait(self, item) -> bool:
        try:
            self.q.put_nowait(item)
            return True
        except _pyqueue.Full:
            return False

    def get(self, timeout: Optional[float] = None):
        try:
            return True, self.q.get(timeout=timeout,
                                    block=timeout is not None)
        except _pyqueue.Empty:
            return False, None

    def get_nowait(self):
        try:
            return True, self.q.get_nowait()
        except _pyqueue.Empty:
            return False, None

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()

    def full(self) -> bool:
        return self.q.full()


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("max_concurrency", 16)
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            ok = ray_tpu_torch.get(self.actor.put_nowait.remote(item))
        else:
            ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout or 1e9))
        if not ok:
            raise Full()

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        else:
            ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout or 1e9))
        if not ok:
            raise Empty()
        return item

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put_async(self, item):
        return self.actor.put.remote(item, 1e9)

    def get_async(self, timeout: Optional[float] = None):
        """ObjectRef resolving to ``(ok, item)`` — awaitable from
        asyncio code (``ok`` False on timeout). The event-loop
        counterpart of :meth:`get` for consumers that must not block
        their loop (the HTTP proxy's SSE stream pump)."""
        return self.actor.get.remote(timeout or 1e9)

    def shutdown(self, block: bool = True):
        """Kill the backing actor. ``block=False`` hands the kill (a
        synchronous control-plane RPC in cluster mode) to a daemon
        thread — the variant event-loop consumers must use, since the
        blocking form would stall every coroutine on their loop."""
        if block:
            ray_tpu_torch.kill(self.actor)
            return
        threading.Thread(target=self._kill_quietly, daemon=True,
                         name="queue-shutdown").start()

    def _kill_quietly(self):
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass  # actor already dead / session torn down
