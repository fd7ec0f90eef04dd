"""@serve.batch: dynamic request batching.

Reference: `python/ray/serve/batching.py` — concurrent calls to the
decorated method are grouped (up to `max_batch_size`, waiting at most
`batch_wait_timeout_s`) and executed once over the list; each caller gets
its element back. Essential for ML serving: the replica turns N
single-sample requests into one batched device invocation.
"""

from __future__ import annotations

import functools
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Callable, List, Optional


_ALL_BATCHERS: "weakref.WeakSet[_Batcher]" = weakref.WeakSet()


def retire_all_batchers() -> None:
    """Ask every live batcher's drain thread to retire (queued work
    still runs first; the batcher itself stays usable — a later submit
    just respawns its thread). ``serve.shutdown()`` calls this so
    driver-side ``@serve.batch`` handlers that nobody explicitly shut
    down don't keep their 5s-idle threads past teardown."""
    for b in list(_ALL_BATCHERS):
        try:
            b.retire()
        except Exception:
            pass


class _Batcher:
    _STOP = object()  # drain sentinel: queued work ahead of it still runs

    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._closed = False
        _ALL_BATCHERS.add(self)

    def _ensure_thread(self):
        with self._lock:
            if self._closed:
                return
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="serve-batcher")
                self._thread.start()

    def _loop(self):
        while True:
            try:
                first = self.queue.get(timeout=5.0)
            except queue.Empty:
                return  # idle thread exits; recreated on demand
            if first is self._STOP:
                self._handoff_if_stale_stop()
                return
            batch = [first]
            deadline = self.timeout
            while len(batch) < self.max_batch_size:
                try:
                    item = self.queue.get(timeout=deadline)
                except queue.Empty:
                    break
                if item is self._STOP:
                    # Re-queue so the outer get observes it AFTER this
                    # (already accepted) batch has run.
                    self.queue.put(self._STOP)
                    break
                batch.append(item)
            self._run(batch)

    def _handoff_if_stale_stop(self) -> None:
        """Called on consuming a STOP sentinel. retire() checks
        ``is_alive`` without holding the thread's idle-exit race, so a
        sentinel can land in an EMPTY queue after the thread already
        retired — and the next submit's respawned thread would then eat
        the stale sentinel and exit with that submit's item queued
        behind it, stranding the caller's future. submit() enqueues
        BEFORE _ensure_thread, so real work behind a stale sentinel is
        always visible here: spawn a successor for it."""
        with self._lock:
            if not self._closed and not self.queue.empty() \
                    and self._thread is threading.current_thread():
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="serve-batcher")
                self._thread.start()

    def retire(self, timeout: float = 5.0) -> None:
        """Stop the drain thread WITHOUT closing the batcher: queued
        work still runs (the sentinel lands behind it), and a later
        submit simply respawns the thread. The teardown-sweep form —
        ``shutdown`` is the permanent one."""
        with self._lock:
            t = self._thread
        if t is not None and t.is_alive():
            self.queue.put(self._STOP)
            t.join(timeout)

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the drain thread. Work queued before the call still
        runs — the sentinel lands behind it — and anything that raced
        past the closed check gets its Future failed, so no accepted
        request is left permanently pending."""
        with self._lock:
            self._closed = True
            t = self._thread
        if t is not None and t.is_alive():
            self.queue.put(self._STOP)
            t.join(timeout)
        # A submit() that passed the closed check before we set it may
        # have enqueued BEHIND the sentinel; fail those futures rather
        # than strand their callers.
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item is self._STOP:
                continue
            fut, _ = item
            if not fut.done():
                fut.set_exception(RuntimeError("batcher is shut down"))

    def _run(self, batch: List[tuple]):
        futures = [f for f, _ in batch]
        items = [x for _, x in batch]
        try:
            results = self.fn(items)
            if results is None or len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function must return a list of "
                    f"length {len(items)}, got {results!r}")
            for f, r in zip(futures, results):
                f.set_result(r)
        except BaseException as e:  # noqa: BLE001
            for f in futures:
                if not f.done():
                    f.set_exception(e)

    def submit(self, item) -> Future:
        f: Future = Future()
        # Check-and-enqueue under the lock: shutdown() sets _closed
        # under the same lock before its final drain, so an accepted
        # put is always visible to that drain (or to a live thread) —
        # no caller can be stranded between the two.
        with self._lock:
            if self._closed:
                f.set_exception(RuntimeError("batcher is shut down"))
                return f
            self.queue.put((f, item))  # raylint: disable=R2 -- unbounded queue, put() cannot block; closed-check + enqueue must be one atomic step or shutdown's final drain can miss an accepted item
        self._ensure_thread()
        return f


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator. The wrapped function must accept a list and return a
    list of equal length; callers pass single items."""

    def decorate(fn: Callable):
        return _BatchWrapper(fn, max_batch_size, batch_wait_timeout_s)

    if _fn is not None:
        return decorate(_fn)
    return decorate


class _BatchWrapper:
    """The decorated callable: a descriptor, so that on a method both
    the sync call AND ``.aio`` see the bound instance (a plain function
    attribute would lose ``self`` for ``await self.method.aio(item)``
    — attribute lookup on a bound method reaches the raw function)."""

    _is_serve_batch = True

    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float, _instance=None):
        self._fn = fn
        self._max_batch_size = max_batch_size
        self._timeout_s = batch_wait_timeout_s
        self._instance = _instance
        self._batchers: dict = {}
        functools.update_wrapper(self, fn)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        bound = _BatchWrapper.__new__(_BatchWrapper)
        bound.__dict__ = dict(self.__dict__)
        bound._instance = obj
        # Share the batcher table with the unbound wrapper: per-instance
        # keying below keeps instances separate while repeated __get__
        # calls reuse the same batcher (a fresh table per lookup would
        # defeat batching entirely).
        bound._batchers = self._batchers
        return bound

    def _submit(self, args) -> Future:
        if self._instance is not None:
            args = (self._instance,) + args
        # Methods: bind per-instance so `self` stays out of the batch.
        if len(args) == 2 and not isinstance(args[0], (list, tuple)):
            self_obj, item = args
            key = id(self_obj)
            if key not in self._batchers:
                self._batchers[key] = _Batcher(
                    lambda items, s=self_obj: self._fn(s, items),
                    self._max_batch_size, self._timeout_s)
            return self._batchers[key].submit(item)
        (item,) = args
        if "fn" not in self._batchers:
            self._batchers["fn"] = _Batcher(
                self._fn, self._max_batch_size, self._timeout_s)
        return self._batchers["fn"].submit(item)

    def __call__(self, *args):
        return self._submit(args).result()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Drain and stop every per-instance batcher thread (replica
        teardown hook); queued work still runs before threads retire."""
        for b in list(self._batchers.values()):
            b.shutdown(timeout)

    async def aio(self, *args):
        # Async batch wakeup: the batcher thread's set_result lands on
        # the caller's event loop instead of blocking it — N concurrent
        # awaiters on one loop still coalesce into one batched call.
        import asyncio

        return await asyncio.wrap_future(self._submit(args))
