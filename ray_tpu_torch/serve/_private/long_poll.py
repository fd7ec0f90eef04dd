"""Long-poll: the control→data-plane update channel.

Reference: `serve/_private/long_poll.py:185` (LongPollHost) — clients ask
"notify me when key K changes past version V"; the host blocks the call
until the snapshot advances. Routers and proxies learn replica-set and
route-table changes this way instead of polling hot loops.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

from ray_tpu_torch._private import sanitize_hooks


class LongPollHost:
    """Lives inside the controller actor (thread-safe)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._snapshots: Dict[str, Any] = {}
        self._versions: Dict[str, int] = {}
        self._poisoned = False

    def notify_changed(self, key: str, snapshot: Any) -> None:
        # Yield point: a membership broadcast racing listener arrivals
        # and a controller kill is the convergence protocol's surface —
        # raymc orders this crossing against parked listens and the
        # injected controller death.
        sanitize_hooks.sched_point("longpoll.notify")
        with self._cond:
            self._snapshots[key] = snapshot
            self._versions[key] = self._versions.get(key, 0) + 1
            self._cond.notify_all()

    def listen(self, key: str, known_version: int = -1,
               timeout: float = 30.0) -> Tuple[int, Any]:
        """Block until version(key) > known_version (or timeout); returns
        (version, snapshot). A poisoned host (see :meth:`shutdown`)
        answers after a token delay instead of blocking."""
        sanitize_hooks.sched_point("longpoll.listen")
        with self._cond:
            self._cond.wait_for(
                lambda: self._poisoned
                or self._versions.get(key, 0) > known_version,
                timeout=timeout)
            if self._poisoned:
                # Not 0: a client that missed its stop signal would
                # otherwise hot-loop listen/return for the rest of the
                # shutdown window.
                self._cond.wait(0.05)
            return (self._versions.get(key, 0),
                    self._snapshots.get(key))

    def shutdown(self) -> None:
        """Poison the host: every parked listener wakes now and future
        listens return immediately. Without this, a killed controller's
        in-flight ``listen`` task pins its executor thread for the full
        30s wait (and the client's ``get`` with it) — the exact leak
        the sanitizer flagged on every serve test teardown."""
        with self._cond:
            self._poisoned = True
            self._cond.notify_all()


class LongPollClient:
    """Driver/router-side: background thread keeping a local copy fresh.

    When the controller dies and a `reresolve` callable is provided, the
    client polls it until a REPLACEMENT controller registers under the
    well-known name, then resumes listening from version -1 (the
    recovered controller re-broadcasts its checkpointed state) — the
    reference's client-side controller-recovery path. Without
    `reresolve` a dead controller permanently orphans the client (the
    serve.shutdown case)."""

    _RERESOLVE_WINDOW_S = 60.0

    def __init__(self, controller, key: str, callback, reresolve=None):
        self._controller = controller
        self._key = key
        self._callback = callback
        self._reresolve = reresolve
        self._version = -1
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"longpoll-{key}")
        self._thread.start()

    def _try_reresolve(self) -> bool:
        """Poll for a LIVE controller (the reresolver pings before
        returning a handle — a replacement, or the same actor restarted
        in place via max_restarts); True to resume listening from
        scratch."""
        import time

        deadline = time.monotonic() + self._RERESOLVE_WINDOW_S
        while not self._stopped.is_set() and time.monotonic() < deadline:
            try:
                new = self._reresolve()
            except Exception:
                new = None
            if new is not None:
                self._controller = new
                self._version = -1
                return True
            self._stopped.wait(0.5)
        return False

    def _loop(self):
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import (ActorDiedError, ActorError,
                                        GetTimeoutError)

        while not self._stopped.is_set():
            # Loop-edge yield point: between two polls is where a
            # controller death lands (the next listen hits a dead
            # actor) — the crossing the checker parks to interleave a
            # kill/restart against an in-flight poll cycle.
            sanitize_hooks.sched_point("longpoll.client.loop")
            try:
                ref = self._controller.listen.remote(
                    self._key, self._version)
                # Bounded get so stop() takes effect within one slice
                # even while the server holds the poll open — an
                # un-interruptible 60s get kept this thread alive long
                # past every teardown.
                while True:
                    if self._stopped.is_set():
                        return
                    try:
                        version, snapshot = ray_tpu_torch.get(ref, timeout=0.5)
                        break
                    except GetTimeoutError:
                        continue
            except (ActorDiedError, ActorError):
                # Controller is gone. With a reresolver, wait for its
                # replacement (serve keeps answering from the last
                # snapshot meanwhile); otherwise exit instead of
                # spinning error objects forever.
                if self._reresolve is not None and self._try_reresolve():
                    continue
                return
            except Exception:
                if self._stopped.is_set():
                    return
                # Transient failure: back off — a hot retry loop against
                # a broken controller starves every other thread.
                self._stopped.wait(0.5)
                continue
            if version > self._version:
                self._version = version
                try:
                    self._callback(snapshot)
                except Exception:
                    pass

    def stop(self):
        self._stopped.set()
