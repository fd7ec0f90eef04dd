"""Replica: the actor wrapping one copy of a deployment's callable.

Reference: `serve/_private/replica.py:268` (RayServeReplica) — construct
the user class, serve queries, expose reconfigure + health check, report
in-flight load for the router's capacity decisions.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict

import ray_tpu_torch

# Lag-sampler component keys need a per-instance discriminator: two
# replicas of one deployment can share a process, and under a shared
# key the second install's supersede token would silently stop the
# first replica's sampler — leaving exactly one loop unmonitored.
_loop_seq = itertools.count(1)

# Per-replica progress heartbeats (actor name -> monotonic stamp of the
# last COMPLETED request): the controller's hung-replica detector
# distinguishes a SATURATED replica (ping FIFO'd behind a deep mailbox
# but requests completing continuously — must never be struck) from a
# WEDGED one (no completions since the ping was sent). Process-local:
# in cluster mode a remote replica's stamps are invisible and the
# detector conservatively treats "no stamp" as "can't prove progress".
_PROGRESS_LOCK = threading.Lock()
_PROGRESS: Dict[str, float] = {}


def note_progress(name: str) -> None:
    if name:
        with _PROGRESS_LOCK:
            _PROGRESS[name] = time.monotonic()


def last_progress(name: str):
    with _PROGRESS_LOCK:
        return _PROGRESS.get(name)


def clear_progress(name: str) -> None:
    """Reset-capable (a replica leaving membership drops its row)."""
    with _PROGRESS_LOCK:
        _PROGRESS.pop(name, None)


@ray_tpu_torch.remote
class ServeReplica:
    def __init__(self, deployment_name: str, serialized_cls, init_args,
                 init_kwargs, user_config=None, version: str = "",
                 actor_name: str = ""):
        from ray_tpu_torch._private import perf_stats

        self.deployment_name = deployment_name
        self.version = version
        self.actor_name = actor_name  # progress-heartbeat key
        self._lock = threading.Lock()
        self._in_flight = 0
        self._total = 0
        self._t_busy = 0.0
        # Per-deployment execution latency, recorded in the REPLICA's
        # process — on a worker node it rides the metric-snapshot
        # shipping plane to the head's merged /api/metrics.
        self._stat_latency = perf_stats.dist(
            "serve_replica_request_seconds",
            tags={"deployment": deployment_name},
            bounds=perf_stats.SERVE_LATENCY_BOUNDS)
        self._stat_errors = perf_stats.counter(
            "serve_replica_errors", tags={"deployment": deployment_name})
        self._async_loop = None  # lazily-started, shared across requests
        self._loop_lag_component = None
        if isinstance(serialized_cls, type):
            self.callable = serialized_cls(*(init_args or ()),
                                           **(init_kwargs or {}))
        else:
            self.callable = serialized_cls  # plain function deployment
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config) -> bool:
        fn = getattr(self.callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def check_health(self) -> bool:
        fn = getattr(self.callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def prefix_digests(self):
        """Cache-affinity hints for the controller's digests:: channel:
        LLM deployments answer with their hot prefix-head digests; every
        other deployment answers None (no hints, router stays
        load-based)."""
        fn = getattr(self.callable, "prefix_digests", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            return None

    def handle_request(self, method: str, args: tuple, kwargs: dict):
        from ray_tpu_torch._private import critical_path

        with self._lock:
            self._in_flight += 1
            self._total += 1
        trace_id = critical_path.ambient_trace_id() \
            if critical_path.enabled() else None
        t0 = time.perf_counter()
        try:
            target = self.callable
            if method and method != "__call__":
                target = getattr(self.callable, method)
            elif not callable(target):
                target = getattr(self.callable, "__call__")
            result = target(*args, **kwargs)
            import inspect

            if inspect.iscoroutine(result):
                # One persistent loop per replica: asyncio.run() per
                # request paid a full loop setup/teardown on the serving
                # hot path, and broke coroutines that share loop-bound
                # state (locks, queues) across requests.
                result = self._run_coroutine(result)
            if inspect.isasyncgen(result):
                return self._start_stream(self._agen_to_gen(result))
            if inspect.isgenerator(result):
                return self._start_stream(result)
            return result
        except BaseException:
            self._stat_errors.inc()
            raise
        finally:
            elapsed = time.perf_counter() - t0
            self._stat_latency.record(elapsed)
            critical_path.record_stage(trace_id, "replica.execute",
                                       elapsed)
            note_progress(self.actor_name)
            with self._lock:
                self._in_flight -= 1
                self._t_busy += elapsed

    def _ensure_loop(self):
        import asyncio

        with self._lock:
            if self._async_loop is None:
                loop = asyncio.new_event_loop()
                threading.Thread(target=loop.run_forever, daemon=True,
                                 name="serve-replica-loop").start()
                self._async_loop = loop
                # Health-plane overload signal: lag on the replica's
                # shared request loop (an async deployment blocking it
                # stalls every other request on this replica). Recorded
                # in THIS process, so on a worker node it ships to the
                # head with the rest of the metric snapshot.
                from ray_tpu_torch._private.health import (
                    install_loop_lag_sampler,
                )

                self._loop_lag_component = (
                    f"replica:{self.deployment_name}"
                    f"#{next(_loop_seq)}")
                install_loop_lag_sampler(
                    loop, self._loop_lag_component)
            return self._async_loop

    def _run_coroutine(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(
            coro, self._ensure_loop()).result()

    def _agen_to_gen(self, agen):
        """Drive an async-generator deployment result from the stream
        pump thread, one chunk at a time on the replica's loop — async
        deployments stream exactly like sync ones."""
        import asyncio

        loop = self._ensure_loop()
        try:
            while True:
                try:
                    yield asyncio.run_coroutine_threadsafe(
                        agen.__anext__(), loop).result()
                except StopAsyncIteration:
                    return
        finally:
            asyncio.run_coroutine_threadsafe(
                agen.aclose(), loop).result(timeout=5)

    def _start_stream(self, gen):
        """Generator results stream through an actor-backed queue: the
        replica pumps in a background thread (bounded queue =
        backpressure); the consumer — HTTP proxy or Python caller via
        `serve.iter_stream` — pulls until the end marker. This is the
        token-streaming channel (reference: ASGI StreamingResponse
        through `http_proxy.py:425`; the transport differs, the contract
        — incremental chunks over one request — is the same)."""
        from ray_tpu_torch.serve.streaming import STREAM_END_KEY, STREAM_KEY
        from ray_tpu_torch.util.queue import Queue

        queue = Queue(maxsize=64)

        def pump():
            # Finite put timeouts: an abandoned consumer (client gone,
            # queue actor killed by iter_stream's cleanup) must release
            # the pump thread and close the generator, not pin them
            # forever behind a full queue.
            try:
                for item in gen:
                    queue.put(item, timeout=60.0)
                queue.put({STREAM_END_KEY: True}, timeout=60.0)
            except BaseException as e:  # noqa: BLE001 - surfaced to reader
                try:
                    gen.close()
                except Exception:
                    pass
                try:
                    queue.put({STREAM_END_KEY: True, "error": repr(e)},
                              timeout=5.0)
                except Exception:
                    pass

        threading.Thread(target=pump, daemon=True,
                         name="serve-stream-pump").start()
        return {STREAM_KEY: queue}

    def get_metrics(self) -> Dict[str, Any]:
        with self._lock:
            return {"in_flight": self._in_flight, "total": self._total,
                    "busy_s": self._t_busy}

    def prepare_for_shutdown(self) -> bool:
        # Graceful: wait for in-flight to drain (bounded).
        drained = False
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with self._lock:
                if self._in_flight == 0:
                    drained = True
                    break
            time.sleep(0.02)
        # Stop the request loop (kills its lag sampler with it) and
        # retire the sampler's component entry — a retired replica must
        # not keep an idle-~0 lag series alive under its unique key.
        with self._lock:
            loop, comp = self._async_loop, self._loop_lag_component
            self._async_loop = None
            self._loop_lag_component = None
        if loop is not None:
            import asyncio

            # Cancel everything still on the loop (the lag sampler, any
            # straggler requests past the drain deadline) and give the
            # cancellations one pass to unwind BEFORE stopping — a task
            # still pending at loop teardown warns "Task was destroyed
            # but it is pending!" on every replica stop.
            async def _cancel_all_and_stop():
                cur = asyncio.current_task()
                for t in asyncio.all_tasks():
                    if t is not cur:
                        t.cancel()
                await asyncio.sleep(0)
                loop.stop()

            try:
                asyncio.run_coroutine_threadsafe(
                    _cancel_all_and_stop(), loop).result(timeout=2)
            except Exception:
                pass
        if comp is not None:
            from ray_tpu_torch._private.health import (
                remove_loop_lag_component,
            )

            remove_loop_lag_component(comp)
        # Stop and let go of the user object: this runtime's actors are
        # objects in the driver's process, and a killed actor's instance
        # stays in its table, so the user object's threads and the
        # device memory it holds (an LLMDeployment's engine loop, its
        # weights and KV cache) would outlive the kill.
        user, self.callable = self.callable, None
        stop = getattr(user, "stop", None)
        if callable(stop):
            stop()
        return drained
