"""Memory monitor + worker killing under memory pressure.

Role-equivalent to the reference's `src/ray/common/memory_monitor.h:52`
(cgroup/proc-based usage sampling) driving the raylet's worker-killing
policies (`worker_killing_policy_retriable_fifo.h`,
`worker_killing_policy_group_by_owner.h`): when node memory usage crosses
the threshold, kill a worker *process* — preferring the newest retriable
task, so the victim can re-run once pressure clears — instead of letting
the kernel OOM-killer take down the whole node.

Only process-isolated work (``isolate_process`` tasks and actors) is
killable; in-thread tasks share the node's address space, which is
exactly why the worker pool exists.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from ray_tpu_torch._private.config import ray_config

logger = logging.getLogger(__name__)

# Last sampled usage fraction (value, monotonic ts) — the health plane
# reads this instead of re-walking /proc on every verdict. Written by
# whichever monitor loop sampled last; a plain tuple swap is atomic
# under the GIL.
_last_sample: "tuple[float, float] | None" = None


def current_pressure(max_age_s: float = 2.0) -> float:
    """Node memory usage fraction for the health/metrics plane: the
    monitor loop's latest sample when fresh, else sampled inline (the
    no-monitor case — drivers, tests — still gets a live value; the
    read is two small file reads)."""
    import time

    global _last_sample
    sample = _last_sample
    now = time.monotonic()
    if sample is not None and now - sample[1] <= max_age_s:
        return sample[0]
    value = system_memory_usage_fraction()
    _last_sample = (value, now)
    return value


def system_memory_usage_fraction() -> float:
    """Used fraction of node memory: cgroup v2 limit when present (the
    container case, as the reference prefers), else /proc/meminfo."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit_raw = f.read().strip()
        if limit_raw != "max":
            with open("/sys/fs/cgroup/memory.current") as f:
                current = int(f.read().strip())
            return current / max(int(limit_raw), 1)
    except OSError:
        pass
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, rest = line.partition(":")
                info[name] = int(rest.strip().split()[0])
        total = info.get("MemTotal", 0)
        available = info.get("MemAvailable", 0)
        if total:
            return 1.0 - available / total
    except OSError:  # pragma: no cover - non-Linux
        pass
    return 0.0


class MemoryMonitor:
    """Samples usage on a timer; above threshold, asks the backend to
    kill one killable worker per breach (repeats while pressure holds)."""

    def __init__(self, backend,
                 usage_fn: Optional[Callable[[], float]] = None):
        self.backend = backend
        self.usage_fn = usage_fn or system_memory_usage_fraction
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_killed = 0

    def start(self) -> None:
        if self._thread is not None or \
                ray_config.memory_monitor_refresh_ms <= 0:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        import time

        global _last_sample
        while not self._stop.wait(
                ray_config.memory_monitor_refresh_ms / 1000.0):
            try:
                usage = self.usage_fn()
            except Exception:  # pragma: no cover - sampling must not kill
                continue
            _last_sample = (usage, time.monotonic())
            if usage <= ray_config.memory_usage_threshold:
                continue
            if self.kill_one(usage):
                self.num_killed += 1

    def kill_one(self, usage: float) -> bool:
        """Retriable-FIFO policy (reference:
        `worker_killing_policy_retriable_fifo.h`): newest retriable task
        first — it loses the least work and can re-run; then the newest
        non-retriable. Returns True if something was killed."""
        pool = self.backend._worker_pool
        if pool is None:
            return False
        with pool._lock:
            active = list(pool.active.values())
        if not active:
            return False

        def sort_key(item):
            proc, spec, t0 = item
            retriable = bool(spec is not None and
                             getattr(spec, "max_retries", 0) != 0 and
                             getattr(spec, "retry_exceptions", False))
            return (not retriable, -t0)

        proc, spec, t0 = sorted(active, key=sort_key)[0]
        # Re-validate under the pool lock right before the SIGKILL: the
        # task may have finished (worker back in the idle pool, possibly
        # already running someone else's work) since the snapshot.
        with pool._lock:
            current = pool.active.get(proc.pid)
            if current is None or current[0] is not proc or \
                    current[2] != t0:
                return False
            logger.warning(
                "memory usage %.1f%% above threshold %.1f%%: killing "
                "worker %s running %s", usage * 100,
                ray_config.memory_usage_threshold * 100, proc.pid,
                spec.describe() if spec is not None else "<unknown>")
            proc.kill()
        self._record_kill_event(proc.pid, spec, usage)
        return True

    def _record_kill_event(self, pid: int, spec, usage: float) -> None:
        """The kill decision as a task event (victim task id, usage
        fraction, job tag): OOM kills show up in ``timeline()`` and the
        cluster-wide state views — shipped to the head like any task
        event — instead of only in this node's log. A synthetic task id
        keeps the incident distinct from the victim task's own record,
        which a retry will overwrite."""
        import time

        from ray_tpu_torch._private import perf_stats
        from ray_tpu_torch._private.task_events import TaskEvent

        try:
            victim = spec.task_id.hex() if spec is not None else ""
            now = time.time()
            self.backend.worker.task_events.record_event(TaskEvent(
                task_id=f"memkill:{victim or pid}:{self.num_killed}",
                name="memory_monitor.kill_worker",
                kind="NORMAL_TASK", state="MEMORY_KILLED",
                start_s=now, end_s=now,
                node_id=getattr(self.backend, "node_id", None).hex()
                if getattr(self.backend, "node_id", None) else "",
                worker=f"pid={pid}",
                error=f"worker killed at memory usage {usage:.3f} "
                      f"(threshold "
                      f"{ray_config.memory_usage_threshold:.3f}); "
                      f"victim task {victim or '<unknown>'}",
                job_id=(spec.job_id or "") if spec is not None else ""))
            perf_stats.counter("memory_monitor_kills").inc()
        except Exception:  # pragma: no cover — accounting must not
            pass           # interfere with the kill itself
