"""Pluggable GCS table storage: in-memory by default, SQLite for
persistence across head restarts.

Role-equivalent to the reference's GCS store clients —
`src/ray/gcs/store_client/in_memory_store_client.h:31` (default) and
`redis_store_client.h:28` (the fault-tolerance backend) behind the
`GcsTableStorage` facade (`gcs_server/gcs_table_storage.h`). SQLite plays
Redis's durability role here: single-file, transactional, in the standard
library — the right "external store" for a single-head deployment (a real
Redis client would drop in behind the same ABC).

Select via ``ray_tpu_torch.init(_system_config={"gcs_storage_path": ...})`` or
the ``RAY_TPU_GCS_STORAGE_PATH`` env var; empty means in-memory.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import sanitize_hooks


class StoreClient:
    """Typed-table KV: (table, key) -> bytes."""

    def put(self, table: str, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def get_all(self, table: str) -> List[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def delete(self, table: str, key: bytes) -> None:
        raise NotImplementedError

    def keys(self, table: str, prefix: bytes = b"") -> List[bytes]:
        raise NotImplementedError

    def flush(self) -> None:
        """Make every accepted write durable (no-op for in-memory)."""

    def close(self) -> None:
        # API contract (raylint R4): teardown makes accepted writes
        # durable. Backends overriding close() must keep that promise.
        self.flush()

    def crash(self) -> None:
        """Simulated hard process death: release resources WITHOUT the
        durability promise of close() — writes still riding the
        group-commit window are deliberately lost (the crash-mode head
        failover's documented loss bound)."""
        self.close()


class InMemoryStoreClient(StoreClient):
    """Reference: `in_memory_store_client.h:31`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[bytes, bytes]] = {}

    def _table(self, table: str) -> Dict[bytes, bytes]:
        t = self._tables.get(table)
        if t is None:
            t = self._tables[table] = {}
        return t

    def put(self, table: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self._table(table)[key] = value

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._table(table).get(key)

    def get_all(self, table: str) -> List[Tuple[bytes, bytes]]:
        with self._lock:
            return list(self._table(table).items())

    def delete(self, table: str, key: bytes) -> None:
        with self._lock:
            self._table(table).pop(key, None)

    def keys(self, table: str, prefix: bytes = b"") -> List[bytes]:
        with self._lock:
            return [k for k in self._table(table) if k.startswith(prefix)]


class SqliteStoreClient(StoreClient):
    """Durable backend (the reference's Redis role,
    `redis_store_client.h:28`): state survives head-process restarts.

    Writes are GROUP-COMMITTED: each put/delete executes immediately
    (reads on this connection see it at once) but the fsync-bearing
    COMMIT is deferred to a flusher thread that batches everything
    accumulated within ``gcs_commit_interval_s`` into one transaction —
    the reference's async GCS-storage write path. A registry write burst
    (actor churn, KV traffic) costs one disk transaction per window
    instead of one per write. ``flush()`` forces durability; graceful
    teardown paths (worker shutdown, head failover handoff) call it.
    Set the interval to 0 for synchronous per-write commits.
    """

    def __init__(self, path: str, commit_interval_s: Optional[float] = None):
        import sqlite3

        if commit_interval_s is None:
            from ray_tpu_torch._private.config import ray_config

            commit_interval_s = ray_config.gcs_commit_interval_s
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv ("
            " tbl TEXT NOT NULL, key BLOB NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (tbl, key))")
        # WAL: concurrent readers during writes, and a crash mid-write
        # never corrupts committed state.
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.commit()
        from ray_tpu_torch._private import perf_stats

        self._stat_writes = perf_stats.counter("gcs_writes")
        # Per-store commit accounting: the multi-process head reads
        # these off each shard's own store (shard_stats ->
        # ray_tpu_head_shard_commit_seconds) so per-shard group-commit
        # latency — the shard's durability loss bound in time units —
        # is observable without guessing from the global latency stat.
        self.commit_count = 0
        self.commit_seconds_total = 0.0
        self.last_commit_s = 0.0
        self._interval = max(0.0, float(commit_interval_s or 0.0))
        self._dirty = threading.Event()
        self._closed = threading.Event()
        self._flusher = None
        if self._interval > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="gcs-commit")
            self._flusher.start()

    def _mark_dirty_locked(self) -> None:
        self._stat_writes.inc()
        if self._interval > 0:
            self._dirty.set()
        else:
            self._conn.commit()

    def put(self, table: str, key: bytes, value: bytes) -> None:
        # Yield point BEFORE the lock: the accept-vs-commit ordering is
        # the group-commit protocol's racy surface (a write accepted in
        # the window rides the next COMMIT; raymc's durability check
        # explores every placement of this accept against the commit
        # and against an injected crash).
        sanitize_hooks.sched_point("gcs.put")
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv (tbl, key, value) VALUES (?, ?, ?)"
                " ON CONFLICT(tbl, key) DO UPDATE SET value=excluded.value",
                (table, key, value))
            self._mark_dirty_locked()

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM kv WHERE tbl=? AND key=?",
                (table, key)).fetchone()
        return row[0] if row else None

    def get_all(self, table: str) -> List[Tuple[bytes, bytes]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, value FROM kv WHERE tbl=?", (table,)).fetchall()
        return [(bytes(k), bytes(v)) for k, v in rows]

    def delete(self, table: str, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE tbl=? AND key=?",
                               (table, key))
            self._mark_dirty_locked()

    def keys(self, table: str, prefix: bytes = b"") -> List[bytes]:
        return [k for k, _ in self.get_all(table) if k.startswith(prefix)]

    def _flush_loop(self) -> None:
        while not self._closed.is_set():
            self._dirty.wait()
            if self._closed.is_set():
                return
            # Group-commit window: let the burst accumulate, then one
            # transaction covers all of it. The window waits on the
            # CLOSED event, not a bare sleep — close() commits pending
            # writes itself, and a flusher stuck in a long window
            # outlives its store otherwise (a 300s test interval held
            # the thread for 300s after close).
            if self._closed.wait(self._interval):
                return
            self.flush()

    def flush(self) -> None:
        from ray_tpu_torch._private import perf_stats

        t0 = time.monotonic()
        with self._lock:
            # Crash-fault seams, UNDER the write lock so the kill
            # boundary is exact: death at `before` loses everything the
            # pending transaction accumulated (WAL rolls it back);
            # death at `after` is post-COMMIT — those writes must
            # survive restart even though this flush() never returned.
            # No concurrent put can interleave between the commit and
            # the `after` point (both sit inside one lock hold).
            sanitize_hooks.crash_point("gcs.commit.before")
            try:
                self._conn.commit()
            except Exception:
                # Commit failed (disk full, I/O error, closing): KEEP
                # the dirty flag so the flusher retries next window —
                # clearing it here would silently drop accepted writes.
                if not self._closed.is_set() and \
                        not getattr(self, "_commit_err_logged", False):
                    self._commit_err_logged = True  # once, not per retry
                    import logging

                    logging.getLogger(__name__).warning(
                        "GCS group commit failed; will retry",
                        exc_info=True)
                return
            sanitize_hooks.crash_point("gcs.commit.after")
            self._commit_err_logged = False
            self._dirty.clear()
            self.commit_count += 1
            self.last_commit_s = time.monotonic() - t0
            self.commit_seconds_total += self.last_commit_s
        perf_stats.latency("gcs_commit_seconds").record(
            time.monotonic() - t0)

    def close(self) -> None:
        self._closed.set()
        self._dirty.set()  # unblock the flusher
        with self._lock:
            try:
                self._conn.commit()
            finally:
                self._conn.close()

    def crash(self) -> None:
        """Hard-death teardown: drop the connection with the pending
        transaction UNCOMMITTED (sqlite rolls it back) — exactly what a
        SIGKILL'd process leaves behind. Acked (flushed) writes are on
        disk; the open group-commit window is lost. Under the store
        lock so a mid-statement writer is sequenced before the close
        (closing under a running conn.execute is a C-level
        use-after-free)."""
        self._closed.set()
        self._dirty.set()
        with self._lock:
            try:
                self._conn.rollback()
            except Exception:
                pass
            try:
                self._conn.close()
            except Exception:
                pass


def make_store_client() -> StoreClient:
    """Backend selection from the config table."""
    from ray_tpu_torch._private.config import ray_config

    path = getattr(ray_config, "gcs_storage_path", "")
    if path:
        return SqliteStoreClient(path)
    return InMemoryStoreClient()
