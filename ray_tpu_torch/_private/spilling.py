"""Object spilling: disk (or pluggable external) backing for the store.

Role-equivalent to the reference's spill pipeline — the raylet's
LocalObjectManager picks objects to spill under memory pressure
(`src/ray/raylet/local_object_manager.h:41` SpillObjects), IO workers run
the actual writes through an ExternalStorage implementation
(`python/ray/_private/external_storage.py:72`, FileSystemStorage `:246`),
and spilled objects restore transparently on get.

Here the memory store calls `SpillManager.maybe_spill()` after each put;
the manager serializes cold, large, ready objects out to the storage
backend and drops the in-memory value, leaving the URL on the entry.
`get`/`peek` restore through `SpillManager.restore()`. Ref release
deletes the spilled file.

Budget and thresholds come from the config table
(`object_store_memory_bytes`, `object_spilling_threshold`,
`min_spilling_size_bytes` — reference: ray_config_def.h spilling flags).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import cloudpickle

from ray_tpu_torch._private import critical_path
from ray_tpu_torch._private import perf_stats as _perf_stats
from ray_tpu_torch._private import sanitize_hooks
from ray_tpu_torch._private.config import ray_config
from ray_tpu_torch._private.ids import ObjectID

# Object-plane observability: spill/restore volume, exported as
# ray_tpu_object_*_total by the runtime-metrics fold.
_SPILL_BYTES = _perf_stats.counter("object_spill_bytes")
_RESTORE_BYTES = _perf_stats.counter("object_restore_bytes")


def decode_spilled_payload(raw: bytes):
    """Decode one spilled payload: RTS1-framed arena bytes (sealed
    layout, buffers viewing the loaded copy) or plain cloudpickle —
    the ONE sniff both transparent restore and lineage
    restore-from-spill share."""
    if raw[:4] == b"RTS1":
        raise NotImplementedError(
            "the shm object plane is not ported (ROADMAP Queue 1: the "
            "shm plane)")
    return cloudpickle.loads(raw)


def restore_spilled_payload(url: str):
    """Restore a spilled object from its URL without a SpillManager —
    the lineage-reconstruction path: a dead node's spill file outlives
    the process, and the head restores the value from disk instead of
    re-executing the creating task."""
    assert url.startswith("file://"), url
    with open(url[len("file://"):], "rb") as f:
        raw = f.read()
    _RESTORE_BYTES.inc(len(raw))
    return decode_spilled_payload(raw)


def estimate_size(value) -> int:
    """Cheap recursive size estimate — exact for buffers/arrays (where
    the bytes are), rough for object graphs (which spilling doesn't
    target anyway)."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return int(value.nbytes)
    except ImportError:  # pragma: no cover
        pass
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):  # jax arrays, arrow buffers
        return nbytes
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, str):
        return len(value)
    if isinstance(value, (list, tuple, set)):
        return 64 + sum(estimate_size(v) for v in list(value)[:100])
    if isinstance(value, dict):
        return 64 + sum(estimate_size(k) + estimate_size(v)
                        for k, v in list(value.items())[:100])
    return 256


class ExternalStorage:
    """Reference: `python/ray/_private/external_storage.py:72`."""

    def spill(self, object_id: ObjectID, payload: bytes) -> str:
        raise NotImplementedError

    def restore(self, url: str) -> bytes:
        raise NotImplementedError

    def delete(self, urls: List[str]) -> None:
        raise NotImplementedError

    def destroy(self) -> None:
        pass


class FileSystemStorage(ExternalStorage):
    """Reference: FileSystemStorage (`external_storage.py:246`)."""

    def __init__(self, directory: Optional[str] = None):
        import tempfile

        self.directory = directory or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_spill_{os.getpid()}")
        # Directory creation is deferred to the first spill: most
        # processes never exceed the budget and never touch disk.

    def spill(self, object_id: ObjectID, payload: bytes) -> str:
        os.makedirs(self.directory, exist_ok=True)
        # Unique per WRITE, not per object: the heap sweep and the
        # arena spill can both write a copy of the same oid (a swap
        # racing a sweep snapshot); with a deterministic path the
        # loser's cleanup would unlink the winner's live file.
        path = os.path.join(
            self.directory,
            f"{object_id.hex()}-{os.urandom(4).hex()}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)  # atomic: never observe partial spills
        return f"file://{path}"

    def restore(self, url: str) -> bytes:
        assert url.startswith("file://"), url
        with open(url[len("file://"):], "rb") as f:
            return f.read()

    def delete(self, urls: List[str]) -> None:
        for url in urls:
            try:
                os.unlink(url[len("file://"):])
            except OSError:
                pass

    def destroy(self) -> None:
        import shutil

        shutil.rmtree(self.directory, ignore_errors=True)


class SpillManager:
    """Memory accounting + spill/restore orchestration for a MemoryStore.

    The store reports puts/accesses; when in-memory bytes exceed
    threshold * budget, cold large objects spill until back under."""

    def __init__(self, store, storage: Optional[ExternalStorage] = None,
                 budget_bytes: Optional[int] = None):
        self.store = store
        self.storage = storage or FileSystemStorage()
        self.budget = budget_bytes or ray_config.object_store_memory_bytes
        self._lock = threading.Lock()
        # Serializes spill sweeps: two concurrent maybe_spill calls on
        # the same object would double-write its (deterministic) path
        # and the loser's cleanup would unlink the winner's live file.
        self._spill_mutex = threading.Lock()
        self.in_memory_bytes = 0
        self.spilled_bytes = 0
        self.num_spilled = 0
        self.num_restored = 0

    # -- accounting hooks (store calls these under its own lock) ---------

    def note_put(self, size: int) -> None:
        with self._lock:
            self.in_memory_bytes += size

    def note_drop(self, size: int) -> None:
        with self._lock:
            self.in_memory_bytes -= size

    def over_threshold(self) -> bool:
        return self.in_memory_bytes > \
            self.budget * ray_config.object_spilling_threshold

    # -- spill/restore ----------------------------------------------------

    def maybe_spill(self) -> int:
        """Spill cold objects until under threshold. Returns bytes
        spilled. Called outside the store lock (serialization is slow)."""
        if not self.over_threshold():
            return 0
        if not self._spill_mutex.acquire(blocking=False):
            return 0  # another thread is already sweeping
        try:
            return self._spill_locked()
        finally:
            self._spill_mutex.release()

    def _spill_locked(self) -> int:
        target = int(self.budget * ray_config.object_spilling_threshold)
        spilled = 0
        for oid, value, size, existing_url in self.store.spill_candidates():
            with self._lock:
                if self.in_memory_bytes <= target:
                    break
            if existing_url is not None:
                # Restored copy: the bytes are already on disk — just
                # drop the resident value again.
                if self.store.mark_spilled(oid, existing_url):
                    spilled += size
                    with self._lock:
                        self.in_memory_bytes -= size
                continue
            t0 = time.monotonic()
            payload = cloudpickle.dumps(value)
            url = self.storage.spill(oid, payload)
            if critical_path.enabled():
                critical_path.record_stage(
                    critical_path.ambient_trace_id(), "object.spill",
                    time.monotonic() - t0)
            sanitize_hooks.crash_point("spill.write.after")
            sanitize_hooks.sched_point("spill.mark")
            if self.store.mark_spilled(oid, url):
                spilled += size
                _SPILL_BYTES.inc(len(payload))
                with self._lock:
                    self.in_memory_bytes -= size
                    self.spilled_bytes += len(payload)
                    self.num_spilled += 1
            else:  # entry vanished meanwhile: drop the file
                self.storage.delete([url])
        return spilled

    def spill_payload(self, object_id: ObjectID, payload: bytes) -> str:
        """Write an already-serialized payload (a shm arena object's
        RTS1 bytes — see ``shm_plane.payload_bytes``) to the storage
        backend. The caller flips its own entry; accounting here."""
        t0 = time.monotonic()
        url = self.storage.spill(object_id, payload)
        if critical_path.enabled():
            critical_path.record_stage(
                critical_path.ambient_trace_id(), "object.spill",
                time.monotonic() - t0)
        sanitize_hooks.crash_point("spill.write.after")
        _SPILL_BYTES.inc(len(payload))
        with self._lock:
            self.spilled_bytes += len(payload)
            self.num_spilled += 1
        return url

    def restore(self, url: str):
        t0 = time.monotonic()
        raw = self.storage.restore(url)
        _RESTORE_BYTES.inc(len(raw))
        if critical_path.enabled():
            critical_path.record_stage(
                critical_path.ambient_trace_id(), "object.restore",
                time.monotonic() - t0)
        sanitize_hooks.sched_point("spill.restore")
        value = decode_spilled_payload(raw)
        with self._lock:
            self.num_restored += 1
        return value

    def delete(self, urls: List[str]) -> None:
        self.storage.delete(urls)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "in_memory_bytes": self.in_memory_bytes,
                "spilled_bytes": self.spilled_bytes,
                "num_spilled": self.num_spilled,
                "num_restored": self.num_restored,
            }
