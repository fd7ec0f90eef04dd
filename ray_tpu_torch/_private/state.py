"""Global control state: the in-process GCS.

Role-equivalent to the reference GCS server's managers
(``src/ray/gcs/gcs_server/``): named-actor registry (GcsActorManager's
by-name index), internal KV (``gcs_kv_manager.h``), node table, and
placement-group table. In cluster mode this state lives in the head
process and is accessed over the control-plane RPC.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import ActorID, NodeID, PlacementGroupID


class GlobalState:
    def __init__(self, worker):
        from ray_tpu_torch._private.gcs_storage import make_store_client

        self._worker = worker
        self._lock = threading.Lock()
        # (namespace, name) -> actor handle info
        self._named_actors: Dict[tuple, Any] = {}
        self._kv: Dict[tuple, bytes] = {}
        self._placement_groups: Dict[PlacementGroupID, Any] = {}
        # Pluggable table storage (reference: gcs_table_storage.h over
        # store_client/): in-memory by default; with a configured
        # gcs_storage_path the KV table is durable — a restarted head
        # reloads it (the reference's Redis-backed GCS FT story).
        self._store = make_store_client()
        for key, value in self._store.get_all("kv"):
            ns, _, k = key.partition(b"\x00")
            self._kv[(ns, k)] = value
        # Named-actor and placement-group tables are durable too
        # (reference: GcsActorManager / GcsPlacementGroupManager persist
        # through gcs_table_storage) — a restarted head recovers both.
        import cloudpickle

        for key, value in self._store.get_all("named_actors"):
            ns, _, name = key.partition(b"\x00")
            try:
                self._named_actors[(ns.decode(), name.decode())] = \
                    cloudpickle.loads(value)
            except Exception:
                pass
        for key, value in self._store.get_all("pgs"):
            try:
                pg = _pg_from_blob(value)
                self._placement_groups[pg.id] = pg
            except Exception:
                pass

    # -- named actors ----------------------------------------------------

    @staticmethod
    def _named_store_key(key: tuple) -> bytes:
        return key[0].encode() + b"\x00" + key[1].encode()

    def register_named_actor(self, name: str, namespace: Optional[str],
                             handle) -> None:
        key = (namespace or self._worker.namespace, name)
        with self._lock:
            if key in self._named_actors:
                raise ValueError(
                    f"Actor name {name!r} already taken in namespace {key[0]!r}"
                )
            self._named_actors[key] = handle
            try:
                import cloudpickle

                self._store.put("named_actors",
                                self._named_store_key(key),
                                cloudpickle.dumps(handle))
            except Exception:
                pass  # unpicklable handle: stays memory-only

    def get_named_actor(self, name: str, namespace: Optional[str]):
        key = (namespace or self._worker.namespace, name)
        with self._lock:
            handle = self._named_actors.get(key)
        if handle is None:
            raise ValueError(f"Failed to look up actor {name!r}")
        return handle

    def list_named_actors(self, all_namespaces: bool = False):
        with self._lock:
            if all_namespaces:
                return [
                    {"name": n, "namespace": ns} for (ns, n) in self._named_actors
                ]
            return [
                n for (ns, n) in self._named_actors
                if ns == self._worker.namespace
            ]

    def remove_named_actor_by_id(self, actor_id: ActorID) -> None:
        with self._lock:
            for key, handle in list(self._named_actors.items()):
                if handle._actor_id == actor_id:
                    del self._named_actors[key]
                    self._store.delete("named_actors",
                                       self._named_store_key(key))

    # -- multi-process head fold ----------------------------------------

    def head_shard_state(self) -> dict:
        """Whole-table control-plane view folded across every head
        shard process (the timeline/state-merge path for a sharded
        head): row counts per durable table plus per-shard stats.
        Empty dict when the head runs single-process
        (``head_shards=1``)."""
        head = getattr(self._worker.backend, "head", None)
        router = getattr(head, "shard_router", None) \
            if head is not None else None
        if router is None:
            return {}
        raise NotImplementedError(
            "head shards are not ported (ROADMAP Queue 1: cluster modes)")

    # -- internal KV (reference: gcs_kv_manager.h) -----------------------

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True,
               namespace: Optional[bytes] = None) -> bool:
        k = (namespace or b"", key)
        with self._lock:
            if not overwrite and k in self._kv:
                return False
            self._kv[k] = value
            self._store.put("kv", k[0] + b"\x00" + k[1], value)
            return True

    def kv_get(self, key: bytes, namespace: Optional[bytes] = None) -> Optional[bytes]:
        with self._lock:
            return self._kv.get((namespace or b"", key))

    def kv_del(self, key: bytes, namespace: Optional[bytes] = None) -> None:
        k = (namespace or b"", key)
        with self._lock:
            self._kv.pop(k, None)
            self._store.delete("kv", k[0] + b"\x00" + k[1])

    def kv_keys(self, prefix: bytes, namespace: Optional[bytes] = None) -> list:
        ns = namespace or b""
        with self._lock:
            return [k for (n, k) in self._kv if n == ns and k.startswith(prefix)]

    # -- placement groups ------------------------------------------------

    def register_placement_group(self, pg) -> None:
        with self._lock:
            self._placement_groups[pg.id] = pg
            try:
                self._store.put("pgs", pg.id.binary(), _pg_to_blob(pg))
            except Exception:
                pass

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            self._placement_groups.pop(pg_id, None)
            self._store.delete("pgs", pg_id.binary())

    def placement_group_table(self) -> dict:
        with self._lock:
            return dict(self._placement_groups)

    # -- storage lifecycle ----------------------------------------------

    def flush_storage(self) -> None:
        """Force deferred durable writes to disk (group-commit drain).
        Called at graceful teardown boundaries — worker shutdown, head
        failover handoff — so a successor process's fresh store
        connection sees everything this one accepted."""
        try:
            self._store.flush()
        except Exception:
            pass

    def close_storage(self) -> None:
        try:
            self._store.close()
        except Exception:
            pass

    def crash_storage(self) -> None:
        """Hard-crash teardown (crash-mode head failover): the store
        connection drops WITHOUT flushing — at most the open
        group-commit window (``gcs_commit_interval_s``) of accepted-
        but-unflushed writes is lost, and none of them can resurrect."""
        try:
            self._store.crash()
        except Exception:
            pass

    # -- cluster introspection -------------------------------------------

    def nodes(self) -> list:
        b = self._worker.backend
        head = getattr(b, "head", None)
        if head is not None and hasattr(head, "_get_nodes"):
            return head._get_nodes()  # cluster mode: full node table
        from ray_tpu_torch._private.node_stats import sample_node_stats

        return [
            {
                "NodeID": b.node_id.hex(),
                "Alive": True,
                "Resources": b.resources.total,
                "Available": b.resources.available,
                "Labels": getattr(b, "labels", {}),
                "Stats": sample_node_stats(),
            }
        ]

    def cluster_resources(self) -> Dict[str, float]:
        return self._worker.backend.resources.total

    def available_resources(self) -> Dict[str, float]:
        return self._worker.backend.resources.available


def _pg_to_blob(pg) -> bytes:
    """Placement groups persist as PLAIN data (the handle's __reduce__
    resolves through the live registry, which doesn't exist while a
    restarted head is still loading its tables)."""
    import pickle

    return pickle.dumps({
        "id": pg.id.binary(),
        "bundles": pg.bundle_specs,
        "strategy": pg.strategy,
        "name": pg.name,
        "bundle_nodes": getattr(pg, "bundle_nodes", None),
    })


def _pg_from_blob(blob: bytes):
    raise NotImplementedError(
        "placement groups are not ported (ROADMAP Queue 1: the rest of "
        "the runtime)")
