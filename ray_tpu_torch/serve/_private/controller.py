"""ServeController: the reconciliation brain.

Reference: `serve/controller.py:70` + `_private/deployment_state.py:998` —
a detached singleton actor holding target state per deployment (replica
count, version, config) and a reconcile loop that starts/stops replica
actors to match, performs rolling updates on version change, health-checks
replicas, and drives autoscaling from router-reported queue metrics.
Membership changes broadcast to routers via the long-poll host.

Fault tolerance (reference `serve/_private/storage/kv_store.py:1` +
controller recovery in `serve/controller.py:70` ff.): every target-state
mutation checkpoints {deployments, routes, replica names} to the GCS
internal KV (durable when the head runs with gcs_storage_path). Replicas
are NAMED detached actors, so a restarted controller re-attaches the
live ones instead of cold-starting the fleet; dead ones are replaced by
the normal reconcile loop. While the controller is down, routers keep
answering from their last long-poll snapshot.
"""

from __future__ import annotations

import hashlib
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import health as _health
from ray_tpu_torch._private.config import ray_config
from ray_tpu_torch.exceptions import ActorDiedError
from ray_tpu_torch.serve._private.long_poll import LongPollHost
from ray_tpu_torch.serve._private.replica import ServeReplica

CONTROLLER_NAME = "SERVE_CONTROLLER"
_CKPT_NS = b"__serve__"
_CKPT_KEY = b"controller_state"


def _version_hash(payload) -> str:
    import pickle

    try:
        blob = pickle.dumps(payload)
    except Exception:
        blob = repr(payload).encode()
    return hashlib.sha1(blob).hexdigest()[:12]


class _DeploymentState:
    def __init__(self, name: str, info: Dict[str, Any]):
        self.name = name
        self.info = info  # cls, init_args, init_kwargs, num_replicas, ...
        self.version = info["version"]
        self.replicas: List[Any] = []
        self.replica_versions: Dict[Any, str] = {}
        self.replica_names: Dict[Any, str] = {}  # handle -> actor name
        self.status = "UPDATING"
        self.message = ""
        # Replica supervision state: per-replica consecutive health-
        # check strikes, the in-flight (ping ref, sent_at) checked on
        # later passes, and the set of replicas whose LAST ping
        # answered ok (a degraded reason only clears once the
        # replacement fleet confirms).
        self.health_strikes: Dict[Any, int] = {}
        self.health_pings: Dict[Any, Any] = {}
        self.health_ok: set = set()
        self.last_health = 0.0
        # Burn-driven autoscaling hysteresis.
        self.last_burn_scale = 0.0
        # Cache-affinity digest channel state: the in-flight
        # prefix_digests() ref per replica (collected on later passes,
        # like health pings), the last committed doc per replica NAME
        # (what digests:: broadcasts), and the poll rate limiter.
        self.digest_pings: Dict[Any, Any] = {}
        self.digests: Dict[str, Any] = {}
        self.last_digest = 0.0

    def forget_replica(self, r) -> None:
        """Drop ALL supervision state for a replica leaving membership
        (rolling update, scale-down, health-detected death) — stale
        entries would otherwise accumulate one row (and a pending ping
        ref) per stopped replica for the controller's lifetime. The
        progress-heartbeat row keyed by the actor name goes with it."""
        rname = self.replica_names.pop(r, None)
        if rname:
            from ray_tpu_torch.serve._private.replica import clear_progress

            clear_progress(rname)
        self.replica_versions.pop(r, None)
        self.health_strikes.pop(r, None)
        self.health_pings.pop(r, None)
        self.health_ok.discard(r)
        self.digest_pings.pop(r, None)
        if rname:
            self.digests.pop(rname, None)


@ray_tpu_torch.remote
class ServeController:
    def __init__(self):
        self._lock = threading.RLock()
        # Serializes checkpoint snapshot+write so concurrent mutators
        # cannot commit out of order (a stale snapshot overwriting a
        # newer one would lose deployments across a crash).
        self._ckpt_lock = threading.Lock()
        self._deployments: Dict[str, _DeploymentState] = {}
        self._long_poll = LongPollHost()
        self._metrics: Dict[str, Dict[str, float]] = {}
        # Route table: prefix -> deployment name. Proxy actors learn it
        # via the "routes" long-poll channel (reference: the
        # control->data-plane LongPollHost route updates).
        self._routes: Dict[str, str] = {}
        self._shutdown = threading.Event()
        # Dead/degraded serve components, keyed by component id: the
        # /api/healthz provider reads the values, so a chaos kill is
        # NAMED while the fleet is degraded and the reason drops the
        # moment the deployment reconciles back to target.
        self._degraded: Dict[str, str] = {}
        # Burn-rate sampling for autoscaling is rate-limited (the
        # reconcile loop runs at 10Hz; sampling the SLO tracker that
        # often would grow its window history 10x for no signal).
        self._last_burn_sample = 0.0
        self._burn_cache: Dict[str, float] = {}
        _health.register_degraded_provider("serve", self._health_reasons)
        self._recover()
        self._reconciler = threading.Thread(target=self._reconcile_loop,
                                            daemon=True)
        self._reconciler.start()

    # -- checkpoint / recovery (reference serve kv_store.py) -------------

    def _kv(self):
        from ray_tpu_torch._private.worker import global_worker

        return global_worker().gcs

    def _checkpoint(self):
        import cloudpickle

        with self._ckpt_lock:
            if self._shutdown.is_set():
                return  # never re-create the key after a wipe
            with self._lock:
                state = {
                    "routes": dict(self._routes),
                    "deployments": {
                        name: {
                            "info": st.info,
                            "replicas": [
                                (st.replica_names.get(r),
                                 st.replica_versions.get(r))
                                for r in st.replicas
                                if st.replica_names.get(r)
                            ],
                        }
                        for name, st in self._deployments.items()
                    },
                }
            try:
                self._kv().kv_put(_CKPT_KEY, cloudpickle.dumps(state),
                                  namespace=_CKPT_NS)
            except Exception:
                traceback.print_exc()

    def _recover(self):
        import cloudpickle

        try:
            blob = self._kv().kv_get(_CKPT_KEY, namespace=_CKPT_NS)
        except Exception:
            blob = None
        if not blob:
            return
        try:
            state = cloudpickle.loads(blob)
        except Exception:
            traceback.print_exc()
            return
        self._routes = dict(state.get("routes") or {})
        recovered_replicas = 0
        for name, d in (state.get("deployments") or {}).items():
            st = _DeploymentState(name, d["info"])
            # Re-attach live named replicas; dead/missing ones are
            # replaced by the first reconcile pass. An unreachable one
            # is best-effort KILLED, never silently skipped — skipping
            # would strand a detached actor (and its resources) forever.
            for rname, version in d.get("replicas") or []:
                h = None
                try:
                    h = ray_tpu_torch.get_actor(rname)
                    ray_tpu_torch.get(h.check_health.remote(), timeout=10.0)
                except Exception:
                    if h is not None:
                        try:
                            ray_tpu_torch.kill(h)
                        except Exception:
                            pass
                    continue
                st.replicas.append(h)
                st.replica_versions[h] = version
                st.replica_names[h] = rname
                recovered_replicas += 1
            st.status = "UPDATING"
            self._deployments[name] = st
        for st in self._deployments.values():
            self._broadcast(st.name, st.replicas)
        self._long_poll.notify_changed("routes", dict(self._routes))
        if self._deployments:
            from ray_tpu_torch._private.events import record_event

            record_event(
                "serve", "controller recovered "
                f"{len(self._deployments)} deployment(s), "
                f"{recovered_replicas} live replica(s) from checkpoint")

    # -- routes (consumed by HTTPProxyActor fleet) -----------------------

    def set_route(self, prefix: str, deployment_name: str) -> bool:
        with self._lock:
            self._routes[prefix.rstrip("/") or "/"] = deployment_name
            snapshot = dict(self._routes)
        self._long_poll.notify_changed("routes", snapshot)
        self._checkpoint()
        return True

    def remove_route(self, prefix: str) -> bool:
        with self._lock:
            self._routes.pop(prefix.rstrip("/") or "/", None)
            snapshot = dict(self._routes)
        self._long_poll.notify_changed("routes", snapshot)
        self._checkpoint()
        return True

    def remove_routes_of(self, deployment_name: str) -> bool:
        """Drop every prefix routing to a deployment (serve.delete)."""
        with self._lock:
            for prefix in [p for p, d in self._routes.items()
                           if d == deployment_name]:
                del self._routes[prefix]
            snapshot = dict(self._routes)
        self._long_poll.notify_changed("routes", snapshot)
        self._checkpoint()
        return True

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._routes)

    # -- API -------------------------------------------------------------

    def deploy(self, name: str, info: Dict[str, Any]) -> bool:
        info = dict(info)
        info["version"] = info.get("version") or _version_hash(
            (info.get("init_args"), info.get("init_kwargs"),
             info.get("user_config"), info.get("num_replicas")))
        with self._lock:
            existing = self._deployments.get(name)
            if existing is None:
                self._deployments[name] = _DeploymentState(name, info)
            else:
                existing.info = info
                existing.version = info["version"]
                existing.status = "UPDATING"
        from ray_tpu_torch._private.events import record_event

        record_event("serve", f"deployment {name} deployed "
                     f"(version {info['version'][:8]})",
                     deployment=name)
        self._checkpoint()
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            state = self._deployments.pop(name, None)
        if state:
            # Membership commits empty BEFORE the replicas die, so
            # routers and direct tables stop dispatching first.
            self._broadcast(name, [])
            for r in state.replicas:
                self._stop_replica(r)
            from ray_tpu_torch._private.events import record_event

            record_event("serve", f"deployment {name} deleted",
                         deployment=name)
        self._checkpoint()
        return True

    def get_deployment_info(self, name: str) -> Optional[dict]:
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return None
            return {"name": name, "status": st.status,
                    "num_replicas": len(st.replicas),
                    "target_replicas": st.info.get("num_replicas", 1),
                    "version": st.version, "message": st.message}

    def list_deployments(self) -> List[str]:
        with self._lock:
            return list(self._deployments)

    def listen(self, key: str, known_version: int = -1):
        return self._long_poll.listen(key, known_version)

    def record_handle_metrics(self, deployment: str,
                              queued: float) -> bool:
        with self._lock:
            self._metrics.setdefault(deployment, {})["queued"] = queued
            self._metrics[deployment]["ts"] = time.monotonic()
        return True

    def _health_reasons(self) -> List[str]:
        """The /api/healthz degraded-provider payload: every dead
        serve component this controller currently knows about."""
        with self._lock:
            return list(self._degraded.values())

    def graceful_shutdown(self) -> bool:
        self._shutdown.set()
        _health.unregister_degraded_provider("serve")
        # Release long-poll waiters FIRST: an in-flight listen would
        # otherwise hold an executor thread (and its client's get) in a
        # 30s condvar wait long after this actor is gone.
        self._long_poll.shutdown()
        # Let the in-flight reconcile pass finish before tearing down:
        # it could otherwise start a replica after we've iterated
        # st.replicas (a detached-actor leak) or re-write the
        # checkpoint after the wipe below.
        self._reconciler.join(timeout=10.0)
        with self._lock:
            states = list(self._deployments.values())
            self._deployments.clear()
            self._routes.clear()
        for st in states:
            for r in st.replicas:
                self._stop_replica(r)
        with self._ckpt_lock:  # flush any in-flight checkpoint write
            try:
                self._kv().kv_del(_CKPT_KEY, namespace=_CKPT_NS)
            except Exception:
                pass
        return True

    def _on_actor_stop(self):
        """Runtime abrupt-stop hook (`_Actor.stop`): fires on ANY stop
        — kill, crash-simulation, restart-in-place — where
        graceful_shutdown never ran. Retires the reconciler thread and
        releases parked long-poll listeners; without it a killed
        controller leaks both (threads outlive their thread-simulated
        'process')."""
        self._shutdown.set()
        _health.unregister_degraded_provider("serve")
        self._long_poll.shutdown()

    # -- reconcile -------------------------------------------------------

    def _reconcile_loop(self):
        while not self._shutdown.is_set():
            try:
                self._reconcile_once()
            except Exception:
                traceback.print_exc()
            self._shutdown.wait(0.1)

    def _reconcile_once(self):
        with self._lock:
            states = list(self._deployments.values())
        for st in states:
            self._check_replica_health(st)
            self._poll_digests(st)
            self._autoscale(st)
            target = int(st.info.get("num_replicas", 1))
            version = st.version
            changed = False
            # Victims are collected and stopped only AFTER their
            # removal broadcasts: the replica-direct tables (and
            # routers) must see the membership commit before the
            # replica dies, so steady-state dispatch never races a
            # planned stop (the raymc replica_direct property's
            # product-side discipline).
            stops: List[Any] = []
            # Rolling update: stop outdated replicas one at a time.
            outdated = [r for r in st.replicas
                        if st.replica_versions.get(r) != version]
            if outdated and len(st.replicas) >= target:
                victim = outdated[0]
                st.replicas.remove(victim)
                st.forget_replica(victim)
                stops.append(victim)
                changed = True
            while len(st.replicas) < target:
                r = self._start_replica(st)
                if r is None:
                    break
                st.replicas.append(r)
                st.replica_versions[r] = version
                changed = True
            while len(st.replicas) > target:
                victim = st.replicas.pop()
                st.forget_replica(victim)
                stops.append(victim)
                changed = True
            if changed or st.status == "UPDATING":
                up_to_date = all(st.replica_versions.get(r) == version
                                 for r in st.replicas)
                if len(st.replicas) == target and up_to_date:
                    st.status = "HEALTHY"
                self._broadcast(st.name, st.replicas)
            for victim in stops:
                self._stop_replica(victim)
            if changed:
                self._checkpoint()

    def _poll_digests(self, st: _DeploymentState):
        """Cache-affinity digest channel: collect each replica's hot
        prefix-head digests (``prefix_digests()``, answered by LLM
        deployments; None for everything else) and broadcast the
        per-replica-name snapshot on ``digests::<deployment>`` for the
        proxy fleet's replica-direct tables. Fire-and-collect like the
        health pings — the reconcile loop never blocks on a replica.
        Purely advisory: any failure leaves the last snapshot standing
        (the router degrades to least-loaded/round-robin)."""
        if not ray_config.llm_affinity_routing:
            return
        now = time.monotonic()
        if now - st.last_digest < ray_config.llm_digest_refresh_s:
            return
        st.last_digest = now
        changed = False
        for r in list(st.replicas):
            rname = st.replica_names.get(r)
            if not rname:
                continue
            prev = st.digest_pings.pop(r, None)
            if prev is not None:
                try:
                    ready, _ = ray_tpu_torch.wait([prev], timeout=0)
                except Exception:
                    ready = []
                if not ready:
                    st.digest_pings[r] = prev  # still in flight
                    continue
                doc = None
                try:
                    doc = ray_tpu_torch.get(prev, timeout=0.1)
                except Exception:
                    doc = None
                if doc != st.digests.get(rname):
                    if doc is None:
                        st.digests.pop(rname, None)
                    else:
                        st.digests[rname] = doc
                    changed = True
            try:
                st.digest_pings[r] = r.prefix_digests.remote()
            except Exception:
                pass
        live = {st.replica_names.get(r) for r in st.replicas}
        for rname in [n for n in st.digests if n not in live]:
            st.digests.pop(rname, None)
            changed = True
        if changed:
            self._long_poll.notify_changed(f"digests::{st.name}",
                                           dict(st.digests))

    def _check_replica_health(self, st: _DeploymentState):
        """Replica supervision: detect dead replicas and remove them
        from membership (broadcast FIRST), so the reconcile pass below
        replaces them — before this, a replica dying under a live
        controller stayed dead forever (only controller *recovery*
        re-checked liveness).

        Liveness is two-tier: (a) the named-actor registry — a DEAD
        replica's name is gone, definitive, instant; (b) a
        ``check_health`` ping collected on later passes — an
        ActorDiedError answer is death, a user-raised error is a
        strike, and a ping still pending past
        ``serve_replica_health_timeout_s`` is a strike too (the hung/
        deadlocked-replica detector — a merely BUSY replica serves the
        FIFO'd ping within one item's time, while a wedged one never
        does). ``serve_replica_health_failures`` consecutive strikes =
        dead; any successful ping resets the count.
        """
        now = time.monotonic()
        if now - st.last_health < ray_config.serve_replica_health_period_s:
            return
        st.last_health = now
        # Degraded-reason retirement: only once the fleet is back at
        # target AND every replica's last ping answered ok — clearing
        # on "replacement started" would close healthz's degraded
        # window before the replacement can actually serve.
        with self._lock:
            has_degraded = any(k.startswith(f"replica:{st.name}:")
                               for k in self._degraded)
        if has_degraded and st.status == "HEALTHY" and \
                len(st.replicas) >= int(st.info.get("num_replicas", 1)) \
                and all(r in st.health_ok for r in st.replicas):
            with self._lock:
                for key in [k for k in self._degraded
                            if k.startswith(f"replica:{st.name}:")]:
                    del self._degraded[key]
            from ray_tpu_torch._private.events import record_event

            record_event("serve", f"deployment {st.name} recovered: "
                         f"all replicas confirm healthy",
                         deployment=st.name)
        dead: List[Any] = []
        for r in list(st.replicas):
            rname = st.replica_names.get(r)
            cause = ""
            if rname:
                try:
                    ray_tpu_torch.get_actor(rname)
                except ValueError:
                    cause = "actor gone from the registry"
                except Exception:
                    pass
            if not cause:
                # Collect an earlier ping (never blocks: timeout 0).
                prev = st.health_pings.pop(r, None)
                resend = True
                if prev is not None:
                    ref, sent_at = prev
                    try:
                        ready, _ = ray_tpu_torch.wait([ref], timeout=0)
                    except Exception:
                        ready = []
                    if ready:
                        try:
                            ray_tpu_torch.get(ref, timeout=0.1)
                            st.health_strikes.pop(r, None)
                            st.health_ok.add(r)
                        except ActorDiedError as e:
                            cause = f"health ping failed: {e}"
                        except Exception as e:  # noqa: BLE001
                            strikes = st.health_strikes.get(r, 0) + 1
                            st.health_strikes[r] = strikes
                            if strikes >= \
                                    ray_config.serve_replica_health_failures:
                                cause = (f"{strikes} consecutive failed "
                                         f"health checks ({e})")
                    elif now - sent_at > \
                            ray_config.serve_replica_health_timeout_s:
                        # Unanswered past the timeout: hung-replica
                        # strike — but ONLY when the replica made no
                        # progress since the ping was sent. A
                        # SATURATED replica's ping queues behind a
                        # deep mailbox (admission caps exceed its
                        # execution slots by design) while requests
                        # keep completing; striking it would kill a
                        # healthy replica under exactly the load that
                        # needs it, and the replacement would saturate
                        # and be killed again — a kill loop. Progress
                        # stamps are process-local (replica.py); a
                        # remote replica with no visible stamp still
                        # strikes (conservative, same as pre-fix).
                        from ray_tpu_torch.serve._private.replica import (
                            last_progress,
                        )

                        progressed = rname and \
                            (last_progress(rname) or 0.0) >= sent_at
                        st.health_pings[r] = prev
                        resend = False
                        if progressed:
                            st.health_strikes.pop(r, None)
                        else:
                            strikes = st.health_strikes.get(r, 0) + 1
                            st.health_strikes[r] = strikes
                            if strikes >= \
                                    ray_config.serve_replica_health_failures:
                                cause = (f"unresponsive: health ping "
                                         f"unanswered for "
                                         f"{now - sent_at:.1f}s with "
                                         f"no completed request since "
                                         f"({strikes} strikes)")
                    else:
                        # In flight, within the timeout: keep waiting.
                        st.health_pings[r] = prev
                        resend = False
                if resend and not cause:
                    try:
                        st.health_pings[r] = (r.check_health.remote(),
                                              now)
                    except Exception as e:  # noqa: BLE001
                        cause = f"health ping could not be sent: {e}"
            if cause:
                dead.append((r, rname, cause))
        if not dead:
            return
        for r, rname, cause in dead:
            if r in st.replicas:
                st.replicas.remove(r)
            st.forget_replica(r)
            # A strike-dead (wedged, not crashed) replica is still
            # alive: kill it so it cannot linger half-serving after
            # its removal broadcast (no-op for already-dead actors).
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
            with self._lock:
                self._degraded[f"replica:{st.name}:{rname}"] = (
                    f"serve_replica_dead: deployment {st.name} replica "
                    f"{rname or '(unnamed)'} removed ({cause}); "
                    f"{len(st.replicas)}/"
                    f"{int(st.info.get('num_replicas', 1))} live, "
                    f"replacing")
            from ray_tpu_torch._private.events import record_event

            record_event("serve",
                         f"replica {rname} of {st.name} found dead "
                         f"({cause}); replacing", deployment=st.name)
        st.status = "UPDATING"
        # Removal commits to long-poll BEFORE any replacement work (or
        # the next dispatch): routers and replica-direct tables drop
        # the dead replica now.
        self._broadcast(st.name, st.replicas)
        self._checkpoint()

    def _route_burn(self, deployment: str) -> float:
        """Max short-window SLO burn over the deployment's routes —
        status-aware (PR 6), so proxy load-shed 503s push it up. The
        tracker sample is rate-limited to ~1/s across ALL deployments
        (the reconcile loop ticks at 10Hz)."""
        now = time.monotonic()
        if now - self._last_burn_sample >= 1.0:
            self._last_burn_sample = now
            try:
                _health.tracker.sample()
                rates = _health.tracker.burn_rates()
            except Exception:
                rates = {}
            with self._lock:
                routes = dict(self._routes)
            burns: Dict[str, float] = {}
            for route, windows in rates.items():
                dep = routes.get(route)
                if dep is None:
                    continue
                burn = float(windows.get("short", 0.0))
                if burn > burns.get(dep, 0.0):
                    burns[dep] = burn
            self._burn_cache = burns
        return self._burn_cache.get(deployment, 0.0)

    def _autoscale(self, st: _DeploymentState):
        cfg = st.info.get("autoscaling_config")
        if not cfg:
            return
        m = self._metrics.get(st.name)
        if not m:
            return
        # Routers report continuously while anything is queued or in
        # flight (Router._report_loop) and send a final 0 on drain, so
        # scale-down normally rides FRESH zero reports. The stale branch
        # is only the backstop for a vanished driver/router — generous
        # threshold so a mid-request deployment whose router hiccups is
        # never torn down under its callers.
        stale = time.monotonic() - m.get("ts", 0) > 30
        queued = 0.0 if stale else m["queued"]
        target_in_flight = cfg.get("target_num_ongoing_requests_per_replica",
                                   1.0)
        current = max(1, len(st.replicas))
        max_replicas = cfg.get("max_replicas", current)
        desired = queued / max(target_in_flight, 1e-6)
        desired = int(min(max(desired, cfg.get("min_replicas", 1)),
                          max_replicas))
        # SLO-burn input (closes the ROADMAP loop): a route burning its
        # error budget — status-aware, so the proxy's own load-shed
        # 503s count — scales UP one replica per cooldown even when
        # the queue signal reads low (e.g. requests being shed never
        # reach the router's queue metric), and a burning deployment
        # never scales DOWN under its callers.
        burn = 0.0
        burn_thr = float(ray_config.serve_autoscale_burn_threshold)
        if burn_thr > 0:
            burn = self._route_burn(st.name)
            if burn > burn_thr:
                desired = max(desired, len(st.replicas))
                now = time.monotonic()
                if desired < max_replicas and now - st.last_burn_scale \
                        >= ray_config.serve_autoscale_cooldown_s:
                    st.last_burn_scale = now
                    desired += 1
        if desired != st.info.get("num_replicas"):
            from ray_tpu_torch._private.events import record_event

            record_event(
                "serve", f"autoscaling {st.name}: "
                f"{st.info.get('num_replicas')} -> {desired} replicas "
                f"(queued={queued:.0f}, burn={burn:.1f}x)",
                deployment=st.name)
            st.info["num_replicas"] = desired
            st.status = "UPDATING"

    def _start_replica(self, st: _DeploymentState):
        info = st.info
        try:
            # Replicas serve queries concurrently up to the queries cap
            # (the reference replica is an asyncio actor).
            opts: Dict[str, Any] = {
                # The router already enforces max_concurrent_queries as
                # the in-flight cap; the replica needs only enough
                # executor threads for real parallelism — one OS thread
                # per queued query (100 threads x N replicas) starves
                # small hosts.
                "max_concurrency": min(
                    int(info.get("max_concurrent_queries") or 100), 16),
            }
            res = dict(info.get("ray_actor_options") or {})
            if "num_cpus" in res:
                opts["num_cpus"] = res["num_cpus"]
            if "num_gpus" in res:
                opts["num_gpus"] = res["num_gpus"]
            # Named + detached so a recovered controller can re-attach
            # live replicas instead of cold-starting the fleet.
            rname = f"SERVE_REPLICA::{st.name}::{uuid.uuid4().hex[:8]}"
            opts["name"] = rname
            opts["lifetime"] = "detached"
            r = ServeReplica.options(**opts).remote(
                st.name, info["cls"], info.get("init_args"),
                info.get("init_kwargs"), info.get("user_config"),
                st.version, actor_name=rname)
            st.replica_names[r] = rname
            return r
        except Exception:
            st.message = traceback.format_exc()
            return None

    def _stop_replica(self, replica):
        try:
            # Await the drain (bounded slightly above the replica's own
            # 10s in-flight wait): a fire-and-forget send would race the
            # kill below, skipping both the graceful drain and the
            # replica's teardown (request-loop stop + lag-sampler
            # component retirement).
            try:
                ray_tpu_torch.get(replica.prepare_for_shutdown.remote(),
                            timeout=12.0)
            except Exception:
                pass
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    def _broadcast(self, deployment: str, replicas: List[Any]):
        self._long_poll.notify_changed(f"replicas::{deployment}",
                                       list(replicas))


def get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        try:
            # max_restarts=-1: a crashed controller restarts in place,
            # re-runs __init__, and recovers from the KV checkpoint —
            # the reference's controller FT loop (serve/controller.py:70).
            return ServeController.options(
                name=CONTROLLER_NAME, lifetime="detached",
                max_concurrency=64, num_cpus=0,
                max_restarts=-1).remote()
        except ValueError:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)


def resolve_live_controller(ping_timeout: float = 2.0):
    """The ONE controller-replacement probe the data plane shares
    (routers, proxies, long-poll clients): resolve the well-known name
    and prove liveness with a cheap ping. Returns a handle or None."""
    try:
        handle = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(handle.get_routes.remote(), timeout=ping_timeout)
        return handle
    except Exception:
        return None
