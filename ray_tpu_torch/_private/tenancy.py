"""Tenancy enforcement plane: the pure decision cores.

PR 6 built the *observability* half of multi-tenancy (job tags flow
driver→proxy→router→replica→tasks; per-job CPU-seconds/objects/bytes
are metered). This module is the *enforcement* half — the part that
makes one tenant's flood somebody else's non-problem. Reference roles:
the scheduler-side lease admission policies (`scheduling/policy/`),
Serve's per-application ingress limits, and the plasma arena's
per-client quota accounting.

Design discipline matches ``actor_gate.py``: every class here is pure
decision state — locks and counters, no RPC, no threads, no product
imports — so the bounded model checker (``tools/raymc``
``quota_admission`` scenario) can prove the admission invariants over
every interleaving at small scope, and the product layers wire the
decisions to real effects:

- :class:`QuotaLedger` — per-job resource quotas (CPU slots, concurrent
  leases, queued-task ceiling), checked at lease grant / local dispatch
  (``cluster_utils.ClusterBackendMixin`` + ``local_backend``);
- :class:`FairTaskQueue` — virtual-time weighted fair queuing over the
  scheduler's runnable queue (``local_backend._ready``);
- :class:`FairShare` — the same virtual-time law applied to the serve
  ``Router``'s contended replica slots;
- :class:`TokenBucket` / :class:`IngressLimiter` — per-tenant ingress
  rate limits enforced by ``http_proxy`` before work enters the router;
- arena-budget helpers — per-job shared-segment budgets driving the
  pressure-spill victim order in ``shm_plane``.

Config grammar (see README "Multi-tenancy"):

- ``job_quotas``:   ``"jobA=cpus:2,queued:100,leases:2;jobB=cpus:1"``
- ``job_weights``:  ``"jobA=4,jobB=1"`` (unlisted jobs: ``job_default_weight``)
- ``ingress_rate_limits``: ``"jobA=100:200;jobB=10"`` (rate[:burst] per s)
- ``job_arena_budgets``:   ``"jobA=64m;jobB=268435456"`` (k/m/g suffixes)

Malformed entries are dropped, never fatal — a bad config line must not
take the control plane down (same contract as ``parse_slo_targets``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import perf_stats as _perf_stats
from ray_tpu_torch._private import sanitize_hooks
from ray_tpu_torch._private.config import ray_config

# Distinct job ids any one enforcement structure will track (same
# cardinality bound as the proxy's X-Job-Id cap): tags are client- or
# config-controlled, and an attacker cycling tokens must not mint
# unbounded ledger rows or token buckets. Overflow degrades to the
# default (untagged) class.
MAX_TRACKED_JOBS = 512


def quota_counter(kind: str, job: str):
    """``ray_tpu_job_quota_<kind>_total{job}`` after the runtime-metrics
    fold: kind ∈ rejections | parks | lease_denials."""
    return _perf_stats.counter(f"job_quota_{kind}", {"job": job})


def enforcement_enabled() -> bool:
    return bool(ray_config.tenancy_enforcement)


# -- config grammar ----------------------------------------------------------


def _split_entries(raw: str):
    """``"a=...;b=..."`` (``;`` or ``,`` between entries where
    unambiguous — quotas use ``;`` only, simple maps accept both)."""
    for part in raw.replace("\n", ";").split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        job, _, body = part.partition("=")
        job = job.strip()
        if not job:
            continue
        yield job, body.strip()


def parse_bytes(raw: str) -> Optional[int]:
    """``"64m"`` → 67108864; plain ints pass through; None on junk."""
    raw = raw.strip().lower()
    mult = 1
    if raw and raw[-1] in "kmg":
        mult = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3}[raw[-1]]
        raw = raw[:-1]
    try:
        n = int(float(raw) * mult)
    except ValueError:
        return None
    return n if n >= 0 else None


@dataclass
class JobQuota:
    """Per-job ceilings; -1 = unlimited. ``cpu_milli`` bounds the job's
    concurrently *running* CPU-slots (milli-CPU, matching the
    scheduler's resource math), ``leases`` its concurrently held
    pipelined dispatch leases, ``queued`` its admitted-but-not-started
    tasks."""

    cpu_milli: int = -1
    leases: int = -1
    queued: int = -1


def parse_job_quotas(raw: Optional[str] = None) -> Dict[str, JobQuota]:
    """``"jobA=cpus:2,queued:100,leases:2;jobB=cpus:1"`` — cpus are
    float CPU slots (converted to milli), queued/leases integer counts.
    Unknown keys and malformed values are dropped."""
    if raw is None:
        raw = ray_config.job_quotas
    out: Dict[str, JobQuota] = {}
    for job, body in _split_entries(raw):
        q = JobQuota()
        valid = False
        for kv in body.split(","):
            key, _, val = kv.strip().partition(":")
            try:
                if key == "cpus":
                    q.cpu_milli = max(0, int(float(val) * 1000))
                elif key == "queued":
                    q.queued = max(0, int(val))
                elif key == "leases":
                    q.leases = max(0, int(val))
                else:
                    continue
                valid = True
            except ValueError:
                continue
        if valid and len(out) < MAX_TRACKED_JOBS:
            out[job] = q
    return out


def parse_job_weights(raw: Optional[str] = None) -> Dict[str, float]:
    """``"jobA=4,jobB=1"`` — weights must be > 0 (a zero weight would
    starve by construction; the non-starvation property only covers
    nonzero-weight classes, so zero is rejected at parse)."""
    if raw is None:
        raw = ray_config.job_weights
    out: Dict[str, float] = {}
    for job, body in _split_entries(raw.replace(",", ";")):
        try:
            w = float(body)
        except ValueError:
            continue
        if w > 0 and len(out) < MAX_TRACKED_JOBS:
            out[job] = w
    return out


# Weights are read per served item on the dispatch hot path: cache the
# parse keyed on the config string (replaced wholesale on change, never
# grown).
_weights_cache: Tuple[Optional[str], Dict[str, float]] = (None, {})


def cached_job_weights() -> Dict[str, float]:
    global _weights_cache
    raw = ray_config.job_weights
    if raw != _weights_cache[0]:
        _weights_cache = (raw, parse_job_weights(raw))
    return _weights_cache[1]


def parse_rate_limits(raw: Optional[str] = None) \
        -> Dict[str, Tuple[float, float]]:
    """``"jobA=100:200;jobB=10"`` → {job: (rate_per_s, burst)}; burst
    defaults to the rate."""
    if raw is None:
        raw = ray_config.ingress_rate_limits
    out: Dict[str, Tuple[float, float]] = {}
    for job, body in _split_entries(raw):
        rate_s, _, burst_s = body.partition(":")
        try:
            rate = float(rate_s)
            burst = float(burst_s) if burst_s else rate
        except ValueError:
            continue
        if rate > 0 and burst > 0 and len(out) < MAX_TRACKED_JOBS:
            out[job] = (rate, burst)
    return out


def parse_arena_budgets(raw: Optional[str] = None) -> Dict[str, int]:
    """``"jobA=64m;jobB=268435456"`` → {job: budget_bytes}."""
    if raw is None:
        raw = ray_config.job_arena_budgets
    out: Dict[str, int] = {}
    for job, body in _split_entries(raw):
        n = parse_bytes(body)
        if n is not None and n > 0 and len(out) < MAX_TRACKED_JOBS:
            out[job] = n
    return out


# -- quota ledger ------------------------------------------------------------


class QuotaLedger:
    """Per-job admission + usage accounting: the ONE structure both the
    head's lease path and the local backend's dispatch gate consult, so
    a job's cluster-wide CPU-slot usage is a single number no matter
    where its tasks land.

    Charge tokens ride the spec itself (``spec._quota_cpu`` /
    ``spec._quota_queued``): every acquire is idempotent per spec and
    every release clears the token, so a spec that crosses layers
    (parked → resubmitted → leased → replayed after a node death) is
    charged exactly once at a time regardless of which layer releases
    it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)
        self._quotas: Dict[str, JobQuota] = {}
        self._src: Optional[str] = None
        self._cpu: Dict[str, int] = {}      # running milli-CPU by job
        self._peak_cpu: Dict[str, int] = {}  # high-water mark (proofs)
        self._queued: Dict[str, int] = {}
        self._leases: Dict[str, int] = {}
        # Specs parked because their job is at its CPU quota, FIFO per
        # job; a single drainer thread (the owner's) resubmits them as
        # capacity frees. Pure state here — the park/drain effects are
        # the caller's.
        self._parked: Dict[str, List] = {}
        # A node process must NOT re-enforce quotas the head already
        # applied at grant time (per-node enforcement of a cluster-wide
        # quota would be wrong twice over).
        self._disabled = False

    # -- configuration ---------------------------------------------------

    def disable(self) -> None:
        self._disabled = True

    def _active_quota(self, job: str) -> Optional[JobQuota]:
        """The job's quota when enforcement is live, else None. Re-parses
        when the config string changed (tests flip it at runtime)."""
        if self._disabled or not enforcement_enabled():
            return None
        raw = ray_config.job_quotas
        if raw != self._src:
            with self._lock:
                if raw != self._src:
                    self._quotas = parse_job_quotas(raw)
                    self._src = raw
        return self._quotas.get(job)

    # -- queued-task ceiling ---------------------------------------------

    def note_queued(self, spec) -> Optional[str]:
        """Admission: None = admitted (queued count charged to the
        spec), else the rejection reason (the queued-task ceiling is
        the job's own submit-flood bound). Idempotent per spec —
        resubmits/replays keep their original admission."""
        if getattr(spec, "_quota_queued", None) is not None:
            return None
        if getattr(spec, "_quota_admitted", False) or \
                getattr(spec, "attempt", 0) > 0 or \
                getattr(spec, "restarts_used", 0) > 0:
            # A retry of ACCEPTED work must never bounce off the
            # ceiling its own job's flood filled: the sticky admitted
            # flag covers every resubmit flavor (lease reroutes,
            # retry_exceptions retries), attempt covers node-death
            # replays, restarts_used covers actor-restart creation
            # resubmits (a bounced restart would strand the gate in
            # RESTARTING).
            return None
        job = getattr(spec, "job_id", "") or ""
        quota = self._active_quota(job)
        if quota is None or quota.queued < 0:
            return None
        sanitize_hooks.spec_op("spec.quota.admit", "call", self,
                               (job, quota.queued))
        reason = None
        with self._lock:
            have = self._queued.get(job, 0)
            if have >= quota.queued:
                quota_counter("rejections", job).inc()
                reason = (f"job {job!r} is at its queued-task ceiling "
                          f"({have} queued, quota queued:{quota.queued}) "
                          f"— submit rejected; release or await existing "
                          f"work, or raise job_quotas for this job")
            else:
                self._queued[job] = have + 1
        sanitize_hooks.spec_op("spec.quota.admit", "ret", self,
                               reason is None)
        if reason is not None:
            return reason
        spec._quota_queued = job
        spec._quota_admitted = True
        return None

    def note_dequeued(self, spec) -> None:
        """The spec left the queue (dispatched or reached a terminal
        error): release its queued-ceiling charge."""
        job = getattr(spec, "_quota_queued", None)
        if job is None:
            return
        spec._quota_queued = None
        sanitize_hooks.spec_op("spec.quota.dequeue", "call", self, job)
        with self._lock:
            left = self._queued.get(job, 0) - 1
            if left > 0:
                self._queued[job] = left
            else:
                self._queued.pop(job, None)
            self._changed.notify_all()
        sanitize_hooks.spec_op("spec.quota.dequeue", "ret", self, None)

    # -- CPU slots -------------------------------------------------------

    def try_acquire_cpu(self, spec, milli: Optional[int] = None) -> bool:
        """Charge the spec's CPU request against its job's quota; False
        when the job is at its cap (the caller parks the spec behind
        the job's own limit). Specs of jobs with no quota — and specs
        already charged — pass for free."""
        if getattr(spec, "_quota_cpu", None) is not None:
            return True
        job = getattr(spec, "job_id", "") or ""
        quota = self._active_quota(job)
        if quota is None or quota.cpu_milli < 0:
            return True
        if milli is None:
            milli = int((spec.resources or {}).get("CPU", 0) * 1000)
        if milli <= 0:
            return True  # zero-CPU work never counts against CPU slots
        sanitize_hooks.spec_op("spec.quota.charge", "call", self,
                               (job, milli, quota.cpu_milli))
        sanitize_hooks.sched_point("tenancy.acquire")
        ok = True
        with self._lock:
            used = self._cpu.get(job, 0)
            if used + milli > quota.cpu_milli:
                ok = False
            else:
                self._cpu[job] = used + milli
                if used + milli > self._peak_cpu.get(job, 0):
                    self._peak_cpu[job] = used + milli
        sanitize_hooks.spec_op("spec.quota.charge", "ret", self, ok)
        if ok:
            spec._quota_cpu = (job, milli)
        return ok

    def release_cpu(self, spec) -> None:
        """Release the spec's CPU charge (terminal state or node-death
        resubmit boundary). Idempotent — the token clears on first
        release."""
        token = getattr(spec, "_quota_cpu", None)
        if token is None:
            return
        spec._quota_cpu = None
        job, milli = token
        sanitize_hooks.spec_op("spec.quota.release", "call", self,
                               (job, milli))
        sanitize_hooks.sched_point("tenancy.release")
        with self._lock:
            left = self._cpu.get(job, 0) - milli
            if left > 0:
                self._cpu[job] = left
            else:
                self._cpu.pop(job, None)
            self._changed.notify_all()
        sanitize_hooks.spec_op("spec.quota.release", "ret", self, None)

    # -- concurrent leases -----------------------------------------------

    def try_acquire_lease(self, job: str) -> bool:
        quota = self._active_quota(job or "")
        if quota is None or quota.leases < 0:
            return True
        sanitize_hooks.spec_op("spec.quota.lease_acquire", "call", self,
                               (job, quota.leases))
        ok = True
        with self._lock:
            have = self._leases.get(job, 0)
            if have >= quota.leases:
                quota_counter("lease_denials", job).inc()
                ok = False
            else:
                self._leases[job] = have + 1
        sanitize_hooks.spec_op("spec.quota.lease_acquire", "ret", self, ok)
        return ok

    def release_lease(self, job: str) -> None:
        sanitize_hooks.spec_op("spec.quota.lease_release", "call", self,
                               job)
        with self._lock:
            left = self._leases.get(job, 0) - 1
            if left > 0:
                self._leases[job] = left
            else:
                self._leases.pop(job, None)
            self._changed.notify_all()
        sanitize_hooks.spec_op("spec.quota.lease_release", "ret", self,
                               None)

    # -- quota parking (over-CPU-quota specs wait HERE, not in the
    #    scheduler, so they consume no cluster capacity) -----------------

    def park(self, spec) -> None:
        job = getattr(spec, "job_id", "") or ""
        quota_counter("parks", job).inc()
        sanitize_hooks.sched_point("tenancy.park")
        with self._lock:
            self._parked.setdefault(job, []).append(spec)
            self._changed.notify_all()  # wake the drainer to (re)arm

    def parked_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._parked.values())

    def take_dispatchable(self) -> List:
        """Pop every parked spec whose job now has CPU headroom,
        charging each under the lock (check + charge are atomic — two
        drain passes must not both dispatch into the last slot).
        Called by the owner's single drainer thread."""
        sanitize_hooks.spec_op("spec.quota.drain", "call", self, None)
        out: List = []
        charged: List[Tuple[str, int, int]] = []
        with self._lock:
            for job in list(self._parked):
                quota = self._quotas.get(job)
                specs = self._parked[job]
                while specs:
                    spec = specs[0]
                    milli = int((spec.resources or {}).get(
                        "CPU", 0) * 1000)
                    if quota is not None and quota.cpu_milli >= 0 \
                            and milli > 0:
                        used = self._cpu.get(job, 0)
                        if used + milli > quota.cpu_milli:
                            break
                        self._cpu[job] = used + milli
                        if used + milli > self._peak_cpu.get(job, 0):
                            self._peak_cpu[job] = used + milli
                        spec._quota_cpu = (job, milli)
                        charged.append((job, milli, quota.cpu_milli))
                    out.append(specs.pop(0))
                if not specs:
                    del self._parked[job]
        sanitize_hooks.spec_op("spec.quota.drain", "ret", self, charged)
        return out

    def wait_change(self, timeout_s: float) -> None:
        with self._changed:
            self._changed.wait(timeout_s)

    # -- introspection ---------------------------------------------------

    def usage(self, job: str) -> Dict[str, int]:
        with self._lock:
            return {
                "cpu_milli": self._cpu.get(job, 0),
                "peak_cpu_milli": self._peak_cpu.get(job, 0),
                "queued": self._queued.get(job, 0),
                "leases": self._leases.get(job, 0),
                "parked": len(self._parked.get(job, ())),
            }

    def jobs(self) -> List[str]:
        with self._lock:
            # _peak_cpu included: a job whose usage drained back to
            # zero keeps its high-water row — the peak is the "never
            # exceeded the quota" proof artifact job_summary shows.
            keys = set(self._cpu) | set(self._queued) | \
                set(self._leases) | set(self._parked) | \
                set(self._peak_cpu)
        return sorted(keys)


# -- weighted fair queuing ---------------------------------------------------


class FairTaskQueue:
    """Drop-in for the scheduler's runnable ``queue.Queue`` with
    per-job virtual-time WFQ ordering.

    Classic virtual-finish-time law: each class (job) carries a virtual
    time advanced by ``cost/weight`` per served item; ``get`` serves
    the backlogged class with the smallest virtual time. A class
    joining an ongoing schedule starts at the global virtual time (no
    credit for having been idle). With enforcement off — or every item
    untagged — everything lands in one class and the queue is exactly
    the FIFO it replaces.

    ``max_bypass`` is the proven non-starvation witness: how many
    consecutive serves ever bypassed a backlogged class. Under the WFQ
    law a backlogged class of weight w is served at least once per
    ceil(total_weight/w) serves; the raymc ``quota_admission`` scenario
    checks the bound over every bounded interleaving.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._weights = weights  # None = read from config per put
        self._classes: Dict[str, List] = {}   # job -> FIFO list
        self._vt: Dict[str, float] = {}       # per-class virtual time
        self._global_vt = 0.0
        self._count = 0
        self._bypass: Dict[str, int] = {}     # consecutive bypasses
        self.max_bypass = 0

    def _weight(self, job: str) -> float:
        weights = self._weights
        if weights is None:
            weights = cached_job_weights()
        return weights.get(job) or max(
            float(ray_config.job_default_weight), 1e-6)

    def _class_of(self, item) -> str:
        if self._weights is None and not enforcement_enabled():
            return ""  # enforcement off: one class, pure FIFO
        return getattr(item, "job_id", "") or ""

    def put(self, item) -> None:
        job = self._class_of(item)
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.wfq.put", "call", self, (job, item))
        with self._cond:
            q = self._classes.get(job)
            if q is None:
                q = self._classes[job] = []
            if not q:
                # (Re)joining: start at the global virtual time — an
                # idle class accrues no credit it could burst on.
                self._vt[job] = max(self._vt.get(job, 0.0),
                                    self._global_vt)
            q.append(item)
            self._count += 1
            self._cond.notify()
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.wfq.put", "ret", self, None)

    def _pop_locked(self):
        best, best_vt = None, 0.0
        for job, q in self._classes.items():
            if not q:
                continue
            vt = self._vt.get(job, 0.0)
            if best is None or vt < best_vt:
                best, best_vt = job, vt
        if best is None:
            return None
        # Non-starvation bookkeeping: every backlogged class NOT served
        # by this pop was bypassed once; the served class resets.
        for job, q in self._classes.items():
            if not q:
                continue
            if job == best:
                self._bypass[job] = 0
            else:
                n = self._bypass.get(job, 0) + 1
                self._bypass[job] = n
                if n > self.max_bypass:
                    self.max_bypass = n
        q = self._classes[best]
        item = q.pop(0)
        self._count -= 1
        self._global_vt = best_vt
        self._vt[best] = best_vt + 1.0 / self._weight(best)
        if not q:
            del self._classes[best]
            self._bypass.pop(best, None)
            # Cardinality bound: job ids are caller-controlled, and a
            # per-submission id would otherwise mint a permanent _vt
            # row. Dropping an EMPTY class's clock is safe — on
            # rejoin it starts at the global virtual time, exactly
            # like a new class.
            if len(self._vt) > MAX_TRACKED_JOBS:
                for stale in [j for j in self._vt
                              if j not in self._classes]:
                    del self._vt[stale]
        return item

    def get(self, timeout: Optional[float] = None):
        import queue as _queue

        # The pop tap's result payload is the served item, None for an
        # empty (timed-out) beat — items are specs/headers, never None.
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.wfq.pop", "call", self, None)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cond:
            while self._count == 0:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    if sanitize_hooks.spec_taps_active:
                        sanitize_hooks.spec_op("spec.wfq.pop", "ret", self,
                                               None)
                    raise _queue.Empty
                self._cond.wait(remaining)
            item = self._pop_locked()
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.wfq.pop", "ret", self, item)
        return item

    def get_nowait(self):
        import queue as _queue

        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.wfq.pop", "call", self, None)
        with self._cond:
            if self._count == 0:
                if sanitize_hooks.spec_taps_active:
                    sanitize_hooks.spec_op("spec.wfq.pop", "ret", self, None)
                raise _queue.Empty
            item = self._pop_locked()
        if sanitize_hooks.spec_taps_active:
            sanitize_hooks.spec_op("spec.wfq.pop", "ret", self, item)
        return item

    def qsize(self) -> int:
        with self._lock:
            return self._count

    def empty(self) -> bool:
        return self.qsize() == 0


class FairShare:
    """Virtual-time fair arbitration over the serve router's contended
    replica slots. The router has no queue to reorder — waiting
    requests poll for a slot — so fairness is a *turn gate*: a dispatch
    may proceed only when its job's virtual time is minimal among the
    jobs currently waiting. Each successful dispatch advances the
    job's virtual time by 1/weight, so a flood job's turns thin out to
    its weight share while a high-weight tenant's stay dense.

    With enforcement off (or no waiters) every dispatch passes — the
    gate costs one lock acquisition on the contended path only.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._lock = threading.Lock()
        self._weights = weights
        self._vt: Dict[str, float] = {}
        self._global_vt = 0.0
        self._waiting: Dict[str, int] = {}

    def _weight(self, job: str) -> float:
        weights = self._weights
        if weights is None:
            weights = cached_job_weights()
        return weights.get(job) or max(
            float(ray_config.job_default_weight), 1e-6)

    def enter_wait(self, job: str) -> None:
        with self._lock:
            self._waiting[job] = self._waiting.get(job, 0) + 1
            if self._waiting[job] == 1:
                self._vt[job] = max(self._vt.get(job, 0.0),
                                    self._global_vt)

    def exit_wait(self, job: str) -> None:
        with self._lock:
            left = self._waiting.get(job, 0) - 1
            if left > 0:
                self._waiting[job] = left
            else:
                self._waiting.pop(job, None)

    def may_dispatch(self, job: str) -> bool:
        """True when no other waiting job has a strictly smaller
        virtual time (ties pass — the replica cap, not this gate, is
        the concurrency bound)."""
        if self._weights is None and not enforcement_enabled():
            return True
        with self._lock:
            if not self._waiting:
                return True
            mine = max(self._vt.get(job, 0.0), self._global_vt) \
                if job not in self._waiting else self._vt.get(job, 0.0)
            return all(self._vt.get(other, 0.0) >= mine
                       for other in self._waiting if other != job)

    def charge(self, job: str) -> None:
        """A dispatch happened: advance the job's virtual time by its
        inverse weight."""
        if self._weights is None and not enforcement_enabled():
            return
        with self._lock:
            vt = max(self._vt.get(job, 0.0), self._global_vt)
            self._global_vt = vt
            self._vt[job] = vt + 1.0 / self._weight(job)
            # Cardinality bound (job tags are caller-controlled): drop
            # non-waiting clocks at or behind the global time — a
            # dropped job re-enters at the global clock, same as new.
            if len(self._vt) > MAX_TRACKED_JOBS:
                for stale in [j for j, v in self._vt.items()
                              if j not in self._waiting
                              and v <= self._global_vt]:
                    del self._vt[stale]
            # Bound float growth on long-lived routers: rebase when the
            # clock runs far ahead (relative order is all that matters).
            if self._global_vt > 1e12:
                base = min(self._vt.values(), default=0.0)
                self._global_vt -= base
                for k in self._vt:
                    self._vt[k] -= base


# -- ingress token buckets ---------------------------------------------------


class TokenBucket:
    """Classic token bucket; ``clock`` injectable for deterministic
    tests. Not thread-safe on its own — :class:`IngressLimiter` holds
    the lock (and the proxy calls from one loop thread anyway)."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float,
                 now: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = time.monotonic() if now is None else now

    def try_take(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = time.monotonic()
        if now > self.last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
        self.last = max(self.last, now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until one token accrues (the 429 Retry-After hint)."""
        if self.tokens >= 1.0 or self.rate <= 0:
            return 0.0
        return (1.0 - self.tokens) / self.rate


class IngressLimiter:
    """Per-tenant token buckets for the HTTP ingress. Buckets are
    minted per distinct job tag up to :data:`MAX_TRACKED_JOBS`;
    overflow tags share the default bucket (the cardinality contract
    the X-Job-Id cap established). A job with no configured limit —
    and no default rate — is never limited."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._clock = clock or time.monotonic
        self._buckets: Dict[str, TokenBucket] = {}
        self._limits: Dict[str, Tuple[float, float]] = {}
        self._src: Optional[str] = None

    def _limit_for(self, job: str) -> Optional[Tuple[float, float]]:
        raw = ray_config.ingress_rate_limits
        if raw != self._src:
            self._limits = parse_rate_limits(raw)
            self._src = raw
            # Minted buckets carry their creation-time rate/burst:
            # drop them on a config change so an operator's runtime
            # limit adjustment actually takes effect (buckets restart
            # at full burst — a one-off grace, not a leak).
            self._buckets.clear()
        limit = self._limits.get(job)
        if limit is not None:
            return limit
        rate = float(ray_config.ingress_default_rate_per_s)
        if rate <= 0:
            return None
        burst = float(ray_config.ingress_default_burst) or rate
        return (rate, burst)

    def try_admit(self, job: str) -> Optional[float]:
        """None = admitted; else seconds to wait (the Retry-After
        payload for the 429)."""
        if not enforcement_enabled():
            return None
        job = job or ""
        with self._lock:
            limit = self._limit_for(job)
            if limit is None:
                return None
            bucket = self._buckets.get(job)
            if bucket is None:
                if len(self._buckets) >= MAX_TRACKED_JOBS:
                    # Cardinality guard: overflow tags share the
                    # DEFAULT class's bucket — limit re-resolved for
                    # "" so the shared bucket never inherits whichever
                    # overflow job's limit happened to arrive first.
                    job = ""
                    limit = self._limit_for(job)
                    if limit is None:
                        return None
                    bucket = self._buckets.get(job)
                if bucket is None:
                    bucket = self._buckets[job] = TokenBucket(
                        limit[0], limit[1], now=self._clock())
            if bucket.try_take(self._clock()):
                return None
            _perf_stats.counter("job_rate_limited", {"job": job}).inc()
            return max(bucket.retry_after_s(), 0.001)


# -- serve priority classes --------------------------------------------------


# Ordinal priority classes for the serve ingress (X-Priority header):
# index IS the shed order — higher index sheds first.
PRIORITY_CLASSES = ("high", "normal", "low")
_PRIORITY_BY_NAME = {name: i for i, name in enumerate(PRIORITY_CLASSES)}
_PRIORITY_DEFAULT = 1  # normal


def parse_priority(raw: str) -> int:
    """``X-Priority`` header value → class index. Accepts the class
    names or their ordinals; anything else — including absence — is
    ``normal`` (a malformed client header must neither crash nor grant
    elevated priority)."""
    raw = (raw or "").strip().lower()
    if not raw:
        return _PRIORITY_DEFAULT
    idx = _PRIORITY_BY_NAME.get(raw)
    if idx is not None:
        return idx
    if raw.isdigit():
        n = int(raw)
        if n < len(PRIORITY_CLASSES):
            return n
    return _PRIORITY_DEFAULT


def parse_shed_fractions(raw: Optional[str] = None) -> Tuple[float, ...]:
    """``serve_priority_shed_fractions`` (``"1.0,1.0,0.5"``) → one
    admission fraction per priority class. Malformed / missing entries
    fall back to 1.0 (never shed below the hard cap) — a config typo
    must not start shedding traffic."""
    if raw is None:
        raw = ray_config.serve_priority_shed_fractions
    out = [1.0] * len(PRIORITY_CLASSES)
    for i, part in enumerate((raw or "").split(",")):
        if i >= len(out):
            break
        try:
            val = float(part.strip())
        except ValueError:
            continue
        if 0.0 <= val <= 1.0:
            out[i] = val
    return tuple(out)


class PriorityGate:
    """Priority-class load shedding for the HTTP ingress: the decision
    half of "shed lowest class first".

    Two independent admission checks, both cheap enough for the
    per-request fast path:

    - **layered thresholds**: class ``c`` is admitted while the proxy's
      in-flight count is below ``capacity * fraction[c]`` — as load
      rises, ``low`` sheds first, then ``normal``, and ``high`` rides
      to the hard cap (fraction defaults keep high/normal at 1.0, so
      untagged traffic behaves exactly as before priorities existed);
    - **per-class token buckets** (``serve_priority_rates``,
      ``"low=50:100"``): a class over its configured rate sheds even
      with in-flight headroom — the knob that keeps a background-class
      flood from consuming the headroom bursts need.

    Returns the Retry-After seconds on shed (the 503 honors it), None
    on admit. Unlike the tenancy quota plane this is always on — it is
    data-plane overload protection, not multi-tenant policy — but the
    default config is behavior-neutral for high/normal traffic.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._clock = clock or time.monotonic
        self._fractions_src: Optional[str] = None
        self._fractions: Tuple[float, ...] = (1.0,) * len(PRIORITY_CLASSES)
        self._rates_src: Optional[str] = None
        self._buckets: Dict[int, TokenBucket] = {}

    def _refresh_locked(self) -> None:
        raw = ray_config.serve_priority_shed_fractions
        if raw != self._fractions_src:
            self._fractions = parse_shed_fractions(raw)
            self._fractions_src = raw
        raw = ray_config.serve_priority_rates
        if raw != self._rates_src:
            limits = parse_rate_limits(raw)
            self._buckets = {
                _PRIORITY_BY_NAME[name]: TokenBucket(rate, burst,
                                                     now=self._clock())
                for name, (rate, burst) in limits.items()
                if name in _PRIORITY_BY_NAME
            }
            self._rates_src = raw

    def try_admit(self, cls: int, in_flight: int,
                  capacity: int) -> Optional[float]:
        """None = admitted; else seconds to wait before retrying (the
        503's Retry-After). ``cls`` is the :func:`parse_priority`
        index; out-of-range values are clamped to the lowest class."""
        cls = min(max(cls, 0), len(PRIORITY_CLASSES) - 1)
        with self._lock:
            self._refresh_locked()
            frac = self._fractions[cls]
            if frac < 1.0 and in_flight >= capacity * frac:
                _perf_stats.counter(
                    "serve_priority_shed",
                    {"class": PRIORITY_CLASSES[cls]}).inc()
                return 1.0
            bucket = self._buckets.get(cls)
            if bucket is not None and not bucket.try_take(self._clock()):
                _perf_stats.counter(
                    "serve_priority_shed",
                    {"class": PRIORITY_CLASSES[cls]}).inc()
                return max(bucket.retry_after_s(), 0.001)
        return None


# -- arena budgets -----------------------------------------------------------


def arena_spill_counter(job: str):
    """``ray_tpu_job_arena_spill_bytes_total{job}``: bytes the pressure
    sweep spilled out of the arena charged to this job — the 'your 256MB
    objects hit YOUR budget' signal in job_summary and the dashboards."""
    return _perf_stats.counter("job_arena_spill_bytes", {"job": job})


def over_budget_jobs(usage: Dict[str, int],
                     budgets: Optional[Dict[str, int]] = None) -> set:
    """Jobs whose charged arena bytes exceed their configured budget
    (jobs without a budget are never 'over')."""
    if budgets is None:
        budgets = parse_arena_budgets()
    if not budgets or not enforcement_enabled():
        return set()
    return {job for job, used in usage.items()
            if job in budgets and used > budgets[job]}


def order_spill_victims(candidates: List[bytes],
                        job_of: Callable[[bytes], str],
                        over: set) -> List[bytes]:
    """Pressure-spill victim order: the over-budget jobs' objects first
    (cold-first within each tier — the input is already oldest-first),
    so one tenant's oversized working set spills ITSELF before it can
    evict anyone else's."""
    if not over:
        return candidates
    first = [ob for ob in candidates if job_of(ob) in over]
    rest = [ob for ob in candidates if job_of(ob) not in over]
    return first + rest
