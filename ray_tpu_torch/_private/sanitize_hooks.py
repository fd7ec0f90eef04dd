"""Sanitizer/scheduler instrumentation seams.

The runtime sanitizers (``tools/raysan``) and the deterministic
interleaving harness (``tools.raysan.sched``) need hooks *inside* the
concurrency-critical paths — the router's reserved→in-flight handoff,
the coalescing batcher's drain, the pipelined client's reader loop —
but ``ray_tpu_torch`` must not import ``tools`` (the dependency points the
other way: tooling observes the runtime). This module is the seam:
near-zero-cost no-ops by default, installed into by raysan when a
sanitizer or schedule is active.

Cost when nothing is installed: one global load and a ``None`` check
per site. The sites are control-plane boundaries (a dispatch, a frame
flush, a teardown) — not per-object hot loops — so this stays far
below measurement noise; the A/B observability bench budget covers it.

Four hooks:

- ``sched_point(name)``: a named yield point. A deterministic schedule
  (``tools.raysan.sched.Schedule``) installs a callable that can park
  the calling thread until the scripted/seeded interleaving lets it
  cross. Points are crossed on every call in instrumented builds, so
  names must be stable identifiers (``"router.handoff"``, not
  per-request strings).
- ``crash_point(name)``: a named crash-fault point at a protocol
  boundary (the group-commit window, a frame dispatch). The bounded
  model checker (``tools.raymc``) or a replay schedule may install a
  hook that raises :class:`SimulatedCrash` here, modelling a process
  dying at exactly this instant; the checking harness catches it at
  the top of the faulted activity and performs the kill/restart. A
  crash point doubles as a yield point for interleaving control.
- ``ambient_set(kind, value)``: observation tap fired by the
  thread-local ambient setters in ``task_spec`` so the ambient
  sanitizer can see per-thread residue it cannot otherwise reach
  (C ``_thread._local`` storage is invisible from other threads).
  The calling thread's ident is derived here and handed to the
  installed observer as ``(kind, ident, value)``.
- ``spec_op(name, phase, obj, payload)``: an operation-boundary tap on
  the pure decision cores (``QuotaLedger``, ``FairTaskQueue``,
  ``DepTable``, ``ActorRestartGate``, ``ShardedTable``) and the
  actor-call exactly-once protocol. ``tools/rayspec`` installs a
  history recorder here and checks the captured concurrent
  invocation/response histories against each core's executable
  sequential specification (linearizability / refinement). ``phase``
  is ``"call"`` (operation entered; ``payload`` = argument view) or
  ``"ret"`` (operation returning; ``payload`` = result view); ``obj``
  is the core instance, used only for identity so one process-wide
  recorder can partition events per core instance. Point names are
  ``spec.<core>.<op>``, registered in :data:`SPEC_POINTS` (folded into
  ``SCHED_POINTS`` so the R8 literal-name contract and the raymc point
  catalog cover them); while a recorder is installed, the ``call``
  phase also crosses the sched-point seam, so a raysan ``Schedule``
  can gate spec operations — that is how rayspec's emitted violation
  scripts replay.

Every product call site must use a literal name registered below in
``SCHED_POINTS``/``CRASH_POINTS`` (raylint R8 enforces it): a typo'd
name would silently never gate, and the registry IS the raymc point
catalog — the checker's map of where it can seize control.
"""

from __future__ import annotations

from typing import Callable, Optional


class SimulatedCrash(BaseException):
    """An injected crash fault: the process/component notionally dies at
    the crash point that raised this. A ``BaseException`` deliberately:
    product recovery code that catches ``Exception`` (or routes
    ``BaseException`` into an error *reply*) must not convert a
    simulated death into a handled error — the fault harness alone
    catches this, at the boundary of the activity it chose to kill."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point!r}")
        self.point = point


# Decision-core operation boundaries tapped by the rayspec history
# recorder (``spec.<core>.<op>``; crossed via :func:`spec_op`, not
# :func:`sched_point`). Registered separately so tooling can tell the
# two seam kinds apart, but folded into ``SCHED_POINTS`` below: R8's
# literal-name contract and raymc's point catalog cover both, and a
# raysan ``Schedule`` may gate a spec op's call phase while a recorder
# is installed (rayspec's violation scripts rely on it). raylint R9
# additionally pins the registry ↔ call-site ↔ SPEC_CATALOG agreement.
SPEC_POINTS = frozenset({
    # tenancy.QuotaLedger: queued-ceiling admission, queue exit, CPU
    # charge/release, the drainer's batched charge, lease slots
    "spec.quota.admit",
    "spec.quota.dequeue",
    "spec.quota.charge",
    "spec.quota.release",
    "spec.quota.drain",
    "spec.quota.lease_acquire",
    "spec.quota.lease_release",
    # sched_state.DepTable: park / ready-claim / sweep-claim
    "spec.dep.park",
    "spec.dep.ready",
    "spec.dep.sweep",
    # sched_state.ShardedTable: refinement of one flat dict
    "spec.table.get",
    "spec.table.set",
    "spec.table.pop",
    "spec.table.contains",
    "spec.table.setdefault",
    # actor_gate.ActorRestartGate: FSM edges + per-call decisions
    "spec.actor.register",
    "spec.actor.restart",
    "spec.actor.ready",
    "spec.actor.rollback",
    "spec.actor.dead",
    "spec.actor.route",
    "spec.actor.replay",
    # cluster head actor-call exactly-once protocol: a call entering
    # the in-flight table / its output REPORT being applied (the FT
    # gap (a) double-execution witness rides these)
    "spec.call.invoke",
    "spec.call.apply",
    # scheduler WFQ runnable queue: enqueue / fair pick
    "spec.wfq.put",
    "spec.wfq.pop",
    # kv_cache.PrefixCache: prefix-tree read (longest-match pin), extra
    # pin, unpin, block admission (may evict LRU), pressure eviction
    "spec.kv.lookup",
    "spec.kv.pin",
    "spec.kv.release",
    "spec.kv.admit",
    "spec.kv.evict",
})

# The registered yield-point catalog. Grouped by component; the first
# dotted segment is the point's conflict domain (raymc's partial-order
# reduction treats crossings in different domains as independent).
SCHED_POINTS = SPEC_POINTS | frozenset({
    # serve router: the reserved→in-flight slot handoff
    "router.handoff",
    # memory store: object publication and wait-path snapshot
    "store.put",
    "store.wait",
    # rpc batcher / pipelined channel / server dispatch
    "rpc.batcher.add",
    "rpc.batcher.flush",
    "rpc.pipeline.send",
    "rpc.pipeline.reader_edge",
    "rpc.pipeline.reply_handled",
    "rpc.pipeline.closed_set",
    "rpc.server.dispatch",
    "rpc.server.reply",
    # worker pool execution edge
    "workerpool.run",
    # gcs registry writes (the group-commit frontend)
    "gcs.put",
    # serve long-poll membership channel
    "longpoll.listen",
    "longpoll.notify",
    "longpoll.client.loop",
    # serve replica-direct dispatch: the proxy-side slot claim, the
    # long-poll-fed membership commit, and the completion release —
    # the handoff seams of the proxy→replica fast path (raymc
    # replica_direct proves no acquire returns a replica whose removal
    # already committed, and that slot accounting stays exact).
    "serve.direct.acquire",
    "serve.direct.update",
    "serve.direct.release",
    # cluster node: one coalesced submit_batch frame dispatch
    "cluster.submit_batch",
    # object plane: spill pipeline (disk write done → entry flip) and
    # transparent restore; one native descriptor-pull about to start
    "spill.mark",
    "spill.restore",
    "objplane.pull",
    # actor fault tolerance: the restart gate's routing decision (park /
    # dispatch / reject), the replay-or-reject decision for a call whose
    # node died mid-flight, and the restart FSM edges
    "actor.route",
    "actor.replay",
    "actor.restart.begin",
    "actor.restart.ready",
    # lineage reconstruction: a locate miss deciding to reconstruct,
    # the re-execution resubmit, and a restore from a spilled copy
    "recon.request",
    "recon.resubmit",
    "recon.restore",
    # head registration surface (GCS-restart convergence: the report-
    # returns-False → re-register path)
    "head.node_report",
    "head.register",
    # multi-process head: the coordinator's key->shard routing decision
    # and a shard's row-table apply (the cross_shard raymc scenario's
    # interleaving surface; the per-shard commit boundary reuses the
    # gcs.commit.* crash points of the shard's own store)
    "headshard.route",
    "headshard.apply",
    # tenancy enforcement: quota check-and-charge / release and the
    # over-quota park (the quota_admission raymc scenario's
    # interleaving surface). Each fires ONLY for jobs with a
    # configured quota, so unquota'd hot paths cross nothing. The WFQ
    # queue's enqueue/serve edges are gated scenario-side
    # (mc.sync.wfq.*) — a product crossing there would fire on every
    # idle dispatch-loop poll and get the runtime's own dispatcher
    # adopted into the exploration.
    "tenancy.acquire",
    "tenancy.release",
    "tenancy.park",
    # scheduler dep-park table: the ready-path claim and the death
    # sweep's claim (the dep_sweep raymc scenario's interleaving
    # surface — exactly-once handoff between the two).
    "sched.dep_ready",
    "sched.dep_sweep",
    # LLM prefix/KV cache: the lookup-pin, payload release, block
    # admission, and pressure eviction edges (the kv_cache_reuse raymc
    # scenario's interleaving surface — a hit racing admit/evict must
    # never read freed KV bytes).
    "llm.kv.lookup",
    "llm.kv.release",
    "llm.kv.admit",
    "llm.kv.evict",
})

CRASH_POINTS = frozenset({
    # sqlite group commit: death before the fsync-bearing COMMIT (the
    # window's accepted-but-undurable writes must roll back) vs. death
    # after it but before the ack returns (they must survive).
    "gcs.commit.before",
    "gcs.commit.after",
    # spill pipeline: death with the disk copy written but the store
    # entry not yet flipped (the file is an orphan, the value must
    # still be served from memory — never lost, never double-freed).
    "spill.write.after",
})

POINTS = SCHED_POINTS | CRASH_POINTS

_sched_point: Optional[Callable[[str], None]] = None
_crash_point: Optional[Callable[[str], None]] = None
_ambient_set: Optional[Callable[[str, int, object], None]] = None
_spec_op: Optional[Callable[[str, str, object, object], None]] = None
# Public mirror of "_spec_op is installed": the inline guard hot tap
# sites read (one module-attr load + truth test, ~30ns uninstalled —
# cheaper than calling spec_op just to no-op, and public so call sites
# outside _private stay R3-clean). Kept in sync by install_spec_op.
spec_taps_active = False


def sched_point(name: str) -> None:
    """Cross the named yield point (no-op unless a schedule is
    installed; see module docstring for cost)."""
    hook = _sched_point
    if hook is not None:
        hook(name)


def install_sched_point(fn: Optional[Callable[[str], None]]) -> None:
    global _sched_point
    _sched_point = fn


def crash_point(name: str) -> None:
    """Cross the named crash-fault point. No-op unless a fault harness
    is installed; the installed hook may raise :class:`SimulatedCrash`
    to kill the calling activity at exactly this boundary."""
    hook = _crash_point
    if hook is not None:
        hook(name)


def install_crash_point(fn: Optional[Callable[[str], None]]) -> None:
    global _crash_point
    _crash_point = fn


def spec_op(name: str, phase: str, obj: object,
            payload: object = None) -> None:
    """Report a decision-core operation boundary to the installed
    rayspec recorder (no-op unless one is installed; cost then is one
    global load and a ``None`` check — same contract as
    :func:`sched_point`). ``phase`` is ``"call"`` or ``"ret"``; the
    payload is a cheap view of args/result the recorder's per-point
    adapters interpret. While a recorder is installed, the call phase
    also crosses the sched-point seam so a raysan ``Schedule`` can
    order spec operations (rayspec violation-script replay)."""
    hook = _spec_op
    if hook is None:
        return
    if phase == "call":
        gate = _sched_point
        if gate is not None:
            gate(name)
    hook(name, phase, obj, payload)


def install_spec_op(
        fn: Optional[Callable[[str, str, object, object], None]]) -> None:
    global _spec_op, spec_taps_active
    _spec_op = fn
    spec_taps_active = fn is not None


def spec_recording() -> bool:
    """True while a rayspec recorder is installed — the gate for call
    sites whose probe PAYLOAD is itself costly to build (they must pay
    nothing when nothing records)."""
    return _spec_op is not None


def ambient_set(kind: str, value: object) -> None:
    """Report an ambient thread-local write to the installed observer
    (called by ``task_spec.set_ambient_*`` with the NEW value)."""
    hook = _ambient_set
    if hook is not None:
        import threading

        hook(kind, threading.get_ident(), value)


def install_ambient_observer(
        fn: Optional[Callable[[str, int, object], None]]) -> None:
    global _ambient_set
    _ambient_set = fn
