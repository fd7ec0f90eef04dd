"""Task and actor specifications: the unit handed to the scheduler.

Role-equivalent to the reference's ``TaskSpecification``
(``src/ray/common/task/task_spec.h:182``): everything the execution backend
needs to place and run one invocation — function payload, arguments (inline
values and ObjectRef dependencies), resource request, retry policy, and
scheduling strategy.
"""

from __future__ import annotations

import collections
import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch._private import sanitize_hooks
from ray_tpu_torch._private.ids import ActorID, ObjectID, PlacementGroupID, TaskID


class TaskKind(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


@dataclass
class SchedulingStrategy:
    """Base marker; concrete strategies below.

    Mirrors ``python/ray/util/scheduling_strategies.py``.
    """


@dataclass
class DefaultSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class SpreadSchedulingStrategy(SchedulingStrategy):
    pass


@dataclass
class NodeAffinitySchedulingStrategy(SchedulingStrategy):
    node_id: Any = None  # NodeID
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy(SchedulingStrategy):
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


def trace_id_of(spec) -> str:
    """A task's trace id: inherited from its submitter, or rooted at
    itself (single source of truth for the derivation)."""
    return spec.trace_parent[0] if spec.trace_parent \
        else spec.task_id.hex()


def trace_parent_from(parent_spec) -> tuple:
    """The submitting task's span becomes the child's parent; the trace
    id is inherited (or rooted at the submitting task)."""
    return (trace_id_of(parent_spec), parent_spec.task_id.hex())


# -- ambient trace context --------------------------------------------------
# Submissions from OUTSIDE any task (e.g. the Serve router dispatching
# an HTTP request to a replica) have no task context to inherit a trace
# from; a thread-local ambient parent bridges the gap, so an ingress
# request's trace id flows proxy → router → replica → any tasks the
# replica submits (reference: tracing_helper.py's context propagation
# through non-task callers).

_AMBIENT_TRACE = threading.local()


def set_ambient_trace_parent(tp: Optional[tuple]) -> Optional[tuple]:
    """Install (trace_id_hex, parent_span_id_hex) as this thread's
    ambient trace parent; returns the previous value for restore."""
    prev = getattr(_AMBIENT_TRACE, "tp", None)
    _AMBIENT_TRACE.tp = tp
    sanitize_hooks.ambient_set("trace_parent", tp)
    return prev


def get_ambient_trace_parent() -> Optional[tuple]:
    return getattr(_AMBIENT_TRACE, "tp", None)


# -- ambient job/tenant context ---------------------------------------------
# Multi-tenant attribution (reference: every TaskSpec carries a JobID
# assigned at driver connect, and the state API slices by it): a spec's
# job tag is inherited from the submitting TASK's spec when the
# submission happens inside a task, so one tag set at the entry point
# flows through arbitrary .remote() chains. Submissions from outside
# any task (a driver, the Serve router dispatching an HTTP request)
# read a thread-local ambient tag — same bridge as the ambient trace
# parent above — with a process-wide default taken from RAY_TPU_JOB_ID,
# the env channel job_submission uses for entrypoint subprocesses.

_AMBIENT_JOB = threading.local()
_default_job_id: "str | None" = None


def default_job_id() -> str:
    """Process-wide fallback job tag: RAY_TPU_JOB_ID when the process
    is a job entrypoint (job_submission sets it), else ""."""
    global _default_job_id
    if _default_job_id is None:
        import os

        _default_job_id = os.environ.get("RAY_TPU_JOB_ID", "")
    return _default_job_id


def set_ambient_job_id(job_id: Optional[str]) -> Optional[str]:
    """Install a job tag for submissions from this thread (None clears
    back to the process default); returns the previous value for
    restore."""
    prev = getattr(_AMBIENT_JOB, "job", None)
    _AMBIENT_JOB.job = job_id
    sanitize_hooks.ambient_set("job_id", job_id)
    return prev


def get_ambient_job_id() -> str:
    job = getattr(_AMBIENT_JOB, "job", None)
    return job if job is not None else default_job_id()


def job_id_for_submit(ctx_spec) -> str:
    """The job tag a new submission carries: the submitting task's own
    tag in-task (executor threads are pooled, so their thread-local
    ambient could belong to an unrelated job), the thread's ambient /
    process default otherwise."""
    if ctx_spec is not None:
        return ctx_spec.job_id or ""
    return get_ambient_job_id()


def check_isolate_process(value):
    """isolate_process accepts False (in-thread), True (forked worker),
    or "spawn" (fresh interpreter); anything else is a typo that would
    otherwise silently fork."""
    if value not in (False, True, "spawn"):
        raise ValueError(
            f"isolate_process must be False, True, or 'spawn', got {value!r}")
    return value


@dataclass
class TaskSpec:
    task_id: TaskID
    kind: TaskKind
    # Callable payload: for normal tasks the function; for actor creation the
    # class; for actor tasks the method name.
    func: Any
    args: tuple
    kwargs: dict
    name: str = ""
    num_returns: "int | str" = 1  # int, or "dynamic" (generator task)
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 3
    # Which attempt this dispatch is (0 = first). Node-death resubmits
    # and actor-call replays increment it and decrement max_retries —
    # the pair is the per-spec retry ledger, and both ride the wire
    # (TaskCall.attempt / full-spec shipping) so a replayed dispatch is
    # observably a replay on the receiving node too.
    attempt: int = 0
    retry_exceptions: Any = False  # False | True | list of exception types
    scheduling_strategy: SchedulingStrategy = field(
        default_factory=DefaultSchedulingStrategy
    )
    # Actor-related fields
    actor_id: Optional[ActorID] = None
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"
    max_pending_calls: int = -1
    # Ordering for actor tasks
    sequence_number: int = 0
    # Runtime env (recorded; applied by the worker pool when it launches
    # dedicated workers for the env)
    runtime_env: Optional[dict] = None
    # Execute in a separate worker process (crash isolation) instead of
    # a thread of the node process: False (in-thread), True (forked), or
    # "spawn" (fresh interpreter — for workloads needing pristine
    # process-global state). Reference: raylet worker_pool.h:156.
    isolate_process: Any = False
    # Return object IDs, precomputed by the submitter (owner)
    return_ids: list = field(default_factory=list)
    # Function-distribution cache key (reference: function_manager
    # export via GCS KV + worker import thread). When set, cluster
    # shipping may strip `func` from the wire copy after the first
    # export — nodes re-resolve it from their cache or the head's KV.
    func_id: Optional[bytes] = None
    # Depth for scheduling fairness / detection of recursive deadlock
    depth: int = 0
    # Distributed tracing: (trace_id_hex, parent_span_id_hex) propagated
    # from the submitting task (reference: tracing_helper.py span
    # context in task metadata).
    trace_parent: Optional[tuple] = None
    # Job/tenant tag: assigned at submission (job_submission entrypoint,
    # Serve ingress, or any ambient scope) and inherited down .remote()
    # chains, so every task/event/metric of one workload is attributable
    # end-to-end. "" = untagged.
    job_id: str = ""
    # Content hash of the interned SpecTemplate this spec was built
    # from, when it was (see intern_template). The cluster wire path
    # ships the template once per node and then references it by this
    # id, so a steady stream of same-shape submissions carries only
    # args + a small header.
    template_id: Optional[bytes] = None

    # Class-level defaults (NOT dataclass fields) for the scheduler's
    # per-spec bookkeeping: quota charge tokens, the sticky admission
    # flag, the submit timestamp, consumed actor restarts, and the
    # milli-demand cache. Hot paths probe these with getattr on every
    # submission/dispatch; an absent instance attribute makes getattr
    # raise-and-catch internally (~µs each), while a class attribute
    # is a plain MRO read. Writes shadow per-instance as before.
    _quota_cpu = None
    _quota_queued = None
    _quota_admitted = False
    _submit_monotonic = None
    _milli_cache = None
    _lease_reroutes = 0
    restarts_used = 0

    def assign_return_ids(self) -> list[ObjectID]:
        """Populate ``return_ids`` from ``num_returns`` and return them.

        Single source of truth for return-id semantics (Worker.submit and
        client-mode ClientWorker.submit both call this — they drifted
        once): num_returns=0 means fire-and-forget (no returns);
        "dynamic" means ONE ref whose value is an ObjectRefGenerator over
        the task's yielded outputs; actor creations always carry at least
        one status object (index 0).
        """
        n = 1 if self.num_returns == "dynamic" else self.num_returns
        if self.kind == TaskKind.ACTOR_CREATION:
            n = max(n, 1)
        self.return_ids = [
            ObjectID.for_task_return(self.task_id, i) for i in range(n)
        ]
        return self.return_ids

    def dependencies(self) -> list[ObjectID]:
        """ObjectIDs appearing at the top level of args/kwargs."""
        return top_level_dependencies(self.args, self.kwargs)

    def nested_dependencies(self, max_depth: int = 4) -> list[ObjectID]:
        """ObjectIDs reachable through standard containers in
        args/kwargs (depth-limited). Used to pin a dispatched task's arg
        objects against a racing driver release; refs buried in custom
        user objects are covered by the executing node's borrower
        registration instead."""
        return nested_dependencies_of(self.args, self.kwargs, max_depth)

    def describe(self) -> str:
        if self.kind == TaskKind.ACTOR_TASK:
            return f"{self.name} (actor={self.actor_id})"
        return f"{self.name} ({self.task_id.hex()[:8]})"


def top_level_dependencies(args, kwargs) -> list[ObjectID]:
    """ObjectIDs at the top level of an args/kwargs pair (shared by
    TaskSpec and QueuedTaskHeader — the dep-gating contract must be
    identical whichever queued form a submission takes)."""
    from ray_tpu_torch.object_ref import ObjectRef

    deps = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, ObjectRef):
            deps.append(a.id)
    return deps


def nested_dependencies_of(args, kwargs, max_depth: int = 4) \
        -> list[ObjectID]:
    """Container-walking dependency scan shared by TaskSpec and
    QueuedTaskHeader (see TaskSpec.nested_dependencies)."""
    from ray_tpu_torch.object_ref import ObjectRef

    deps: list[ObjectID] = []
    seen: set = set()

    def walk(v, depth):
        if isinstance(v, ObjectRef):
            if v.binary() not in seen:
                seen.add(v.binary())
                deps.append(v.id)
            return
        if depth <= 0:
            return
        if isinstance(v, (list, tuple, set, frozenset)):
            for item in v:
                walk(item, depth - 1)
        elif isinstance(v, dict):
            for k, item in v.items():
                walk(k, depth - 1)
                walk(item, depth - 1)

    for a in list(args) + list(kwargs.values()):
        walk(a, max_depth)
    return deps


# ---------------------------------------------------------------------------
# Spec-template interning (control-plane fast path)
# ---------------------------------------------------------------------------
#
# Every .remote() call used to rebuild the full invariant slice of its
# TaskSpec — option validation, resource normalization, strategy
# construction — and, in cluster mode, re-serialize all of it per call.
# A SpecTemplate captures that invariant slice ONCE per (callable,
# options) pair, keyed by a content hash, mirroring the reference
# core-worker's serialize-once TaskSpec handling: per-call work shrinks
# to args + a small header referencing the template by id.


@dataclass
class SpecTemplate:
    """The invariant-across-calls slice of a TaskSpec."""

    kind: TaskKind
    func: Any
    name: str
    num_returns: "int | str"
    resources: Dict[str, float]
    milli: Dict[str, int]                 # precomputed to_milli(resources)
    max_retries: int = 3
    retry_exceptions: Any = False
    scheduling_strategy: SchedulingStrategy = None
    runtime_env: Optional[dict] = None
    isolate_process: Any = False
    func_id: Optional[bytes] = None
    # Actor-creation extras (unused for NORMAL_TASK / ACTOR_TASK).
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    actor_name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None
    max_pending_calls: int = -1
    template_id: bytes = b""
    # Lazily-built invariant __dict__ slice for fast materialization
    # (see spec_proto); NOT part of template identity — excluded from
    # dataclass __eq__/__repr__ so a template that has built its proto
    # still compares equal to a content-identical fresh one, and the
    # placeholder-spec dict never rides a wire.TaskTemplate shipment
    # as dead weight.
    _spec_proto: Optional[dict] = field(
        default=None, repr=False, compare=False)

    def make_spec(self, task_id: TaskID, args: tuple, kwargs: dict,
                  depth: int = 0, trace_parent: Optional[tuple] = None,
                  actor_id: Optional[ActorID] = None,
                  sequence_number: int = 0,
                  num_returns: "int | str | None" = None,
                  job_id: str = "") -> TaskSpec:
        """Per-call spec construction: only the varying fields are new."""
        spec = TaskSpec(
            task_id=task_id,
            kind=self.kind,
            func=self.func,
            args=args,
            kwargs=kwargs,
            name=self.name,
            num_returns=self.num_returns if num_returns is None
            else num_returns,
            resources=self.resources,
            max_retries=self.max_retries,
            retry_exceptions=self.retry_exceptions,
            scheduling_strategy=self.scheduling_strategy,
            actor_id=actor_id,
            max_restarts=self.max_restarts,
            max_task_retries=self.max_task_retries,
            max_concurrency=self.max_concurrency,
            actor_name=self.actor_name,
            namespace=self.namespace,
            lifetime=self.lifetime,
            max_pending_calls=self.max_pending_calls,
            sequence_number=sequence_number,
            runtime_env=self.runtime_env,
            isolate_process=self.isolate_process,
            func_id=self.func_id,
            depth=depth,
            trace_parent=trace_parent,
            job_id=job_id,
            template_id=self.template_id,
        )
        # The scheduler's demand conversion, computed once at intern time.
        spec._milli_cache = self.milli
        return spec

    def spec_proto(self) -> dict:
        """The invariant slice of a materialized spec's ``__dict__``,
        built once per template: QueuedTaskHeader.materialize copies it
        with one C-level ``dict.update`` instead of re-running the
        25-kwarg dataclass constructor per dispatch (the constructor
        was ~40% of header+materialize cost; with the proto the compact
        path's TOTAL work is below a single make_spec). Field sharing
        (resources / scheduling_strategy / runtime_env aliased to the
        template's) is exactly make_spec's existing semantics; every
        per-call key is overwritten by the copier. Benign lazy-init
        race: two builders produce equal dicts."""
        proto = self._spec_proto
        if proto is None:
            proto = self.make_spec(TaskID(b"\0" * 16), (), {}).__dict__
            self._spec_proto = proto
        return proto

    def __getstate__(self):
        # The lazily-built proto is derived state: shipping it in a
        # wire.TaskTemplate would carry a placeholder spec __dict__ as
        # dead weight — the receiving side rebuilds on first dispatch.
        state = dict(self.__dict__)
        state["_spec_proto"] = None
        return state


class QueuedTaskHeader:
    """Compact queued form of one submission (the control-plane slice
    of the reference's lease-request header): the interned template
    reference plus only the per-call fields, in a ``__slots__`` object
    a fraction the size of a full ``TaskSpec``. Queued-but-undispatched
    work is held in this form — a million-task backlog costs header
    bytes — and :meth:`materialize` builds the full spec exactly once,
    at dispatch. Only default-strategy NORMAL_TASK submissions take
    this shape (see ``RemoteFunction.remote``); everything else still
    queues full specs, and both forms flow the same scheduler paths
    (quota admission, WFQ classing, dep parking, backlog accounting).

    Retry state (``max_retries``/``attempt``) lives on the header, not
    the template, so node-death resubmits of a leased header keep their
    own ledger; quota charge tokens ride the header and TRANSFER to the
    materialized spec (never both — a charge is released exactly once).
    """

    __slots__ = ("tpl", "task_id", "args", "kwargs", "depth",
                 "trace_parent", "job_id", "attempt", "max_retries",
                 "num_returns", "return_ids", "_milli_cache",
                 "_quota_cpu", "_quota_queued", "_quota_admitted",
                 "_submit_monotonic", "_lease_reroutes")

    def __init__(self, tpl: SpecTemplate, task_id: TaskID, args: tuple,
                 kwargs: dict, depth: int = 0,
                 trace_parent: Optional[tuple] = None,
                 job_id: str = ""):
        self.tpl = tpl
        self.task_id = task_id
        self.args = args
        self.kwargs = kwargs
        self.depth = depth
        self.trace_parent = trace_parent
        self.job_id = job_id
        self.attempt = 0
        self.max_retries = tpl.max_retries
        self.num_returns = tpl.num_returns
        self.return_ids: list = []
        self._milli_cache = tpl.milli
        # Pre-set every optional slot: getattr(h, name, default) on an
        # UNSET slot raises internally (~µs of exception machinery),
        # and the quota/WFQ hot paths probe these on every submission —
        # five stores at mint buy plain reads everywhere after.
        self._quota_cpu = None
        self._quota_queued = None
        self._quota_admitted = False
        self._submit_monotonic = None
        self._lease_reroutes = 0

    # -- template-delegated invariants (read-only views) -----------------

    @property
    def kind(self) -> TaskKind:
        return self.tpl.kind

    @property
    def resources(self) -> Dict[str, float]:
        return self.tpl.resources

    @property
    def scheduling_strategy(self):
        return self.tpl.scheduling_strategy

    @property
    def name(self) -> str:
        return self.tpl.name

    @property
    def func(self):
        return self.tpl.func

    @property
    def func_id(self) -> Optional[bytes]:
        return self.tpl.func_id

    @property
    def template_id(self) -> bytes:
        return self.tpl.template_id

    @property
    def actor_id(self):
        return None  # headers are normal tasks only

    def assign_return_ids(self) -> list[ObjectID]:
        n = 1 if self.num_returns == "dynamic" else self.num_returns
        self.return_ids = [
            ObjectID.for_task_return(self.task_id, i) for i in range(n)
        ]
        return self.return_ids

    def dependencies(self) -> list[ObjectID]:
        return top_level_dependencies(self.args, self.kwargs)

    def nested_dependencies(self, max_depth: int = 4) -> list[ObjectID]:
        return nested_dependencies_of(self.args, self.kwargs, max_depth)

    def describe(self) -> str:
        return f"{self.tpl.name} ({self.task_id.hex()[:8]})"

    def approx_nbytes(self) -> int:
        """Cheap queued-footprint estimate for the
        ``sched_queued_header_bytes`` counter (slots + id + per-arg
        slot; arg VALUES are shared with the caller, not charged)."""
        return 240 + 16 * (len(self.args) + len(self.kwargs))

    def materialize(self, transfer_tokens: bool = True) -> TaskSpec:
        """Build the full TaskSpec. At local dispatch (the default)
        quota charge tokens MOVE to the spec — release/retry paths run
        against the materialized form, exactly once. With
        ``transfer_tokens=False`` (wire copies: the head keeps the
        header in its lineage/in-flight tables) tokens stay put so the
        head-side release still finds the charge."""
        tpl = self.tpl
        proto = tpl._spec_proto
        if proto is None:
            proto = tpl.spec_proto()
        spec = TaskSpec.__new__(TaskSpec)
        d = spec.__dict__
        d.update(proto)
        d["task_id"] = self.task_id
        d["args"] = self.args
        d["kwargs"] = self.kwargs
        d["depth"] = self.depth
        d["trace_parent"] = self.trace_parent
        d["job_id"] = self.job_id
        d["num_returns"] = self.num_returns
        d["return_ids"] = self.return_ids
        d["max_retries"] = self.max_retries
        d["attempt"] = self.attempt
        if transfer_tokens:
            cpu_token = self._quota_cpu
            if cpu_token is not None:
                spec._quota_cpu = cpu_token
                self._quota_cpu = None
            queued_token = self._quota_queued
            if queued_token is not None:
                spec._quota_queued = queued_token
                self._quota_queued = None
        if self._quota_admitted:
            spec._quota_admitted = True
        submitted = self._submit_monotonic
        if submitted is not None:
            spec._submit_monotonic = submitted
        return spec


# Content hash -> template. Interning is by content, so identical
# definitions (same function bytes, same options) share one entry and a
# REdefinition (new body under an old name) can never hit a stale one —
# its func_id, and therefore its template_id, differs. Bounded LRU: a
# driver minting remote functions dynamically (each closure hashes
# differently) must not pin every captured environment forever —
# evicted entries are safe, since live handles hold their template
# strongly and the cluster wire path falls back to full-spec shipping
# on an intern miss.
_TEMPLATES: "collections.OrderedDict[bytes, SpecTemplate]" = \
    collections.OrderedDict()
_TEMPLATES_MAX = 4096
_TEMPLATES_LOCK = threading.Lock()

# Intern hit rate (a low hit rate means per-call template rebuilds are
# back on the hot path — exactly what PR 2 removed).
from ray_tpu_torch._private import perf_stats as _perf_stats  # noqa: E402

_INTERN_HITS = _perf_stats.counter("intern_hits")
_INTERN_MISSES = _perf_stats.counter("intern_misses")


def _strategy_key(strategy) -> str:
    if strategy is None:
        return "None"
    from dataclasses import fields as _fields

    parts = [type(strategy).__name__]
    for f in _fields(strategy):
        parts.append(f"{f.name}={getattr(strategy, f.name)!r}")
    return ":".join(parts)


def intern_template(*, kind: TaskKind, func: Any, name: str,
                    num_returns, resources: Dict[str, float],
                    func_id: Optional[bytes] = None,
                    **invariants) -> SpecTemplate:
    """Build (or reuse) the interned template for one callable + option
    set. The content hash covers the function identity (func_id — the
    sha1 of its cloudpickle — when exportable, else a per-object token)
    and every invariant field, so equal content dedupes and changed
    content gets a fresh id."""
    import hashlib

    from ray_tpu_torch._private.resources import to_milli

    if func_id:
        fn_key = func_id.hex()
    elif isinstance(func, str):
        fn_key = f"method:{func}"   # actor method: the name IS the content
    else:
        fn_key = f"local:{id(func)}"
    h = hashlib.sha1()
    h.update(repr((
        kind.value, fn_key, name, num_returns,
        sorted(resources.items()),
        invariants.get("max_retries", 3),
        repr(invariants.get("retry_exceptions", False)),
        _strategy_key(invariants.get("scheduling_strategy")),
        repr(invariants.get("runtime_env")),
        repr(invariants.get("isolate_process", False)),
        invariants.get("max_restarts", 0),
        invariants.get("max_task_retries", 0),
        invariants.get("max_concurrency", 1),
        invariants.get("actor_name"),
        invariants.get("namespace"),
        invariants.get("lifetime"),
        invariants.get("max_pending_calls", -1),
    )).encode())
    tid = h.digest()
    with _TEMPLATES_LOCK:
        tpl = _TEMPLATES.get(tid)
        if tpl is None:
            _INTERN_MISSES.inc()
        else:
            _INTERN_HITS.inc()
        if tpl is None or tpl.func is not func:
            # Same content but a distinct (equal-bytes) function object:
            # reuse the id, refresh the callable so local execution uses
            # the live object.
            tpl = SpecTemplate(
                kind=kind, func=func, name=name, num_returns=num_returns,
                resources=resources, milli=to_milli(resources),
                func_id=func_id, template_id=tid, **invariants)
        _TEMPLATES[tid] = tpl
        _TEMPLATES.move_to_end(tid)
        while len(_TEMPLATES) > _TEMPLATES_MAX:
            _TEMPLATES.popitem(last=False)
    return tpl


def get_template(template_id: bytes) -> Optional[SpecTemplate]:
    with _TEMPLATES_LOCK:
        tpl = _TEMPLATES.get(template_id)
        if tpl is not None:
            _TEMPLATES.move_to_end(template_id)
        return tpl


def register_template(tpl: SpecTemplate) -> None:
    """Install a template received over the wire (node side)."""
    with _TEMPLATES_LOCK:
        _TEMPLATES[tpl.template_id] = tpl
        _TEMPLATES.move_to_end(tpl.template_id)
        while len(_TEMPLATES) > _TEMPLATES_MAX:
            _TEMPLATES.popitem(last=False)


@dataclass
class Bundle:
    """One placement-group bundle: a resource request reserved on one node."""

    resources: Dict[str, float]
    node_id: Any = None  # filled at reservation time


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: list
    strategy: str = "PACK"  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    name: str = ""
    lifetime: Optional[str] = None
