"""``@remote`` functions.

Reference: ``python/ray/remote_function.py`` — a decorated function becomes a
handle whose ``.remote(...)`` submits a TaskSpec and returns ObjectRef(s);
``.options(...)`` overrides per-call options.
"""

from __future__ import annotations

import functools

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import ray_config
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.resources import normalize_request
from ray_tpu_torch._private.task_spec import (
    check_isolate_process,
    get_ambient_trace_parent,
    intern_template,
    job_id_for_submit,
    trace_parent_from,
    DefaultSchedulingStrategy,
    QueuedTaskHeader,
    SchedulingStrategy,
    TaskKind,
)

_TASK_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "memory", "resources", "num_returns",
    "max_retries", "retry_exceptions", "name", "scheduling_strategy",
    "runtime_env", "_metadata", "isolate_process",
}


# fid -> the exact cloudpickle whose sha1 is the fid (the function-
# distribution cache's export source; one entry per unique definition).
_EXPORT_BLOBS: dict = {}  # raylint: disable=R7 -- the function-cache export source: one entry per unique function DEFINITION (sha1-keyed), and a late-joining node may fetch any still-referenced fid at any time, so eviction here would break cluster-wide function resolution; bounded by the program's distinct remote definitions


def get_export_blob(fid: bytes):
    return _EXPORT_BLOBS.get(fid)


class RemoteFunction:
    def __init__(self, func, **default_options):
        bad = set(default_options) - _TASK_OPTIONS
        if bad:
            raise ValueError(f"Invalid @remote options for a function: {sorted(bad)}")
        self._function = func
        self._default_options = default_options
        # Export-cache identity, computed lazily at first .remote():
        # hash of the cloudpickled definition. NB this freezes the
        # function's captured state at first submission (the reference's
        # one-time function export does the same); module-level
        # functions are unaffected (pickled by reference).
        self._func_id: bytes | None = None
        # Interned invariant spec slice, built at first .remote():
        # subsequent submits pay only per-call fields (task id, args,
        # trace context) — the serialize-once TaskSpec idea of the
        # reference core worker, applied in-process.
        self._template = None
        functools.update_wrapper(self, func)

    def _export_id(self):
        if self._func_id is None:
            import hashlib

            import cloudpickle

            try:
                blob = cloudpickle.dumps(self._function)
            except Exception:
                # Unpicklable closure (lock, socket, ...): fine in
                # local mode where the function is called in-process —
                # no export id, everything ships/runs inline as before.
                self._func_id = False
                return None
            self._func_id = hashlib.sha1(blob).digest()
            # The blob whose hash IS the id is what any export must
            # store — re-pickling later could capture mutated closure
            # state under the same id (divergent versions per node).
            _EXPORT_BLOBS[self._func_id] = blob
        return self._func_id or None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._function.__name__!r} cannot be called "
            f"directly; use {self._function.__name__}.remote()."
        )

    def options(self, **options) -> "RemoteFunction":
        bad = set(options) - _TASK_OPTIONS
        if bad:
            raise ValueError(f"Invalid options: {sorted(bad)}")
        merged = {**self._default_options, **options}
        rf = RemoteFunction(self._function, **merged)
        rf._func_id = self._func_id  # same definition: share the export
        return rf

    def _build_template(self):
        opts = self._default_options
        resources = normalize_request(
            num_cpus=opts.get("num_cpus"),
            num_tpus=opts.get("num_tpus"),
            num_gpus=opts.get("num_gpus"),
            memory=opts.get("memory"),
            resources=opts.get("resources"),
            default_cpus=1.0,
        )
        strategy = opts.get("scheduling_strategy") or DefaultSchedulingStrategy()
        if not isinstance(strategy, SchedulingStrategy):
            raise TypeError(
                f"scheduling_strategy must be a SchedulingStrategy, got {strategy!r}"
            )
        return intern_template(
            kind=TaskKind.NORMAL_TASK,
            func=self._function,
            name=opts.get("name") or self._function.__qualname__,
            num_returns=opts.get("num_returns", 1),
            resources=resources,
            max_retries=opts.get("max_retries", 3),
            retry_exceptions=opts.get("retry_exceptions", False),
            scheduling_strategy=strategy,
            runtime_env=opts.get("runtime_env"),
            isolate_process=check_isolate_process(opts.get("isolate_process", False)),
            func_id=self._export_id(),
        )

    def remote(self, *args, **kwargs):
        w = worker_mod.global_worker()
        tpl = self._template
        if tpl is None:
            tpl = self._template = self._build_template()
        ctx = w.task_context.current()
        ctx_spec = ctx["task_spec"] if ctx else None
        use_header = ray_config.sched_compact_queue and \
            type(tpl.scheduling_strategy) is \
            DefaultSchedulingStrategy and \
            getattr(w, "supports_compact_submit", False)
        if use_header:
            # Compact queued representation: submit a header (template
            # reference + per-call fields) instead of a full TaskSpec —
            # the scheduler materializes the spec only at dispatch, so
            # a deep backlog holds header bytes, not spec bytes. Minting
            # a header plus the proto-based materialization is CHEAPER
            # than one make_spec (perf_bench --ab-sched), so immediate
            # dispatches take this path too.
            spec = QueuedTaskHeader(
                tpl, TaskID.from_random(), args, kwargs,
                depth=(ctx_spec.depth + 1) if ctx else 0,
                trace_parent=(trace_parent_from(ctx_spec)
                              if ctx else get_ambient_trace_parent()),
                job_id=job_id_for_submit(ctx_spec),
            )
        else:
            spec = tpl.make_spec(
                TaskID.from_random(), args, kwargs,
                depth=(ctx_spec.depth + 1) if ctx else 0,
                trace_parent=(trace_parent_from(ctx_spec)
                              if ctx else get_ambient_trace_parent()),
                job_id=job_id_for_submit(ctx_spec),
            )
        refs = w.submit(spec)
        num_returns = tpl.num_returns
        if num_returns == 0:
            return None
        if num_returns == 1 or num_returns == "dynamic":
            return refs[0]  # dynamic: the ObjectRefGenerator's ref
        return refs


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(**options)`` decorator for functions and classes.

    Reference: ``ray.remote`` (``python/ray/_private/worker.py:2871``).
    """
    from ray_tpu_torch.actor import ActorClass

    def _make(obj, options):
        if isinstance(obj, type):
            return ActorClass(obj, **options)
        if callable(obj):
            return RemoteFunction(obj, **options)
        raise TypeError(f"@remote requires a function or class, got {type(obj)}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return _make(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def decorator(obj):
        return _make(obj, kwargs)

    return decorator
