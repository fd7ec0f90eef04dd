"""Actor classes and handles.

Reference: ``python/ray/actor.py`` — ``@remote`` on a class yields an
``ActorClass``; ``.remote(...)`` submits an actor-creation task and returns
an ``ActorHandle`` whose method accessors submit ordered actor tasks.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ActorID, TaskID
from ray_tpu_torch._private.resources import normalize_request
from ray_tpu_torch._private.task_spec import (check_isolate_process,
                                        get_ambient_trace_parent,
                                        intern_template,
                                        job_id_for_submit,
                                        trace_parent_from,
                                        DefaultSchedulingStrategy,
                                        TaskKind)

_ACTOR_OPTIONS = {
    "num_cpus", "num_tpus", "num_gpus", "memory", "resources", "name",
    "namespace", "lifetime", "max_restarts", "max_task_retries",
    "max_concurrency", "max_pending_calls", "scheduling_strategy",
    "runtime_env", "get_if_exists", "_metadata", "isolate_process",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use handle.{self._method_name}.remote()."
        )

    def options(self, num_returns: Optional[int] = None, name: str = "",
                **_ignored) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._method_name,
            num_returns if num_returns is not None else self._num_returns,
        )

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._method_name, args, kwargs, self._num_returns
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, cls: type, actor_name: Optional[str],
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._cls = cls
        self._actor_name = actor_name
        self._max_task_retries = max_task_retries
        self._seq_lock = threading.Lock()
        self._seq = 0
        # (method_name, num_returns) -> interned SpecTemplate: method
        # calls pay only per-call fields (args, seq, trace) after the
        # first submission through this handle.
        self._method_templates: dict = {}

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if not hasattr(self._cls, name):
            raise AttributeError(
                f"Actor class {self._cls.__name__!r} has no method {name!r}"
            )
        return ActorMethod(self, name)

    def _submit_method(self, method_name, args, kwargs, num_returns):
        w = worker_mod.global_worker()
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        key = (method_name, num_returns)
        tpl = self._method_templates.get(key)
        if tpl is None:
            tpl = intern_template(
                kind=TaskKind.ACTOR_TASK,
                func=method_name,
                name=f"{self._cls.__name__}.{method_name}",
                num_returns=num_returns,
                resources={},
                max_retries=self._max_task_retries,
            )
            self._method_templates[key] = tpl
        _ctx = w.task_context.current()
        _ctx_spec = _ctx["task_spec"] if _ctx else None
        spec = tpl.make_spec(
            TaskID.from_random(), args, kwargs,
            actor_id=self._actor_id,
            sequence_number=seq,
            trace_parent=(trace_parent_from(_ctx_spec)
                          if _ctx else get_ambient_trace_parent()),
            job_id=job_id_for_submit(_ctx_spec),
        )
        refs = w.submit(spec)
        # dynamic: the single ref resolves to an ObjectRefGenerator
        return refs[0] if num_returns in (1, "dynamic") else refs

    def __repr__(self):
        return f"ActorHandle({self._cls.__name__}, {self._actor_id.hex()[:8]})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._cls, self._actor_name, self._max_task_retries),
        )


class ActorClass:
    def __init__(self, cls: type, **default_options):
        bad = set(default_options) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"Invalid @remote options for an actor: {sorted(bad)}")
        self._cls = cls
        self._default_options = default_options
        self._template = None  # interned creation-spec slice (first .remote())
        self.__name__ = cls.__name__

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def options(self, **options) -> "ActorClass":
        bad = set(options) - _ACTOR_OPTIONS
        if bad:
            raise ValueError(f"Invalid options: {sorted(bad)}")
        return ActorClass(self._cls, **{**self._default_options, **options})

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._default_options
        w = worker_mod.global_worker()
        name = opts.get("name")
        namespace = opts.get("namespace")
        if opts.get("get_if_exists") and name:
            try:
                return w.gcs.get_named_actor(name, namespace)
            except ValueError:
                pass
        tpl = self._template
        if tpl is None:
            # Actors default to 0 CPU for lifetime (1 CPU only during
            # creation in the reference; we hold the declared request for
            # the lifetime).
            resources = normalize_request(
                num_cpus=opts.get("num_cpus"),
                num_tpus=opts.get("num_tpus"),
                num_gpus=opts.get("num_gpus"),
                memory=opts.get("memory"),
                resources=opts.get("resources"),
                default_cpus=0.0,
            )
            strategy = opts.get("scheduling_strategy") or \
                DefaultSchedulingStrategy()
            tpl = self._template = intern_template(
                kind=TaskKind.ACTOR_CREATION,
                func=self._cls,
                name=f"{self._cls.__name__}.__init__",
                num_returns=1,
                resources=resources,
                max_restarts=opts.get("max_restarts", 0),
                max_task_retries=opts.get("max_task_retries", 0),
                max_concurrency=opts.get("max_concurrency", 1),
                actor_name=name,
                namespace=namespace,
                lifetime=opts.get("lifetime"),
                max_pending_calls=opts.get("max_pending_calls", -1),
                scheduling_strategy=strategy,
                runtime_env=opts.get("runtime_env"),
                isolate_process=check_isolate_process(
                    opts.get("isolate_process", False)),
            )
        actor_id = ActorID.from_random()
        _ctx = w.task_context.current()
        _ctx_spec = _ctx["task_spec"] if _ctx else None
        spec = tpl.make_spec(
            TaskID.from_random(), args, kwargs,
            actor_id=actor_id,
            trace_parent=(trace_parent_from(_ctx_spec)
                          if _ctx else get_ambient_trace_parent()),
            job_id=job_id_for_submit(_ctx_spec),
        )
        handle = ActorHandle(
            actor_id, self._cls, name, opts.get("max_task_retries", 0)
        )
        if name:
            w.gcs.register_named_actor(name, namespace, handle)
        w.submit(spec)
        return handle


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor (reference: ``ray.get_actor``)."""
    return worker_mod.global_worker().gcs.get_named_actor(name, namespace)
