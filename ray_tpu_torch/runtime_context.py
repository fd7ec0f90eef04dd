"""Runtime context introspection (reference: ``python/ray/runtime_context.py``)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.task_spec import TaskKind


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    @property
    def job_id(self):
        return self._worker.job_id

    @property
    def node_id(self):
        ctx = self._worker.task_context.current()
        if ctx is not None and "node_id" in ctx:
            return ctx["node_id"]
        return self._worker.backend.node_id

    @property
    def namespace(self) -> str:
        return self._worker.namespace

    def get_job_id(self) -> str:
        return self._worker.job_id.hex()

    def get_node_id(self) -> str:
        return self.node_id.hex()

    def get_task_id(self) -> Optional[str]:
        ctx = self._worker.task_context.current()
        return ctx["task_spec"].task_id.hex() if ctx else None

    def get_actor_id(self) -> Optional[str]:
        ctx = self._worker.task_context.current()
        if ctx and ctx["task_spec"].kind == TaskKind.ACTOR_TASK:
            return ctx["task_spec"].actor_id.hex()
        return None

    def get_worker_id(self) -> str:
        return self._worker.worker_id.hex()

    def get_assigned_resources(self) -> dict:
        ctx = self._worker.task_context.current()
        return dict(ctx["task_spec"].resources) if ctx else {}

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_placement_group_id(self) -> Optional[str]:
        ctx = self._worker.task_context.current()
        if ctx is None:
            return None
        strat = ctx["task_spec"].scheduling_strategy
        pg = getattr(strat, "placement_group", None)
        return pg.id.hex() if pg is not None else None


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(worker_mod.global_worker())
