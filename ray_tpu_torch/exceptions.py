"""Exception types surfaced by the public API.

Parallels ``python/ray/exceptions.py`` in the reference: user-code failures
are captured where they happen, stored as the value of the task's return
objects, and re-raised at every ``get`` with the remote traceback attached.
"""

from __future__ import annotations

import traceback as _traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task application raised an exception.

    The remote traceback is captured as text and appended to the message so
    it survives serialization across process boundaries (reference:
    ``RayTaskError`` in ``python/ray/exceptions.py``).
    """

    def __init__(self, cause: BaseException, task_desc: str = "",
                 remote_traceback: str | None = None):
        self.cause = cause
        self.task_desc = task_desc
        if remote_traceback is None:
            remote_traceback = "".join(
                _traceback.format_exception(type(cause), cause, cause.__traceback__)
            )
        self.remote_traceback = remote_traceback
        super().__init__(
            f"task {task_desc} failed: {type(cause).__name__}: {cause}\n"
            f"--- remote traceback ---\n{remote_traceback}"
        )

    def __reduce__(self):
        # Default exception pickling reconstructs from self.args (the
        # formatted message), which would arrive as a str `cause`.
        return (TaskError,
                (self.cause, self.task_desc, self.remote_traceback))

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is an instance of the cause's class.

        Lets ``except UserError`` work at the ``get`` site while preserving
        the remote traceback, like the reference's dual-inheritance trick.
        """
        cause_cls = type(self.cause)
        if cause_cls is TaskError:
            return self
        try:
            class _Wrapped(TaskError, cause_cls):  # type: ignore[misc, valid-type]
                def __init__(self, te: TaskError):
                    TaskError.__init__(
                        self, te.cause, te.task_desc, te.remote_traceback
                    )

                def __reduce__(self):
                    # The dynamic dual-inheritance class doesn't survive
                    # pickling as-is (exceptions reconstruct from
                    # self.args — the message string). Rebuild from a
                    # plain TaskError and re-wrap on the other side.
                    return (_rebuild_wrapped_task_error,
                            (TaskError(self.cause, self.task_desc,
                                       self.remote_traceback),))

            _Wrapped.__name__ = f"TaskError({cause_cls.__name__})"
            _Wrapped.__qualname__ = _Wrapped.__name__
            return _Wrapped(self)
        except TypeError:
            return self


def _rebuild_wrapped_task_error(te: "TaskError") -> BaseException:
    return te.as_instanceof_cause()


class ActorError(RayTpuError):
    """An actor task cannot run because the actor is dead or unreachable."""


class ActorDiedError(ActorError):
    def __init__(self, actor_desc: str = "", cause: str = ""):
        super().__init__(f"actor {actor_desc} died: {cause}")
        self.actor_desc = actor_desc


class ActorUnavailableError(ActorError):
    """Actor temporarily unreachable (restarting)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ObjectLostError(RayTpuError):
    """Object's value was lost (evicted / node died) and cannot be recovered."""

    def __init__(self, object_id_hex: str = "", msg: str = ""):
        super().__init__(msg or f"object {object_id_hex} was lost")
        self.object_id_hex = object_id_hex


class OwnerDiedError(ObjectLostError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` did not complete within the requested timeout."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_desc: str = ""):
        super().__init__(f"task {task_desc} was cancelled")


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class JobQuotaExceededError(RayTpuError):
    """The submitting job is over a configured tenancy quota (the
    queued-task ceiling): the submission was rejected at admission,
    before consuming any cluster capacity. The message names the job,
    the exhausted quota, and the config knob (``job_quotas``)."""

    def __init__(self, job_id: str = "", msg: str = ""):
        super().__init__(msg or f"job {job_id!r} exceeded its quota")
        self.job_id = job_id
