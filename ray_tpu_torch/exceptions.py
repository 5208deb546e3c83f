"""User-facing exception types.

Parity with the reference's `python/ray/exceptions.py`: task errors wrap the
remote traceback, actor errors and death causes, object loss/owner-death errors.
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class RayTaskError(RayTpuError):
    """A task raised an exception; re-raised on `get` with the remote traceback."""

    def __init__(self, function_name: str, traceback_str: str, cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"Task {function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        # Always pickle as the base class; the dynamic dual-inheritance class
        # from as_instanceof_cause() is rebuilt on the receiving side.
        return (_rebuild_task_error, (self.function_name, self.traceback_str, self.cause))

    def as_instanceof_cause(self):
        """Return an exception that is both a RayTaskError and the cause's type,
        so `except UserError` works across the task boundary."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if cause_cls is RayTaskError or not issubclass(cause_cls, Exception):
            return self
        name = f"RayTaskError({cause_cls.__name__})"
        cls = type(name, (RayTaskError, cause_cls), {})
        err = cls.__new__(cls)
        # Initialize fields directly: RayTaskError.__init__'s super() call
        # would resolve through the dual class's MRO into the CAUSE's
        # __init__ (e.g. RayActorError swallowing the message as actor_id),
        # replacing the remote traceback with the cause's default text.
        err.function_name = self.function_name
        err.traceback_str = self.traceback_str
        err.cause = self.cause
        Exception.__init__(
            err, f"Task {self.function_name} failed:\n{self.traceback_str}")
        return err


def _rebuild_task_error(function_name, traceback_str, cause):
    return RayTaskError(function_name, traceback_str, cause)


class RayActorError(RayTpuError):
    """The actor died before or during method execution."""

    def __init__(self, actor_id=None, message: str = "The actor died unexpectedly."):
        self.actor_id = actor_id
        self._message = message
        super().__init__(message)

    def __reduce__(self):
        # Default Exception pickling would pass args[0] (the message) as
        # actor_id on rebuild, silently resetting the message to the
        # default — keep both fields explicit.
        return (type(self), (self.actor_id, self._message))


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unreachable (restarting or network partition)."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled.")


class ObjectLostError(RayTpuError):
    """The object's value was lost from the store and could not be reconstructed."""

    def __init__(self, object_id=None, message: str | None = None):
        self.object_id = object_id
        super().__init__(message or f"Object {object_id} was lost.")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    """The worker that owned this object died, so the value is unrecoverable."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died (OOM kill, segfault, ...)."""


class OutOfMemoryError(WorkerCrashedError):
    pass


class NodeDiedError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class RaySystemError(RayTpuError):
    """Internal framework failure (control plane / store)."""


class CollectiveError(RayTpuError):
    """A host-collective operation aborted.

    Raised on every surviving rank when a group member dies mid-operation
    (``dead_ranks`` maps rank -> reason), when the group was destroyed
    under the caller, or when an operation stalls past
    ``collective_stall_timeout_s`` with no progress.
    """

    def __init__(self, message: str, dead_ranks=None, group_name=None):
        self.dead_ranks = dict(dead_ranks or {})
        self.group_name = group_name
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0], self.dead_ranks, self.group_name))
