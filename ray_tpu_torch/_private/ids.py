"""Unique identifiers for tasks, actors, objects, nodes, jobs and placement groups.

Mirrors the role of the reference's ID layer (``src/ray/common/id.h``): every
entity in the system is addressed by a fixed-size binary ID. Like the
reference, an ObjectID embeds provenance (the task that created it plus a
return/put index) so ownership and lineage can be derived from the ID itself.
The representation here is deliberately simpler: flat 16/8-byte random IDs
with a structured ObjectID, rather than the reference's nested Job/Actor/Task
bit-packing.
"""

from __future__ import annotations

import os
import threading

_UNIQUE_SIZE = 16


class _RandomPool:
    """Batched entropy: one os.urandom syscall per 4096 ids instead of
    one per id (id generation showed up in the submit-path profile at
    fan-out rates; the reference generates ids from a per-process PRNG
    for the same reason)."""

    __slots__ = ("_buf", "_pos", "_lock")
    _CHUNK = 4096 * _UNIQUE_SIZE

    def __init__(self):
        self._buf = b""
        self._pos = 0
        self._lock = threading.Lock()

    def take(self, n: int) -> bytes:
        with self._lock:
            if self._pos + n > len(self._buf):
                self._buf = os.urandom(self._CHUNK)
                self._pos = 0
            out = self._buf[self._pos:self._pos + n]
            self._pos += n
            return out


_random_pool = _RandomPool()


class BaseID:
    """A fixed-size immutable binary identifier."""

    __slots__ = ("_binary", "_hash")
    SIZE = _UNIQUE_SIZE

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {binary!r}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_random_pool.take(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other) -> bool:
        return self._binary < other._binary

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = 4


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class ObjectID(BaseID):
    """TaskID (16B) + 4-byte big-endian index.

    Index 0..2**31 are task returns; indices with the top bit set are
    ``put`` objects, mirroring the provenance encoding of the reference's
    ObjectID (owner task + index) without its bit-level layout.
    """

    SIZE = _UNIQUE_SIZE + 4
    _PUT_BIT = 1 << 31

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(task_id.binary() + (cls._PUT_BIT | put_index).to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:_UNIQUE_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._binary[_UNIQUE_SIZE:], "big") & ~self._PUT_BIT

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._binary[_UNIQUE_SIZE:], "big") & self._PUT_BIT)


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
