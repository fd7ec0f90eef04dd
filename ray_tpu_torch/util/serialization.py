"""Custom serializer registry.

Reference: `ray.util.register_serializer` /
`_private/serialization.py` SerializationContext custom-type hooks — a
process-wide mapping from a class to (serializer, deserializer) used
whenever that class crosses a process boundary (task args, returns,
puts). Implemented over `copyreg` dispatch, which both pickle and
cloudpickle honour, so every wire path (typed-wire Opaque sections, shm
plane, specs) picks it up with no per-path plumbing.
"""

from __future__ import annotations

import copyreg
from typing import Any, Callable, Dict, Tuple

_REGISTRY: Dict[type, Tuple[Callable, Callable]] = {}


def _reconstruct(cls: type, serializer: Callable, deserializer: Callable,
                 payload: Any):
    # Self-propagating: deserializing an instance in another process
    # (cluster node, spawned worker) installs the serializer THERE too,
    # so that process can send instances onward / back. A process that
    # creates instances without ever receiving one must call
    # register_serializer itself (e.g. at module import in the task's
    # code), same as the reference.
    if cls not in _REGISTRY:
        register_serializer(cls, serializer=serializer,
                            deserializer=deserializer)
    return deserializer(payload)


def register_serializer(cls: type, *, serializer: Callable[[Any], Any],
                        deserializer: Callable[[Any], Any]) -> None:
    """Serialize instances of `cls` as `serializer(obj)` (any picklable
    payload); reconstruct with `deserializer(payload)`."""
    if not isinstance(cls, type):
        raise TypeError(f"cls must be a class, got {cls!r}")

    def reduce_fn(obj):
        return (_reconstruct,
                (cls, serializer, deserializer, serializer(obj)))

    _REGISTRY[cls] = (serializer, deserializer)
    copyreg.pickle(cls, reduce_fn)


def deregister_serializer(cls: type) -> None:
    _REGISTRY.pop(cls, None)
    copyreg.dispatch_table.pop(cls, None)
