"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

The package mirrors ``ray_tpu``'s layout (``ops/``, ``models/``,
``serve/``, ``_private/``) so each module's counterpart is easy to find.
Plain tensor code is PyTorch; every TPU (Pallas) kernel on a ported path
is a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at first use
(:mod:`ray_tpu_torch._build`) and called through ``ctypes``.

The core API is ``ray_tpu``'s, on a copy of its in-process runtime
(``_private/worker.py``, ``_private/local_backend.py``): ``init``,
``remote``, ``get``, ``put``, ``wait``, actors, ``kill``, ``cancel``.
``init`` counts the CUDA devices as the ``"GPU"`` resource; ``timeline``
waits for the observability plane. Serve
(``ray_tpu_torch.serve``) stands on it. Importing the package starts no
thread and builds no kernel: ``init`` starts the runtime, and a kernel is
built at its first launch.
"""

__version__ = "0.1.0"

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.worker import (  # noqa: F401
    cancel,
    get,
    init,
    is_initialized,
    kill,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor  # noqa: F401
from ray_tpu_torch.object_ref import (  # noqa: F401
    ObjectRef,
    ObjectRefGenerator,
)
from ray_tpu_torch.remote_function import RemoteFunction, remote  # noqa: F401
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401


def enable_client_server(*args, **kwargs):
    raise NotImplementedError(
        "client mode (enable_client_server) is not ported (ROADMAP Queue 1: "
        "client mode)")


def nodes():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs.nodes()


def cluster_resources():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs.cluster_resources()


def available_resources():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().gcs.available_resources()


__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "enable_client_server",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "wait",
]
