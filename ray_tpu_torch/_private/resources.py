"""Resource bookkeeping for scheduling.

Role-equivalent to the reference's ``ClusterResourceManager`` /
``LocalResourceManager`` fixed-point resource accounting
(``src/ray/raylet/scheduling/cluster_resource_data.h``). Quantities are kept
as integer milli-units (1 CPU == 1000) to avoid float drift, mirroring the
reference's FixedPoint. TPU chips are a first-class resource (``TPU``), and
nodes may carry ICI topology labels (e.g. ``ici_slice="v5e-64/0"``) used by
placement groups to demand contiguous slices.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

MILLI = 1000

# Canonical resource names.
CPU = "CPU"
TPU = "TPU"
GPU = "GPU"  # accepted for API compatibility; maps onto accelerators
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


def to_milli(resources: Dict[str, float]) -> Dict[str, int]:
    out = {}
    for name, qty in resources.items():
        if qty < 0:
            raise ValueError(f"resource {name} quantity must be >= 0, got {qty}")
        m = round(qty * MILLI)
        if m == 0 and qty > 0:
            raise ValueError(f"resource {name} quantity {qty} too small (<0.001)")
        out[name] = m
    return out


def spec_milli(spec) -> Dict[str, int]:
    """Template-cached milli-demand of a spec or queued header. Cached
    per spec: the conversion runs at least three times per task
    (pending add/remove + dispatch) plus the head's reservation and
    backlog accounting otherwise."""
    m = getattr(spec, "_milli_cache", None)
    if m is None:
        m = to_milli(spec.resources)
        try:
            spec._milli_cache = m
        except Exception:
            pass
    return m


def from_milli(resources: Dict[str, int]) -> Dict[str, float]:
    return {k: v / MILLI for k, v in resources.items()}


class ResourceSet:
    """Total/available resource quantities for one node, with blocking acquire."""

    def __init__(self, total: Dict[str, float]):
        self._total = to_milli(total)
        self._available = dict(self._total)
        self._cond = threading.Condition()

    @property
    def total(self) -> Dict[str, float]:
        return from_milli(self._total)

    @property
    def available(self) -> Dict[str, float]:
        with self._cond:
            return from_milli(self._available)

    def can_fit_total(self, request: Dict[str, int]) -> bool:
        """Feasibility: could this node ever satisfy the request?"""
        return all(self._total.get(k, 0) >= v for k, v in request.items())

    def try_acquire(self, request: Dict[str, int]) -> bool:
        with self._cond:
            if all(self._available.get(k, 0) >= v for k, v in request.items()):
                for k, v in request.items():
                    self._available[k] = self._available.get(k, 0) - v
                return True
            return False

    def release(self, request: Dict[str, int]) -> None:
        with self._cond:
            for k, v in request.items():
                self._available[k] = min(
                    self._available.get(k, 0) + v, self._total.get(k, v)
                )
            self._cond.notify_all()

    def add_capacity(self, extra: Dict[str, int]) -> None:
        """Grow the node (used by placement-group bundle reservation)."""
        with self._cond:
            for k, v in extra.items():
                self._total[k] = self._total.get(k, 0) + v
                self._available[k] = self._available.get(k, 0) + v
            self._cond.notify_all()

    def remove_capacity(self, extra: Dict[str, int]) -> None:
        with self._cond:
            for k, v in extra.items():
                self._total[k] = max(0, self._total.get(k, 0) - v)
                self._available[k] = max(0, self._available.get(k, 0) - v)

    def wait_for_change(self, timeout: Optional[float] = None) -> None:
        with self._cond:
            self._cond.wait(timeout)

    def utilization(self) -> float:
        """Fraction of (declared) resources in use; scheduling score input."""
        with self._cond:
            fracs = [
                1.0 - self._available.get(k, 0) / t
                for k, t in self._total.items()
                if t > 0
            ]
        return max(fracs) if fracs else 0.0


def normalize_request(
    num_cpus: Optional[float] = None,
    num_tpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    default_cpus: float = 1.0,
) -> Dict[str, float]:
    """Build the canonical resource request for a task/actor.

    Mirrors the defaulting rules of ``@ray.remote`` option validation
    (reference ``python/ray/_private/ray_option_utils.py``): tasks default to
    1 CPU; explicit zeros are allowed (actors default to 0 CPU at the call
    site by passing default_cpus=0).
    """
    request: Dict[str, float] = {}
    for label, v in (("num_cpus", num_cpus), ("num_tpus", num_tpus),
                     ("num_gpus", num_gpus), ("memory", memory)):
        if v is not None and v < 0:
            raise ValueError(f"{label} must be >= 0, got {v}")
    for name, qty in (resources or {}).items():
        if qty < 0:
            raise ValueError(f"resources[{name!r}] must be >= 0, got {qty}")
    request[CPU] = default_cpus if num_cpus is None else float(num_cpus)
    if num_tpus:
        request[TPU] = float(num_tpus)
    if num_gpus:
        request[GPU] = float(num_gpus)
    if memory:
        request[MEMORY] = float(memory)
    for name, qty in (resources or {}).items():
        if name in (CPU, TPU, GPU):
            raise ValueError(
                f"Use num_cpus/num_tpus/num_gpus instead of resources[{name!r}]"
            )
        request[name] = float(qty)
    return {k: v for k, v in request.items() if v != 0 or k == CPU}
