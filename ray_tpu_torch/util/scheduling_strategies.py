"""Public scheduling strategies (reference: ``python/ray/util/scheduling_strategies.py``)."""

from ray_tpu_torch._private.task_spec import (  # noqa: F401
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    SpreadSchedulingStrategy,
)

__all__ = [
    "SchedulingStrategy",
    "DefaultSchedulingStrategy",
    "SpreadSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
