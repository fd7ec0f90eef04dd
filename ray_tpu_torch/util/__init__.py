from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    DefaultSchedulingStrategy,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SchedulingStrategy,
    SpreadSchedulingStrategy,
)
from ray_tpu_torch.util.serialization import (  # noqa: F401
    deregister_serializer,
    register_serializer,
)
