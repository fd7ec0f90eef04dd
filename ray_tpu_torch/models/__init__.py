"""Models in PyTorch. Counterpart of ``ray_tpu.models``: the Llama-3
family (``llama``: inference, the KV-cache path, the loss and remat), the
train step (``training``) and the memory plan (``memory_plan``)."""

from ray_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    forward,
    forward_hidden,
    forward_with_cache,
    init_kv_cache,
    init_params,
    loss_fn,
    params_from_jax,
)
from ray_tpu_torch.models.memory_plan import plan_llama  # noqa: F401
from ray_tpu_torch.models.training import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
