"""Models in PyTorch. Counterpart of ``ray_tpu.models``: the Llama-3
family (``llama``: inference, the KV-cache path, the loss and remat), its
Mixture-of-Experts variant (``moe``), HF checkpoint loading (``hf``), the
MLP baseline (``mlp``), the train step (``training``) and the memory
plan (``memory_plan``)."""

from ray_tpu_torch.models.hf import (  # noqa: F401
    config_from_hf,
    load_llama_from_hf,
    params_from_hf_state_dict,
)
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
from ray_tpu_torch.models.mlp import (  # noqa: F401
    MLPConfig,
    mlp_forward,
    mlp_init,
    mlp_loss,
    mlp_params_from_jax,
)
from ray_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_forward,
    moe_loss_fn,
    moe_param_shapes,
    moe_params_from_jax,
)
from ray_tpu_torch.models.training import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
