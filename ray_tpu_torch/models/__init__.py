"""Models in PyTorch. Counterpart of ``ray_tpu.models``; so far the
Llama-3 family's inference path (``llama``)."""

from ray_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    forward,
    forward_hidden,
    forward_with_cache,
    init_kv_cache,
    init_params,
    params_from_jax,
)
