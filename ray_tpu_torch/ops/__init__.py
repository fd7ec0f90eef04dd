"""Hot ops: CUDA kernels for Hopper with plain PyTorch versions beside them.

Counterpart of ``ray_tpu.ops``. Each kernel's wrapper launches the kernel
for CUDA tensors and runs its plain version for CPU tensors:

- ``attention`` — flash attention forward (``csrc/flash_fwd.cu``)
- ``norms``     — RMSNorm (``csrc/rms_norm.cu``), LayerNorm
- ``rope``      — rotary position embeddings
"""

from ray_tpu_torch.ops.attention import (  # noqa: F401
    attention_reference,
    cached_attention_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from ray_tpu_torch.ops.norms import (  # noqa: F401
    layer_norm,
    rms_norm,
    rms_norm_reference,
)
from ray_tpu_torch.ops.rope import (  # noqa: F401
    apply_rope,
    rope_frequencies,
    rope_from_positions,
)
