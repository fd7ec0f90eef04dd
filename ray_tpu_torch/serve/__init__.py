"""Serving on PyTorch/CUDA. Counterpart of ``ray_tpu.serve``; so far the
LLM engine with its prefix/KV cache, and its multi-model deployment
wrapper (``llm``). The serve runtime (proxy, router, controller) is not
ported yet."""

from ray_tpu_torch.serve.llm import (  # noqa: F401
    LLMDeployment,
    LLMEngine,
    ModelSwapDeadlineError,
    PromptTooLongError,
    SamplingParams,
    UnknownModelError,
)
