"""Serving on PyTorch/CUDA. Counterpart of ``ray_tpu.serve``; so far the
LLM engine and its deployment wrapper (``llm``). The serve runtime
(proxy, router, controller) is not ported yet."""

from ray_tpu_torch.serve.llm import (  # noqa: F401
    LLMDeployment,
    LLMEngine,
    PromptTooLongError,
    SamplingParams,
    UnknownModelError,
)
