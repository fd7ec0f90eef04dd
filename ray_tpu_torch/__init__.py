"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for an NVIDIA H100.

The package mirrors ``ray_tpu``'s layout (``ops/``, ``models/``,
``serve/``) so each module's counterpart is easy to find. Plain tensor
code is PyTorch; every TPU (Pallas) kernel on a ported path is a CUDA C++
kernel under ``csrc/``, built with ``nvcc`` at first use
(:mod:`ray_tpu_torch._build`) and called through ``ctypes``.

Importing the package starts nothing and builds nothing: submodules are
imported explicitly (``from ray_tpu_torch.serve.llm import LLMEngine``).
"""
