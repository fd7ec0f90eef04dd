"""Small MLP classifier: the fashion-MNIST baseline workload.

Counterpart of ``ray_tpu/models/mlp.py``. Parameters are a list of
``{"w": [d_in, d_out], "b": [d_out]}`` dicts, the JAX package's layout,
so :func:`mlp_params_from_jax` converts array types and nothing else.
No kernel: the layers are plain matrix products, as XLA runs them there.

:func:`mlp_init` and :func:`mlp_params_from_jax` run on ``cuda`` unless
the caller passes ``device="cpu"``; with no GPU they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import _to_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Tuple[int, ...] = (128, 128)
    n_classes: int = 10
    dtype: Any = torch.float32

    def dims(self) -> Tuple[int, ...]:
        return (self.in_dim,) + tuple(self.hidden) + (self.n_classes,)


def mlp_init(cfg: MLPConfig, generator: torch.Generator,
             device=None) -> List[Dict[str, torch.Tensor]]:
    """Weights as the JAX ``mlp_init`` draws them: ``normal * d_in**-0.5``
    and zero biases. Draws on the generator's device, then moves to
    ``device`` in ``cfg.dtype``."""
    device = resolve_device(device)
    dims = cfg.dims()
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32, device=generator.device)
        params.append({
            "w": (w * d_in ** -0.5).to(device=device, dtype=cfg.dtype),
            "b": torch.zeros(d_out, dtype=cfg.dtype, device=device)})
    return params


def mlp_params_from_jax(np_params, cfg: MLPConfig,
                        device=None) -> List[Dict[str, torch.Tensor]]:
    """Carry the JAX package's MLP parameters (a list of ``{"w", "b"}``
    with numpy leaves) into the port, ``cfg.dtype`` on ``device``. Raises
    on a layer count or shape that ``cfg`` does not give."""
    device = resolve_device(device)
    dims = cfg.dims()
    if len(np_params) != len(dims) - 1:
        raise ValueError(f"mlp_params_from_jax: {len(np_params)} layers, "
                         f"config gives {len(dims) - 1}")
    out = []
    for i, (layer, d_in, d_out) in enumerate(zip(np_params, dims[:-1],
                                                 dims[1:])):
        converted = {}
        for name, shape in (("w", (d_in, d_out)), ("b", (d_out,))):
            arr = np.asarray(layer[name])
            if tuple(arr.shape) != shape:
                raise ValueError(f"mlp_params_from_jax: layer {i} {name} "
                                 f"has shape {arr.shape}, config gives "
                                 f"{shape}")
            converted[name] = _to_tensor(arr, cfg.dtype, device)
        out.append(converted)
    return out


def mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def mlp_loss(params, batch: Dict[str, torch.Tensor]):
    """batch: ``{"x": [N, in_dim], "y": [N] int}``. Returns ``(mean
    loss, {"loss", "accuracy"})``, as the JAX ``mlp_loss``."""
    logits = mlp_forward(params, batch["x"])
    labels = batch["y"].long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(logits.dtype).mean()
    return loss, {"loss": loss, "accuracy": acc}
