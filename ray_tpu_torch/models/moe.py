"""Mixture-of-Experts Llama variant in PyTorch.

Counterpart of ``ray_tpu/models/moe.py`` on one device (expert
parallelism over a mesh waits for ``parallel/``). Routing is top-k
softmax gating with a load-balancing auxiliary loss (Switch-Transformer
style). Dispatch is the JAX package's dense-masked formulation: every
expert runs over every token and the gates zero the contributions of
the experts not selected, E/k times the FFN work of a sparse dispatch.
The expert products are plain large matrix products, as XLA runs them
there; attention and the norms go through the port's kernels on CUDA
tensors, as in :mod:`llama`, whose pieces this module reuses.

Parameters follow :func:`llama.param_shapes` with the dense FFN replaced
by a router and per-expert weights: ``router [L, d, E]``,
``we1``/``we3 [L, E, d, F]``, ``we2 [L, E, F, d]``.
:func:`init_moe_params` and :func:`moe_params_from_jax` run on ``cuda``
unless the caller passes ``device="cpu"``; with no GPU they raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.llama import (LlamaConfig, _attention_fn,
                                        _layers, _out_weight, _qkv,
                                        _requires_grad, _rope_table,
                                        param_shapes, resolve_device,
                                        tree_from_jax)
from ray_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_from_positions


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    n_experts_per_token: int = 2
    aux_loss_coeff: float = 0.01

    @staticmethod
    def debug_moe() -> "MoEConfig":
        return MoEConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                         dtype=torch.float32, remat=False, n_experts=4,
                         n_experts_per_token=2)

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig(vocab_size=32000, dim=4096, n_layers=32,
                         n_heads=32, n_kv_heads=8, hidden_dim=14336,
                         rope_theta=1e6, n_experts=8,
                         n_experts_per_token=2)


def moe_param_shapes(cfg: MoEConfig) -> Dict[str, Any]:
    """Same structure as :func:`init_moe_params`' result, with shapes."""
    shapes = param_shapes(cfg)
    n, e, d, h = cfg.n_layers, cfg.n_experts, cfg.dim, cfg.hidden_dim
    layers = {k: v for k, v in shapes["layers"].items()
              if k not in ("w1", "w2", "w3")}
    layers.update(router=(n, d, e), we1=(n, e, d, h), we3=(n, e, d, h),
                  we2=(n, e, h, d))
    return dict(shapes, layers=layers)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device=None) -> Dict[str, Any]:
    """Random weights as the JAX ``init_moe_params`` draws them:
    normal(0.02) matrices (``wo`` further scaled by ``dim**-0.5``,
    ``we2`` by ``hidden_dim**-0.5``), unit norm weights. Draws on the
    generator's device, one leaf at a time, then moves each to
    ``device`` in ``cfg.dtype``."""
    device = resolve_device(device)
    shapes = moe_param_shapes(cfg)
    scale = {"wo": cfg.dim ** -0.5, "we2": cfg.hidden_dim ** -0.5}

    def leaf(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=cfg.dtype, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(0.02 * scale.get(name, 1.0)).to(device=device,
                                                      dtype=cfg.dtype)

    return {k: ({n: leaf(n, s) for n, s in v.items()} if k == "layers"
                else leaf(k, v)) for k, v in shapes.items()}


def moe_params_from_jax(np_params: Dict[str, Any], cfg: MoEConfig,
                        device=None) -> Dict[str, Any]:
    """Carry the JAX package's MoE parameters (its pytree with numpy
    leaves) into the port: same keys and layout, ``cfg.dtype`` on
    ``device``. Raises on a missing key or a shape ``cfg`` does not
    give."""
    return tree_from_jax(np_params, moe_param_shapes(cfg), cfg.dtype,
                         resolve_device(device), "moe_params_from_jax")


def _moe_ffn(cfg: MoEConfig, lp, x: torch.Tensor):
    """x: ``[B, S, D]`` → (``[B, S, D]``, aux loss f32 scalar)."""
    # Router logits in cfg.dtype, then f32 for the softmax.
    probs = torch.softmax((x @ lp["router"]).float(), dim=-1)   # [B, S, E]
    # Every expert whose probability reaches the k-th largest is
    # selected: a tie at the k-th selects more than k, as in JAX.
    threshold = probs.topk(cfg.n_experts_per_token, dim=-1).values[..., -1:]
    gates = torch.where(probs >= threshold, probs, 0.0)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = gates.to(cfg.dtype)

    # Load-balance aux loss: E * sum_e fraction_tokens_e * mean_prob_e.
    token_frac = (gates > 0).float().mean(dim=(0, 1))
    prob_frac = probs.mean(dim=(0, 1))
    aux = cfg.n_experts * (token_frac * prob_frac).sum()

    # Dense-masked: every expert over every token.
    gate_x = torch.einsum("bsd,edf->ebsf", x, lp["we1"])
    up_x = torch.einsum("bsd,edf->ebsf", x, lp["we3"])
    hidden = F.silu(gate_x) * up_x                              # [E,B,S,F]
    per_expert = torch.einsum("ebsf,efd->ebsd", hidden, lp["we2"])
    return torch.einsum("ebsd,bse->bsd", per_expert, gates), aux


def _moe_layer(cfg: MoEConfig, attention, cos, sin, x, lp):
    """One block: ``(x, lp) -> (x, aux)``; cos/sin are the tables, or
    their rows at explicit positions."""
    b, t, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, h, lp)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    x = x + attention(q, k, v).reshape(b, t, -1).to(cfg.dtype) \
        @ lp["wo"].reshape(-1, cfg.dim)
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    ffn, aux = _moe_ffn(cfg, lp, h2)
    return x + ffn, aux


def moe_forward(params, tokens: torch.Tensor, cfg: MoEConfig, *,
                positions: Optional[torch.Tensor] = None):
    """tokens ``[B, S]`` → (logits ``[B, S, V]`` in ``cfg.dtype``, the
    aux loss averaged over layers, f32). Causal attention as
    ``cfg.attention`` routes it (``llama._attention_fn``).

    Any truthy ``cfg.remat`` checkpoints each layer with nothing saved
    but its input (JAX's ``nothing_saveable``), when a gradient is
    recorded: the backward reruns the whole layer, the flash forward
    included."""
    device = tokens.device
    attention = _attention_fn(cfg, device)
    if positions is not None:
        cos, sin = rope_from_positions(positions.to(device), cfg.head_dim,
                                       cfg.rope_theta)
    else:
        cos, sin = _rope_table(cfg.head_dim, cfg.max_seq_len,
                               cfg.rope_theta, device)
    x = params["embed"][tokens].to(cfg.dtype)
    body = functools.partial(_moe_layer, cfg, attention, cos, sin)
    remat = bool(cfg.remat) and torch.is_grad_enabled() \
        and _requires_grad(params)
    aux_total = torch.zeros((), dtype=torch.float32, device=device)
    for lp in _layers(params):
        if remat:
            # Nothing in a layer draws random numbers: no RNG state.
            x, aux = checkpoint(body, x, lp, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(x, lp)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _out_weight(params, cfg).to(cfg.dtype)
    return logits, aux_total / cfg.n_layers


def moe_loss_fn(params, batch: Dict[str, torch.Tensor], cfg: MoEConfig):
    """batch: ``{"tokens": [B, S], "targets": [B, S], optional
    "positions"}``. Returns ``(loss, {"loss", "ce_loss", "aux_loss"})``:
    the mean softmax CE over the full ``[B*S, V]`` logits plus
    ``aux_loss_coeff`` times the aux loss, as the JAX ``moe_loss_fn``."""
    logits, aux = moe_forward(params, batch["tokens"], cfg,
                              positions=batch.get("positions"))
    b, s, v = logits.shape
    ce = softmax_cross_entropy(logits.reshape(b * s, v),
                               batch["targets"].reshape(b * s)).mean()
    loss = ce + cfg.aux_loss_coeff * aux
    return loss, {"loss": loss, "ce_loss": ce, "aux_loss": aux}
