"""Llama-3-family decoder-only LM in PyTorch: inference and the loss.

Counterpart of ``ray_tpu/models/llama.py``. Parameters are a plain dict
of tensors in the JAX package's layout (layers stacked on axis 0:
``wq [L, d, H, hd]``, ``wk``/``wv [L, d, Hkv, hd]``, ``wo [L, H, hd, d]``,
``w1``/``w3 [L, d, F]``, ``w2 [L, F, d]``), so :func:`params_from_jax`
is a conversion of array types and nothing else. Layers run as a Python
loop. Attention goes through the flash kernels (as ``cfg.attention``
routes it) and every norm through the RMSNorm kernel on CUDA tensors; the projections and the output head
are plain matrix products (``torch.matmul``), as the JAX package leaves
them to XLA. :func:`forward_hidden`, :func:`forward` and :func:`loss_fn`
are differentiable (the training path); :func:`forward_with_cache` is
the serving path, forward only. Remat (activation checkpointing) and
sharding are not ported yet.

Entry points (:func:`init_params`, :func:`params_from_jax`,
:func:`init_kv_cache`) run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU they raise rather than fall back.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.attention import (attention_reference,
                                         flash_attention, flash_attention_fwd)
from ray_tpu_torch.ops.cross_entropy import (fused_linear_cross_entropy,
                                             softmax_cross_entropy)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import (apply_rope, rope_frequencies,
                                    rope_from_positions)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device. Raises when CUDA
    is asked for and absent: nothing drops to the CPU quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # "auto" | "flash" | "reference" | "ring" | "ulysses", routed by
    # forward_hidden as JAX's _attention routes it: "auto" is the flash
    # kernels on CUDA and the plain attention elsewhere. "ring" and
    # "ulysses" need parallel/ (not ported yet) and raise. The cached
    # (serving) path always takes the flash forward, as in JAX.
    attention: str = "auto"
    # False | True | "gate" | "mlp", validated as in JAX by
    # forward_hidden. Only False is ported: the others raise when a
    # gradient is recorded (checkpointing changes memory, never the
    # result).
    remat: Any = True
    # loss_fn fuses the output projection into the CE loss (the logits
    # are never materialised) unless this is False.
    fused_ce: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        d, h, l, v = self.dim, self.hidden_dim, self.n_layers, self.vocab_size
        per_layer = (
            d * self.n_heads * self.head_dim
            + 2 * d * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * d
            + 3 * d * h
            + 2 * d
        )
        embeds = v * d * (1 if self.tie_embeddings else 2)
        return l * per_layer + embeds + d

    # -- presets ---------------------------------------------------------

    @staticmethod
    def debug() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                           dtype=torch.float32, remat=False)

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        # Llama-3.2-1B: 1.23B params, tied embeddings.
        return LlamaConfig(vocab_size=128256, dim=2048, n_layers=16,
                           n_heads=32, n_kv_heads=8, hidden_dim=8192,
                           tie_embeddings=True)

    @staticmethod
    def llama3_3b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, dim=3072, n_layers=28,
                           n_heads=24, n_kv_heads=8, hidden_dim=8192,
                           tie_embeddings=True)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()  # defaults are 8B

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                           hidden_dim=28672)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Same structure as :func:`init_params`' result, with shapes."""
    d, hd, n = cfg.dim, cfg.head_dim, cfg.n_layers
    layers = {
        "attn_norm": (n, d),
        "wq": (n, d, cfg.n_heads, hd),
        "wk": (n, d, cfg.n_kv_heads, hd),
        "wv": (n, d, cfg.n_kv_heads, hd),
        "wo": (n, cfg.n_heads, hd, d),
        "mlp_norm": (n, d),
        "w1": (n, d, cfg.hidden_dim),
        "w3": (n, d, cfg.hidden_dim),
        "w2": (n, cfg.hidden_dim, d),
    }
    shapes = {"embed": (cfg.vocab_size, d), "layers": layers,
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["out"] = (d, cfg.vocab_size)
    return shapes


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights as the JAX ``init_params`` draws them: normal(0.02)
    matrices (``wo`` and ``w2`` further scaled by ``dim**-0.5`` and
    ``hidden_dim**-0.5``), unit norm weights. Draws on the generator's
    device, then moves to ``device`` in ``cfg.dtype``."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)

    def normal(shape, scale=1.0):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * (0.02 * scale)).to(device=device, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    ls = shapes["layers"]
    layers = {
        "attn_norm": ones(ls["attn_norm"]),
        "wq": normal(ls["wq"]),
        "wk": normal(ls["wk"]),
        "wv": normal(ls["wv"]),
        "wo": normal(ls["wo"], cfg.dim ** -0.5),
        "mlp_norm": ones(ls["mlp_norm"]),
        "w1": normal(ls["w1"]),
        "w3": normal(ls["w3"]),
        "w2": normal(ls["w2"], cfg.hidden_dim ** -0.5),
    }
    params = {"embed": normal(shapes["embed"]), "layers": layers,
              "final_norm": ones(shapes["final_norm"])}
    if not cfg.tie_embeddings:
        params["out"] = normal(shapes["out"])
    return params


def _to_tensor(arr, dtype, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # writable, owned by torch
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_params: Dict[str, Any], cfg: LlamaConfig,
                    device=None) -> Dict[str, Any]:
    """Carry the JAX package's parameters (its pytree with numpy arrays
    as leaves) into the port: same keys, same layout, ``cfg.dtype`` on
    ``device``. Raises on a missing key or a shape that ``cfg`` does not
    give."""
    device = resolve_device(device)

    def convert(tree, shapes, path):
        if isinstance(shapes, dict):
            missing = set(shapes) - set(tree)
            if missing:
                raise KeyError(f"params_from_jax: missing {sorted(missing)} "
                               f"at {path or 'top level'}")
            return {k: convert(tree[k], shapes[k], f"{path}/{k}")
                    for k in shapes}
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(shapes):
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{arr.shape}, config gives {shapes}")
        return _to_tensor(arr, cfg.dtype, device)

    return convert(np_params, param_shapes(cfg), "")


@functools.lru_cache(maxsize=8)
def _rope_table(head_dim: int, max_seq_len: int, theta: float,
                device: torch.device):
    """The ``[max_seq_len, head_dim // 2]`` cos/sin tables, built once
    per (shape, theta, device) rather than on every forward; callers
    only read them."""
    return rope_frequencies(head_dim, max_seq_len, theta, device=device)


def _layer(params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _layers(params) -> List[Dict[str, torch.Tensor]]:
    """Per-layer views of the stacked layer tensors, for the
    differentiable forward. ``unbind`` (rather than :func:`_layer` layer
    by layer) gives autograd one node per stacked tensor, whose backward
    stacks the layers' gradients once."""
    names = list(params["layers"])
    per_name = [params["layers"][k].unbind(0) for k in names]
    return [dict(zip(names, views)) for views in zip(*per_name)]


def _out_weight(params, cfg: LlamaConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["out"]


def _qkv(cfg: LlamaConfig, h, lp):
    b, t, d = h.shape
    hd = cfg.head_dim
    q = (h @ lp["wq"].reshape(d, -1)).view(b, t, cfg.n_heads, hd)
    k = (h @ lp["wk"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
    v = (h @ lp["wv"].reshape(d, -1)).view(b, t, cfg.n_kv_heads, hd)
    return q, k, v


def _attn_out_and_mlp(cfg: LlamaConfig, x, attn, lp):
    b, t, _ = x.shape
    x = x + attn.reshape(b, t, -1).to(cfg.dtype) \
        @ lp["wo"].reshape(-1, cfg.dim)
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h2 @ lp["w1"])
    up = h2 @ lp["w3"]
    return x + (gate * up) @ lp["w2"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


_REMAT_QUEUE = ("remat={!r} (activation checkpointing) is not ported yet: "
                "ROADMAP.md Queue 1; use remat=False")


def _check_remat(cfg: LlamaConfig, params) -> None:
    """``cfg.remat`` as JAX validates it (llama.py:312-316). A valid
    non-False mode raises NotImplementedError when autograd records the
    forward (grad mode on, a parameter that requires grad); otherwise
    nothing is saved for a backward, so there is nothing to checkpoint
    and the forward is the same."""
    if not cfg.remat:
        return
    if cfg.remat not in (True, "mlp", "gate"):
        raise ValueError(
            f"remat={cfg.remat!r}: expected False, True, 'gate', or 'mlp' "
            "(a typo here would silently train with attn-only "
            "checkpointing)")
    if torch.is_grad_enabled() and _requires_grad(params):
        raise NotImplementedError(_REMAT_QUEUE.format(cfg.remat))


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


_PARALLEL_QUEUE = ("attention={!r} (context-parallel attention) needs "
                   "parallel/, not ported yet: ROADMAP.md Queue 1, item 5")


def _attention_fn(cfg: LlamaConfig, device: torch.device):
    """The causal attention ``(q, k, v) -> o`` over ``[B, S, H, D]``
    that ``cfg.attention`` names, as JAX's ``_attention`` routes it
    (llama.py:192-223): "flash" is :func:`flash_attention` (the kernels
    on CUDA, their plain versions on the CPU); "auto" is flash on a CUDA
    device and "reference" elsewhere; "reference" is the plain
    :func:`attention_reference`, which repeats GQA's KV heads as JAX
    does. "ring" and "ulysses" raise NotImplementedError."""
    impl = cfg.attention
    if impl == "auto":
        impl = "flash" if device.type == "cuda" else "reference"
    scale = cfg.head_dim ** -0.5
    if impl == "flash":
        return lambda q, k, v: flash_attention(q, k, v, causal=True,
                                               sm_scale=scale)
    if impl == "reference":
        return lambda q, k, v: attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
            scale).transpose(1, 2)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(_PARALLEL_QUEUE.format(impl))
    raise ValueError(f"attention={impl!r}: expected 'auto', 'flash', "
                     "'reference', 'ring' or 'ulysses'")


def forward_hidden(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                   positions: Optional[torch.Tensor] = None):
    """tokens: ``[B, S]`` int → final-norm hidden states ``[B, S, D]``
    (``cfg.dtype``). Causal attention (top-left mask) as ``cfg.attention``
    routes it (:func:`_attention_fn`). Differentiable with respect to
    ``params``."""
    _check_remat(cfg, params)
    device = tokens.device
    attention = _attention_fn(cfg, device)
    if positions is not None:
        cos, sin = rope_from_positions(positions.to(device), cfg.head_dim,
                                       cfg.rope_theta)
    else:
        cos, sin = _rope_table(cfg.head_dim, cfg.max_seq_len,
                               cfg.rope_theta, device)
    x = params["embed"][tokens].to(cfg.dtype)
    for lp in _layers(params):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, lp)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        x = _attn_out_and_mlp(cfg, x, attention(q, k, v), lp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            positions: Optional[torch.Tensor] = None):
    """tokens: ``[B, S]`` int → logits ``[B, S, vocab]`` (``cfg.dtype``)."""
    x = forward_hidden(params, tokens, cfg, positions=positions)
    return x @ _out_weight(params, cfg).to(cfg.dtype)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: LlamaConfig):
    """batch: ``{"tokens": [B, S], "targets": [B, S], optional "mask":
    [B, S], optional "positions": [B, S]}``. Returns ``(mean loss f32,
    {"loss", "tokens", "perplexity"})``, as the JAX ``loss_fn``: fused
    projection + CE unless ``cfg.fused_ce`` is False, then blockwise CE
    over :func:`forward`'s logits."""
    b, s = batch["tokens"].shape
    targets = batch["targets"].reshape(b * s)
    if cfg.fused_ce:
        x = forward_hidden(params, batch["tokens"], cfg,
                           positions=batch.get("positions"))
        losses = fused_linear_cross_entropy(
            x.reshape(b * s, cfg.dim), _out_weight(params, cfg).to(cfg.dtype),
            targets)
    else:
        logits = forward(params, batch["tokens"], cfg,
                         positions=batch.get("positions"))
        losses = softmax_cross_entropy(
            logits.reshape(b * s, cfg.vocab_size), targets)
    losses = losses.reshape(b, s)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=losses.device)
    total = mask.sum().clamp_min(1.0)
    loss = (losses * mask).sum() / total
    return loss, {"loss": loss, "tokens": total,
                  "perplexity": torch.exp(loss)}


# ---------------------------------------------------------------------------
# KV-cache inference path (prefill + decode) — used by ray_tpu_torch.serve
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LlamaConfig, n_slots: int, max_seq: int,
                  dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Slot-based KV cache: ``[layers, slots, max_seq, kv_heads,
    head_dim]``, one slot per in-flight sequence."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_slots, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def forward_with_cache(params, tokens: torch.Tensor, cfg: LlamaConfig,
                       cache: Dict[str, torch.Tensor],
                       start_pos: torch.Tensor):
    """Incremental forward: runs ``tokens [B, T]`` starting at
    per-sequence absolute offsets ``start_pos`` (int32 ``[B]``, on the
    tokens' device), reading and writing the KV cache ``[L, B, S, Hkv,
    D]``. Returns ``(logits [B, T, vocab], cache)``. Works for prefill
    and decode with one code path.

    Unlike the JAX function, the cache is updated IN PLACE (the returned
    dict is the one passed in): a slot's K/V is written, then attended.
    The write clamps its start to ``S - T`` as ``lax.dynamic_update_slice``
    does, while RoPE and the attention mask use the unclamped positions,
    as in JAX. Nothing here syncs the host: the kernel reads
    ``start_pos`` on the device."""
    b, t = tokens.shape
    device = tokens.device
    s_max = cache["k"].shape[2]
    cos, sin = _rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                           device)
    steps = torch.arange(t, device=device)
    positions = start_pos[:, None] + steps[None, :]            # [B, T]
    write_pos = start_pos.clamp(0, s_max - t)[:, None] + steps[None, :]
    rows = torch.arange(b, device=device)[:, None]
    x = params["embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, lp)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]       # views
        k_cache[rows, write_pos] = k.to(k_cache.dtype)
        v_cache[rows, write_pos] = v.to(v_cache.dtype)
        attn, _ = flash_attention_fwd(q, k_cache, v_cache, causal=True,
                                      sm_scale=cfg.head_dim ** -0.5,
                                      q_offset=start_pos)
        x = _attn_out_and_mlp(cfg, x, attn, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ _out_weight(params, cfg).to(cfg.dtype)
    return logits, cache
