"""HuggingFace checkpoint interop for the Llama family.

Counterpart of ``ray_tpu/models/hf.py``: converts ``transformers`` Llama
weights (a state dict, or the safetensors files of a checkpoint
directory) into the port's parameter layout (:mod:`llama`). Conversion
is pure tensor reshaping:

- ``q_proj.weight`` ``[H*hd, D]`` → ``wq [D, H, hd]`` (transpose + split
  heads), and so for ``k``/``v``/``o``
- ``gate/up/down_proj`` → ``w1``/``w3``/``w2`` (transposed)
- ``embed_tokens`` → ``embed``; ``lm_head`` → ``out`` (absent when tied)

Q/K rows are taken in HF's order as they are. Deliberately unlike the
JAX package, which permutes them (its ``_unpermute_rope``) on the
premise that HF stores the interleaved RoPE convention: HF's
``rotate_half`` is the split-half convention that both packages' RoPE
uses (transformers' conversion script permutes Meta's interleaved rows
into it), so that permutation changes the model. Without it the port's
logits equal transformers' (``tests/test_torch_hf.py``).

:func:`load_llama_from_hf` reads only a local directory that the caller
names, never a hub name, and never downloads. It reads the safetensors
format itself (an 8-byte little-endian header length, a JSON header,
raw little-endian tensors), so neither ``transformers`` nor
``safetensors`` is needed. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU they raise. Sharded
placement (``mesh``/``rules``) waits for ``parallel/``.
"""

from __future__ import annotations

import json
import math
import mmap
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig, resolve_device

_HF_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size", "rms_norm_eps")


def config_from_hf(hf_config) -> LlamaConfig:
    """Map a ``transformers.LlamaConfig``, or the dict of a checkpoint's
    ``config.json``, to the port's :class:`LlamaConfig` (the same fields
    and defaults as the JAX package's ``config_from_hf``)."""
    if isinstance(hf_config, Mapping):
        missing = [k for k in _HF_KEYS if k not in hf_config]
        if missing:
            raise KeyError(f"config_from_hf: config.json lacks {missing}")

        def get(name, default=None):
            return hf_config.get(name, default)
    else:
        def get(name, default=None):
            return getattr(hf_config, name, default)
    heads = get("num_attention_heads")
    return LlamaConfig(
        vocab_size=get("vocab_size"),
        dim=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=heads,
        n_kv_heads=get("num_key_value_heads", heads),
        hidden_dim=get("intermediate_size"),
        max_seq_len=get("max_position_embeddings", 8192),
        rope_theta=get("rope_theta", 10000.0),
        norm_eps=get("rms_norm_eps"),
        tie_embeddings=get("tie_word_embeddings", False),
    )


def params_from_hf_state_dict(state_dict: Mapping[str, Any],
                              cfg: LlamaConfig, dtype=None,
                              device=None) -> Dict[str, Any]:
    """A torch (or numpy) HF state dict → the port's parameters, layers
    stacked on axis 0, ``dtype`` (default ``cfg.dtype``) on ``device``.
    Each tensor is cast and moved first and reshaped on ``device``: the
    values are the state dict's rounded once to ``dtype``."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)

    def tensor(name) -> torch.Tensor:
        t = state_dict[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.asarray(t, np.float32))
        return t.detach().to(device=device, dtype=dtype, copy=True)

    d, hd = cfg.dim, cfg.head_dim
    layers: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w1", "w2", "w3")}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layers["attn_norm"].append(tensor(p + "input_layernorm.weight"))
        layers["wq"].append(tensor(p + "self_attn.q_proj.weight").T
                            .reshape(d, cfg.n_heads, hd))
        layers["wk"].append(tensor(p + "self_attn.k_proj.weight").T
                            .reshape(d, cfg.n_kv_heads, hd))
        layers["wv"].append(tensor(p + "self_attn.v_proj.weight").T
                            .reshape(d, cfg.n_kv_heads, hd))
        layers["wo"].append(tensor(p + "self_attn.o_proj.weight").T
                            .reshape(cfg.n_heads, hd, d))
        layers["mlp_norm"].append(
            tensor(p + "post_attention_layernorm.weight"))
        layers["w1"].append(tensor(p + "mlp.gate_proj.weight").T)
        layers["w3"].append(tensor(p + "mlp.up_proj.weight").T)
        layers["w2"].append(tensor(p + "mlp.down_proj.weight").T)

    params = {
        "embed": tensor("model.embed_tokens.weight").contiguous(),
        "layers": {k: torch.stack(v) for k, v in layers.items()},
        "final_norm": tensor("model.norm.weight").contiguous(),
    }
    if not cfg.tie_embeddings:
        params["out"] = tensor("lm_head.weight").T.contiguous()
    return params


# -- the safetensors format ---------------------------------------------------

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "F64": torch.float64,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write map of the file (nothing is read before it is used).
    Raises ``ValueError`` on a header that does not describe the file."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        n = int.from_bytes(f.read(8), "little")
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the end")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > 8 + n else b""
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: {name} offsets {info['data_offsets']} "
                             f"do not hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:  # misaligned: copy out
            raw = bytearray(buf[base + begin:base + end])
            out[name] = torch.frombuffer(raw, dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
    return out


def _read_state_dict(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a local checkpoint directory: ``model.safetensors``,
    or the shards that ``model.safetensors.index.json`` lists."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        state = {}
        for shard in sorted(set(weight_map.values())):
            state.update(read_safetensors(os.path.join(path, shard)))
        missing = set(weight_map) - set(state)
        if missing:
            raise KeyError(f"{index} lists tensors that no shard holds: "
                           f"{sorted(missing)[:5]}")
        return state
    single = os.path.join(path, "model.safetensors")
    if not os.path.exists(single):
        raise FileNotFoundError(f"{path} holds neither model.safetensors "
                                "nor model.safetensors.index.json")
    return read_safetensors(single)


def load_llama_from_hf(path, *, dtype=None, device=None):
    """Load a Llama checkpoint from a local directory (``config.json`` and
    its safetensors files) into ``(cfg, params)`` on ``device``. ``path``
    must be a directory: a hub name is not resolved and nothing is
    downloaded."""
    path = os.fspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"load_llama_from_hf: {path!r} is not a local directory (the "
            "port reads config.json and safetensors files, and never "
            "downloads)")
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    params = params_from_hf_state_dict(_read_state_dict(path), cfg,
                                       dtype=dtype, device=device)
    return cfg, params
