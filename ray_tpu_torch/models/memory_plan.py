"""Per-card memory plan for training a Llama config.

Counterpart of ``ray_tpu/models/memory_plan.py``: :func:`plan_llama` is
its accounting, copied (not imported), with the same keys; only the
table of device memory names the port's card. It is the reference's own
account of what each remat mode saves (``models/llama.py``'s
``_REMAT_SAVES``), and so the yardstick against which the card's peak
memory under each mode is read (``chip_smoke.py``'s memory phase).

The reference's ``shape_check_llama`` abstract-evaluates the sharded
train step on a virtual mesh; it waits for the port's sharded step
(``parallel/``, ROADMAP.md Queue 1, item 5).
"""

from __future__ import annotations

from typing import Any, Dict

# The port's card, and its device memory in GiB as the reference states
# its chips: the H100 SXM has 80 GiB of HBM3.
CHIP = "h100"
H100_HBM_GIB = 80.0


def _gib(n_bytes: float) -> float:
    return n_bytes / (1 << 30)


def plan_llama(cfg, mesh_shape: Dict[str, int], *, batch_per_chip: int,
               seq_len: int, moment_dtype_bytes: int = 4,
               remat: Any = True) -> Dict[str, Any]:
    """Analytic per-card memory budget for training ``cfg`` on a mesh of
    H100s of ``mesh_shape`` (e.g. ``{"data": 1}`` for one card,
    ``{"fsdp": 4}`` for four).

    Accounting (bf16 params/grads, fp32-or-bf16 Adam moments):
    - params:   2 bytes, sharded over fsdp*tensor
    - grads:    2 bytes, same sharding (live during the update)
    - adam:     2 moments * moment_dtype_bytes, same sharding
    - activations: with remat=True each layer saves the residual-stream
      carry plus the flash out+lse; the backward's working set adds one
      layer's full activations. "mlp"/"gate" additionally save the ffn
      hiddens.
    - loss: fused CE never materializes [B, S, V] logits; the fp32
      hidden row chunk is negligible.
    """
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v
    shard = mesh_shape.get("fsdp", 1) * mesh_shape.get("tensor", 1)
    p = cfg.num_params()
    param_b = 2 * p / shard
    grad_b = 2 * p / shard
    opt_b = 2 * moment_dtype_bytes * p / shard

    b, s, d, h = batch_per_chip, seq_len, cfg.dim, cfg.hidden_dim
    heads, hd = cfg.n_heads, cfg.head_dim
    # per-layer SAVED bytes under the remat policy (bf16 = 2 bytes)
    carry = b * s * d * 2
    flash = b * s * heads * hd * 2 + b * heads * s * 4  # out + lse(fp32)
    saved = carry + flash
    if remat == "gate":
        saved += b * s * h * 2
    elif remat == "mlp":
        saved += 2 * b * s * h * 2
    elif not remat:
        # everything live: q,k,v,attn,out,2 norms,3 ffn ~ rough 12x carry
        saved = carry * 6 + flash + 3 * b * s * h * 2
    act_b = saved * cfg.n_layers
    # backward working set: one layer recomputed in full
    work_b = carry * 6 + flash + 3 * b * s * h * 2
    # embedding table (replicated below the gather threshold, else
    # embed-sharded) + fp32 CE chunk
    embed_bytes = cfg.vocab_size * d * 2
    embed_b = embed_bytes if embed_bytes <= (1 << 27) \
        else embed_bytes / mesh_shape.get("tensor", 1)

    total_b = param_b + grad_b + opt_b + act_b + work_b + embed_b
    hbm = H100_HBM_GIB * (1 << 30)
    return {
        "config": f"{p/1e9:.2f}B params",
        "mesh": dict(mesh_shape),
        "chips": n_chips,
        "chip": CHIP,
        "batch_per_chip": b,
        "seq_len": s,
        "per_chip_gib": {
            "params": round(_gib(param_b), 3),
            "grads": round(_gib(grad_b), 3),
            "optimizer": round(_gib(opt_b), 3),
            "activations_saved": round(_gib(act_b), 3),
            "backward_working_set": round(_gib(work_b), 3),
            "embedding": round(_gib(embed_b), 3),
            "total": round(_gib(total_b), 3),
        },
        "hbm_gib": H100_HBM_GIB,
        "utilization": round(total_b / hbm, 3),
        "fits": total_b < hbm * 0.92,  # leave allocator headroom
        "global_tokens_per_step": b * s * mesh_shape.get("data", 1)
        * mesh_shape.get("fsdp", 1),
    }
