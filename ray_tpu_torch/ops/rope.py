"""Rotary position embeddings (RoPE), split-half convention.

Counterpart of ``ray_tpu/ops/rope.py``: a few elementwise operations, no
kernel of their own (the TPU version has none either).
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 500000.0, dtype=torch.float32,
                     device=None):
    """(cos, sin) tables of shape ``[max_seq_len, head_dim // 2]``.

    theta=500000 is the Llama-3 base; Llama-2 used 10000."""
    positions = torch.arange(max_seq_len, device=device)
    return rope_from_positions(positions, head_dim, theta, dtype)


def rope_from_positions(positions: torch.Tensor, head_dim: int,
                        theta: float = 500000.0, dtype=torch.float32):
    """cos/sin of shape ``[*positions.shape, head_dim // 2]`` computed
    from integer positions."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions=None) -> torch.Tensor:
    """x: ``[B, S, H, D]``; cos/sin: ``[max_seq, D/2]`` tables, or
    pre-selected ``[B, S, D/2]``; positions: optional ``[B, S]`` int
    positions gathered from the tables (defaults to ``arange(S)``)."""
    s = x.shape[1]
    if cos.dim() == 3:
        if positions is not None:
            raise ValueError("pre-selected 3-D cos/sin already encode "
                             "positions")
        cos_sel, sin_sel = cos[:, :, None, :], sin[:, :, None, :]
    elif positions is None:
        cos_sel, sin_sel = cos[:s][None, :, None, :], sin[:s][None, :, None, :]
    else:
        # Clamped like JAX's gather: an out-of-range index must not fault
        # the device.
        positions = positions.clamp(0, cos.shape[0] - 1)
        cos_sel = cos[positions][:, :, None, :]  # [B, S, 1, D/2]
        sin_sel = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos_sel - x2 * sin_sel,
                     x2 * cos_sel + x1 * sin_sel], dim=-1)
    return out.to(x.dtype)
