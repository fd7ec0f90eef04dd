"""Attention: the flash kernels and their plain versions.

Counterpart of ``ray_tpu/ops/attention.py`` and of
``ray_tpu/models/llama.py:_cached_attention``.

- :func:`flash_attention_fwd` runs the CUDA kernels of
  ``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_flash_fwd_kernel``:
  bf16 on the tensor cores when Sq > 8, an 8-row FMA tile when Sq <= 8,
  FMA tiles for f32) on CUDA tensors and its plain version
  :func:`flash_attention_fwd_reference` on CPU tensors.
  The kernel takes a per-sequence query offset, so the same call computes
  the TPU kernel's causal attention (offset 0) and the KV-cache attention
  of prefill and decode (offset = the sequence's start position). It is
  forward-only and refuses inputs that require grad.
- :func:`flash_attention_bwd` runs the two kernels of ``csrc/flash_bwd.cu``
  (the ports of ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``) on
  CUDA tensors and :func:`flash_attention_bwd_reference` on CPU tensors.
- :func:`flash_attention` is the differentiable form (the custom op
  ``ray_tpu_torch::flash_fwd`` with its autograd, the counterpart of the
  ``_flash`` custom_vjp): the forward kernel, then the backward kernels.

Layout at the public functions is ``[batch, seq, heads, head_dim]``, as
in ``ray_tpu.ops.attention.flash_attention``; K/V may have fewer heads
(GQA: query head ``h`` reads KV head ``h // (H / Hkv)``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch import _build

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def attention_reference(q, k, v, causal: bool, sm_scale: float):
    """``[B, H, S, D]`` layout, GQA-aware: the plain softmax attention of
    ``ray_tpu.ops.attention.attention_reference``."""
    h, h_kv = q.shape[1], k.shape[1]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def cached_attention_reference(q, k_cache, v_cache, q_positions):
    """q: ``[B, T, H, D]``; caches: ``[B, S, Hkv, D]``; q_positions:
    ``[B, T]`` absolute positions. Causal over absolute key positions:
    the plain form of ``ray_tpu.models.llama._cached_attention``,
    including its f32 upcast of q and k and its cast of the
    probabilities to v's dtype."""
    d = q.shape[-1]
    s_len = k_cache.shape[1]
    rep = q.shape[2] // k_cache.shape[2]
    k = k_cache.repeat_interleave(rep, dim=2)
    v = v_cache.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * (d ** -0.5)
    key_pos = torch.arange(s_len, device=q.device)
    mask = key_pos[None, None, :] <= q_positions[:, :, None]  # [B, T, S]
    scores = scores.masked_fill(~mask[:, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def flash_attention_fwd_reference(
        q, k, v, *, causal: bool, sm_scale: float,
        q_offset: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernel, with its arithmetic:
    q scaled by ``sm_scale`` in the storage dtype, f32 scores, p cast to
    v's dtype for the PV product, ``o = acc / max(l, 1e-30)``,
    ``lse = m + log(l)``. Returns ``(o [B, Sq, H, D], lse [B, H, Sq]
    f32)``."""
    b, sq, h, _ = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    qs = (q * torch.tensor(sm_scale, dtype=q.dtype)).float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    mask = None
    if causal:
        off = (torch.zeros(b, dtype=torch.int64, device=q.device)
               if q_offset is None else q_offset.long())
        rows = off[:, None] + torch.arange(sq, device=q.device)[None, :]
        mask = (torch.arange(sk, device=q.device)[None, None, :]
                <= rows[:, :, None])[:, None]  # [B, 1, Sq, Sk]
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf.float())
    o = acc / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


@functools.cache
def _kernel():
    fn = _build.library("flash_fwd").flash_fwd
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = ([ptr] * 6 + [i64] * 6 + [i64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k, v, q_offset,
                     name: str = "flash_attention_fwd") -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes [B, S, H, D] q, k, v")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    h_kv = k.shape[2]
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"{name}: {h} q heads over {h_kv} KV heads")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} kernel needs the head_dim axis "
                         "contiguous")
    # K/V rows are read as 16-byte vectors, and so are the rows of a bf16
    # q (the tensor-core kernels copy it in 16-byte pieces).
    elt = k.element_size()

    def misaligned(t):
        return t.data_ptr() % 16 or any(t.stride(i) * elt % 16
                                        for i in range(3))

    if misaligned(k) or misaligned(v):
        raise ValueError(f"{name} kernel needs 16-byte aligned K/V rows")
    if q.dtype == torch.bfloat16 and misaligned(q):
        raise ValueError(f"{name}: the bf16 kernels need a 16-byte aligned q")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 sequences and "
                         "heads")
    if q_offset is not None:
        if q_offset.device != q.device or q_offset.dtype != torch.int32 \
                or q_offset.shape != (b,) or not q_offset.is_contiguous():
            raise ValueError(f"{name}: q_offset must be a contiguous int32 "
                             "[B] tensor on q's device")


def flash_attention_fwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, sm_scale: Optional[float] = None,
        q_offset: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward over ``[B, S, H, D]`` tensors.

    Row ``i`` of sequence ``b`` sees key ``j`` iff
    ``j <= q_offset[b] + i`` (causal; ``q_offset`` defaults to 0, which
    is the TPU kernel's top-left mask) or ``j < Sk`` (non-causal).
    ``q_offset`` (int32 ``[B]``, on q's device, each >= 0) is read by the
    kernel on the device: the call never syncs the host. Returns
    ``(o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32)``.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    :func:`flash_attention_fwd_reference`."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention_fwd is forward-only: use flash_attention for "
            "inputs that require grad")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _flash_fwd(q, k, v, causal, sm_scale, q_offset)


def _flash_fwd(q, k, v, causal: bool, sm_scale: float, q_offset):
    """The forward kernel's launch (or its plain version on the CPU),
    shared by :func:`flash_attention_fwd` and :func:`flash_attention`."""
    if q.device.type == "cpu":
        others = (k, v) if q_offset is None else (k, v, q_offset)
        if any(t.device.type != "cpu" for t in others):
            raise ValueError("flash_attention_fwd: q on the CPU, other "
                             "inputs elsewhere")
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_fwd: no kernel for device "
                         f"{q.device}")
    _check_cuda_args(q, k, v, q_offset)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None if q_offset is None else q_offset.data_ptr(),
        b, sq, sk, h, h_kv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        float(sm_scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0  # kernel launches, for callers that check


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def flash_attention_bwd_reference(
        q, k, v, o, lse, do, *, causal: bool, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels, with their arithmetic:
    q scaled by ``sm_scale`` in the storage dtype, ``s`` and ``dp = do·vᵀ``
    in f32, ``p = exp(s − lse)`` masked, ``ds = p·(dp − delta)`` with
    ``delta = rowsum(do·o)`` in f32, ``p`` and ``ds`` cast to the storage
    dtype before they multiply a stored tensor, ``dq = scale·(ds·k)``,
    ``dv = pᵀ·do`` and ``dk = dsᵀ·(scale·q)`` per query head, then summed
    over each GQA group. ``[B, S, H, D]`` layout; ``lse [B, H, Sq]`` f32.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    qs = q * torch.tensor(sm_scale, dtype=q.dtype)
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kf)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        p = p.masked_fill(~mask, 0.0)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf) \
        * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())
    dk = dk.reshape(b, sk, h_kv, rep, d).sum(3)
    dv = dv.reshape(b, sk, h_kv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _bwd_kernels():
    lib = _build.library("flash_bwd")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    fns = {}
    for kind in ("dq", "dkv"):
        fn = getattr(lib, f"flash_bwd_{kind}")
        fn.argtypes = ([ptr] * 9 + [i64] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr])
        fn.restype = ctypes.c_int
        fns[kind] = fn
    return fns


def _launch_bwd(kind: str, tensors, scalars) -> None:
    """Launch the ``dq`` or ``dkv`` kernel of ``csrc/flash_bwd.cu`` (both
    take the same arguments: the tensors ``(q, k, v, do, lse, delta, dq,
    dk, dv)``, then the sizes and flags), raise on a launch error, and
    count the launch on :func:`flash_attention_bwd`."""
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = _bwd_kernels()[kind](*(t.data_ptr() for t in tensors), *scalars,
                               stream)
    if err:
        raise RuntimeError(f"flash_bwd_{kind} kernel launch failed: CUDA "
                           f"error {err}")
    if kind == "dq":
        flash_attention_bwd.dq_launches += 1
    else:
        flash_attention_bwd.dkv_launches += 1


def _check_bwd_args(q, k, v, o, lse, do) -> None:
    _check_cuda_args(q, k, v, None, "flash_attention_bwd")
    b, sq, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"[B, H, Sq] = {(b, h, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: inputs on different devices")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: o and do must have q's dtype "
                        f"{q.dtype}, got {o.dtype}, {do.dtype}")
    # The bf16 kernels also copy do rows as 16-byte pieces (q is checked
    # by _check_cuda_args).
    if q.dtype == torch.bfloat16 and do.data_ptr() % 16:
        raise ValueError("flash_attention_bwd: the bf16 kernels need a "
                         "16-byte aligned do")


def flash_attention_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
        sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dq, dk, dv)`` of the flash forward over ``[B, S, H,
    D]`` tensors, from its output ``o``, its ``lse [B, H, Sq]`` (f32) and
    the output's cotangent ``do``. Query offset 0: the forward's top-left
    causal mask, or none.

    CUDA tensors go through the dq and dk/dv kernels (or raise), after
    ``delta = rowsum(do·o)`` is computed here in f32, as JAX computes it
    outside its kernels; CPU tensors go through
    :func:`flash_attention_bwd_reference`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if any(t.device.type != "cpu" for t in (k, v, o, lse, do)):
            raise ValueError("flash_attention_bwd: q on the CPU, other "
                             "inputs elsewhere")
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd: no kernel for device "
                         f"{q.device}")
    tensors, scalars = _bwd_launch_args(q, k, v, o, lse, do, causal,
                                        sm_scale)
    dq, dk, dv = tensors[6:]
    if dq.numel():
        _launch_bwd("dq", tensors, scalars)
    if dk.numel():
        _launch_bwd("dkv", tensors, scalars)
    return dq, dk, dv


def _bwd_launch_args(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """Check the CUDA inputs, compute ``delta`` and allocate the outputs:
    returns the tensors ``(q, k, v, do, lse, delta, dq, dk, dv)`` and the
    scalars that both backward kernels take."""
    # The cotangent from autograd may be an expanded (stride 0) tensor.
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    _check_bwd_args(q, k, v, o, lse, do)
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    scalars = (b, sq, sk, h, h_kv, d, float(sm_scale), int(bool(causal)),
               _DTYPE_CODE[q.dtype])
    return (q, k, v, do, lse, delta, *outs), scalars


# kernel launches, for callers that check the path
flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable forward as one dispatcher op, so that a
    selective-checkpoint policy can save its ``(o, lse)`` across a
    checkpoint instead of rerunning it (``models/llama.py``'s remat): the
    counterpart of ``_flash_vjp_fwd``, whose ``o`` and ``lse`` are named
    ``flash_out`` and ``flash_lse``. Kernel on CUDA, plain version on the
    CPU, as :func:`_flash_fwd` decides."""
    return _flash_fwd(q, k, v, causal, sm_scale, None)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, sm_scale):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, h, sq), dtype=torch.float32))


def _flash_setup_context(ctx, inputs, output):
    q, k, v, causal, sm_scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.sm_scale = causal, sm_scale
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, do, _dlse):
    """:func:`flash_attention_bwd` from the saved ``(q, k, v, o, lse)``,
    as ``_flash_vjp_bwd``; lse is not differentiable."""
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                     sm_scale=ctx.sm_scale)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[B, S, H, D]`` tensors (K/V may have fewer
    heads), differentiable: the counterpart of
    ``ray_tpu.ops.attention.flash_attention``. The forward kernel saves
    ``(q, k, v, o, lse)`` for the backward kernels, as the ``_flash``
    custom_vjp does. Returns ``o`` in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    o, _ = _flash_fwd_op(q, k, v, bool(causal), float(sm_scale))
    return o
