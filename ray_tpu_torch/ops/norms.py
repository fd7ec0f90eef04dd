"""RMSNorm and LayerNorm.

Counterpart of ``ray_tpu/ops/norms.py``. :func:`rms_norm` runs the CUDA
kernel ``csrc/rms_norm.cu`` (the port of the TPU kernel ``_rms_kernel``)
on CUDA tensors and its plain version :func:`rms_norm_reference` on CPU
tensors. Forward only, as on the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in f32, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias=None,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


@functools.cache
def _kernel():
    fn = _build.library("rms_norm").rms_norm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(x: torch.Tensor, weight: torch.Tensor) -> None:
    d = x.shape[-1]
    if not weight.is_cuda or weight.device != x.device:
        raise ValueError(f"rms_norm: weight on {weight.device}, x on "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE or weight.dtype != x.dtype:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16 x with "
                        f"a weight of the same dtype, got {x.dtype} and "
                        f"{weight.dtype}")
    if weight.shape != (d,):
        raise ValueError(f"rms_norm: weight shape {tuple(weight.shape)}, "
                         f"expected ({d},)")
    if d % 8:
        raise ValueError(f"rms_norm kernel needs D % 8 == 0, got D={d}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned x and "
                         "weight")


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x [..., D]``.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor
    through :func:`rms_norm_reference`."""
    if x.device.type == "cpu":
        if weight.device.type != "cpu":
            raise ValueError(f"rms_norm: x on the CPU, weight on "
                             f"{weight.device}")
        return rms_norm_reference(x, weight, eps)
    if not x.is_cuda:
        raise ValueError(f"rms_norm: no kernel for device {x.device}")
    _check_cuda_args(x, weight)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    err = _kernel()(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows,
                    d, float(eps), _DTYPE_CODE[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error "
                           f"{err}")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0  # kernel launches, for callers that check the path
