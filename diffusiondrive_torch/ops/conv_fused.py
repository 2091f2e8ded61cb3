"""Fused 3x3/64-channel conv -> per-channel affine -> residual -> ReLU (ResNet layer 1).

Counterpart of `diffusiondrive_tpu/ops/conv_fused.py:fused_conv3x3` and its
`bn_eval_affine`. The CUDA kernel is `csrc/conv3x3_fused.cu`;
`conv3x3_plain` beside it is the same function in plain PyTorch.

`fused_conv3x3` dispatches on the tensor's device: a CPU tensor takes
`conv3x3_plain`, a CUDA tensor launches the kernel or raises. The TPU's
width-pair packing (`pack_pairs`, `pack_conv3x3_weights`) is not ported: the
kernel reads NHWC bytes directly, i.e. an NCHW tensor in channels_last memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from diffusiondrive_torch.ops._build import load_library


def bn_eval_affine(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact float32 (scale, bias) of an eval-mode BatchNorm:
    ``s = gamma * rsqrt(var + eps)``, ``b = beta - mean * s``.

    Folded from the float32 statistics, never in bf16 and never by
    differencing probe outputs, which cancels catastrophically when
    |bias| >> |scale|.
    """
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    return s, beta.float() - mean.float() * s


def to_hwio(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW conv weight -> contiguous HWIO in `dtype`: the layout both
    kernels read (and the Flax `kernel` layout). Callers make it once, not
    at each launch."""
    return w.to(dtype).permute(2, 3, 1, 0).contiguous()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: conv in `x`'s dtype, then the affine, the
    residual add and the ReLU in float32, cast back to `x`'s dtype. `w` is
    HWIO (3, 3, 64, 64)."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), padding=1).float()
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _lib():
    lib = load_library("conv3x3_fused")
    fn = lib.ddt_conv3x3_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_nhwc(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"fused_conv3x3: {name} must match x in shape, dtype and device")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"fused_conv3x3: {name} must be contiguous in channels_last memory")
    if t.data_ptr() % 16:
        raise ValueError(f"fused_conv3x3: {name} must be 16-byte aligned")


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """(B, 64, H, W) -> (B, 64, H, W): 3x3/s1/pad1 conv, affine, residual, ReLU.

    A CPU tensor takes `conv3x3_plain`; any other tensor must meet the
    kernel's contract below, or the call raises. The wrapper copies nothing:
    the caller lays the weight out once (`to_hwio`).

    :param x: float32 or bf16 (B, 64, H, W), contiguous in channels_last
    :param w: (3, 3, 64, 64) HWIO conv weight in x's dtype, contiguous
    :param scale, bias: (64,) contiguous float32 folded eval-BN affine
    :param residual: optional tensor like `x`, added after the affine
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, scale, bias, residual, relu)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_conv3x3: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.dim() != 4 or x.shape[1] != 64:
        raise ValueError(f"fused_conv3x3: shape {tuple(x.shape)} not supported (B, 64, H, W)")
    _check_nhwc("x", x, x)
    if residual is not None:
        _check_nhwc("residual", residual, x)
    if (tuple(w.shape) != (3, 3, 64, 64) or w.dtype != x.dtype or w.device != x.device
            or not w.is_contiguous() or w.data_ptr() % 16):
        raise ValueError("fused_conv3x3: w must be contiguous, 16-byte aligned (3, 3, 64, 64) "
                         "HWIO in x's dtype on x's device")
    for t in (scale, bias):
        if (t.shape != (64,) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError("fused_conv3x3: scale and bias must be contiguous float32 (64,) "
                             "on x's device")
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_conv3x3: no kernel for device {x.device}")
    B, _, H, W = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    err = _lib()(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 None if residual is None else residual.data_ptr(), out.data_ptr(),
                 B, H, W, int(x.dtype == torch.bfloat16), int(relu),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_conv3x3: CUDA kernel launch failed (cudaError {err})")
    fused_conv3x3.launches += 1
    return out


fused_conv3x3.launches = 0
