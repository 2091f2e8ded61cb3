"""Fused ResNet stem: conv7x7/s2/pad3 -> folded eval-BN affine -> ReLU -> maxpool3x3/s2/pad1.

Counterpart of `diffusiondrive_tpu/ops/stem_fused.py:fused_stem`. The CUDA
kernel is `csrc/stem_fused.cu`; `stem_plain` beside it is the same function
in plain PyTorch.

`fused_stem` dispatches on the tensor's device: a CPU tensor takes
`stem_plain`, a CUDA tensor launches the kernel or raises. The TPU's planar
lane layout (`to_planar`, `pack_stem_weights_planar`) is not ported: the
kernel reads NHWC bytes directly, i.e. an NCHW tensor in channels_last memory.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffusiondrive_torch.ops._build import load_library


def supports_fused_stem(x: torch.Tensor) -> bool:
    """The kernel's gate: NCHW with 1 <= C <= 4 and H, W multiples of 4.

    Both stems of the planner (camera C=3, lidar C=1) pass it; the TPU
    kernel's lane-width gate does not apply on the GPU.
    """
    if x.dim() != 4:
        return False
    _, C, H, W = x.shape
    return 1 <= C <= 4 and H % 4 == 0 and W % 4 == 0 and H >= 4 and W >= 4


def stem_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the conv in `x`'s dtype, the affine and ReLU in
    float32, the pool in `x`'s dtype. `w` is HWIO (7, 7, C, 64)."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), stride=2, padding=3)
    y = torch.relu(y.float() * scale.float()[:, None, None] + bias.float()[:, None, None])
    return F.max_pool2d(y.to(x.dtype), 3, stride=2, padding=1)


def _lib():
    lib = load_library("stem_fused")
    fn = lib.ddt_stem_fused
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_stem(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 64, H/4, W/4), channels_last on CUDA.

    A CPU tensor takes `stem_plain`; any other tensor must meet the kernel's
    contract below, or the call raises. The wrapper copies nothing: the
    caller lays the weight out once (`conv_fused.to_hwio`).

    :param x: float32 or bf16 input, contiguous in channels_last
    :param w: (7, 7, C, 64) HWIO conv weight in x's dtype, contiguous
    :param scale, bias: (64,) contiguous float32 folded eval-BN affine
    """
    if x.device.type == "cpu":
        return stem_plain(x, w, scale, bias)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_stem: dtype {x.dtype} not supported (float32, bfloat16)")
    if not supports_fused_stem(x):
        raise ValueError(f"fused_stem: shape {tuple(x.shape)} not supported")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_stem: x must be contiguous in channels_last memory")
    B, C, H, W = x.shape
    if tuple(w.shape) != (7, 7, C, 64) or w.dtype != x.dtype or not w.is_contiguous():
        raise ValueError("fused_stem: w must be contiguous (7, 7, C, 64) HWIO in x's dtype")
    for t in (scale, bias):
        if t.shape != (64,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_stem: scale and bias must be contiguous float32 (64,)")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("fused_stem: all operands must be on x's device")
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_stem: no kernel for device {x.device}")
    out = torch.empty((B, 64, H // 4, W // 4), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    err = _lib()(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), B, H, W, C, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stem: CUDA kernel launch failed (cudaError {err})")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
