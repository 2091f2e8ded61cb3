"""Fused ResNet stem: conv7x7/s2/pad3 -> folded eval-BN affine -> ReLU -> maxpool3x3/s2/pad1.

Counterpart of `diffusiondrive_tpu/ops/stem_fused.py:fused_stem`. The CUDA
kernel is `csrc/stem_fused.cu`; `stem_plain` beside it is the same function
in plain PyTorch.

`fused_stem` dispatches on the tensor's device: a CPU tensor takes
`stem_plain`, a CUDA tensor launches the kernel or raises. On the card the
dtype alone picks the kernel (`stem_kernel`), both on the tensor cores:
bf16 in bf16 products ("mma"), float32 in three TF32 products a product
("mma_tf32x3", float32 accuracy; one TF32 product would break the float32
limit against `stem_plain`). Tensor-core time bounds the float32 kernel
(`csrc/stem_fused.cu`'s header says what each design does about it). The
TPU's planar lane layout (`to_planar`, `pack_stem_weights_planar`) is not
ported: the kernel reads NHWC bytes directly, i.e. an NCHW tensor in
channels_last memory.

Both kernels compute the 7x7/s2 conv as a 4x4/s1 conv over a 2x2
space-to-depth of the input; `stem_conv_s2d` is that form in plain
PyTorch, with the kernels' channel order and tap mapping, so that the CPU
tests can hold the mapping to the 7x7/s2 conv.
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


def stem_kernel(dtype: torch.dtype) -> str:
    """Which kernel a CUDA call launches: "mma" (bf16, `stem_mma_kernel`) or
    "mma_tf32x3" (float32, `stem_tf32x3_kernel`: three TF32 products a
    product), both mma.sync on the tensor cores."""
    return "mma" if dtype == torch.bfloat16 else "mma_tf32x3"


def stem_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, rounded as JAX's kernel rounds: the conv, the
    affine, the ReLU and the pool in float32 on the widened inputs (float64
    for a float64 `x`), then one rounding to `x`'s dtype (the pool commutes
    with it). `w` is HWIO (7, 7, C, 64)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.to(acc), w.permute(3, 2, 0, 1).to(acc), stride=2, padding=3)
    y = torch.relu(y * scale.to(acc)[:, None, None] + bias.to(acc)[:, None, None])
    return F.max_pool2d(y, 3, stride=2, padding=1).to(x.dtype)


def stem_conv_s2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7x7/s2/pad3 conv of `x` by `w` (HWIO (7, 7, C, 64)) in the
    kernels' form, in plain PyTorch and in `x`'s dtype: a 4x4/s1 conv over
    the 2x2 space-to-depth of `x`, output y reading s2d rows y-2 .. y+1
    (padding 2 before, 1 after).

    The s2d input (B, 16, H/2, W/2): channel pr*2C + pc*C + c of pixel
    (i, j) is x[:, c, 2i+pr, 2j+pc], channels 4C..15 are 0 (the bf16
    kernel's padding; the float32 kernel keeps the 4C). The weight (4, 4,
    16, 64), the kernels' rows [tap (dr, dc)][channel][out]:
    w4[dr, dc, pr*2C + pc*C + c] = w[2dr+pr-1, 2dc+pc-1, c], 0 where a tap
    index is -1 or the channel is past 4C.
    """
    B, C, H, W = x.shape
    xs = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(B, 4 * C, H // 2, W // 2)
    wp = F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))                 # (8, 8, C, 64): index = tap + 1
    w4 = wp.reshape(4, 2, 4, 2, C, 64).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * C, 64)
    xs, w4 = F.pad(xs, (0, 0, 0, 0, 0, 16 - 4 * C)), F.pad(w4, (0, 0, 0, 16 - 4 * C))
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), w4.permute(3, 2, 0, 1))


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

    :param x: float32 or bf16 input, contiguous in channels_last, 16-byte
        aligned
    :param w: (7, 7, C, 64) HWIO conv weight in x's dtype, contiguous,
        16-byte aligned
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
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_stem: x and w must be 16-byte aligned")
    for t in (scale, bias):
        if t.shape != (64,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_stem: scale and bias must be contiguous float32 (64,)")
    if any(t.device != x.device for t in (w, scale, bias)):
        raise ValueError("fused_stem: all operands must be on x's device")
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_stem: no kernel for device {x.device}")
    out = torch.empty((B, 64, H // 4, W // 4), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):  # the launcher launches on the current device
        err = _lib()(x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), B, H, W, C, int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stem: CUDA kernel launch failed (cudaError {err})")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
