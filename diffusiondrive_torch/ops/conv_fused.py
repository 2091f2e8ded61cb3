"""Fused 3x3/64-channel conv -> per-channel affine -> residual -> ReLU (ResNet layer 1).

Counterpart of `diffusiondrive_tpu/ops/conv_fused.py:fused_conv3x3` and its
`bn_eval_affine`. The CUDA kernel is `csrc/conv3x3_fused.cu`;
`conv3x3_plain` beside it is the same function in plain PyTorch.

`fused_conv3x3` dispatches on the tensor's device: a CPU tensor takes
`conv3x3_plain`, a CUDA tensor launches the kernel or raises. On the card
the dtype alone picks the kernel (`conv3x3_kernel`): bf16 runs on the
tensor cores ("mma"), float32 on the CUDA cores ("cuda_core"). The TPU's
width-pair packing (`pack_pairs`, `pack_conv3x3_weights`) is not ported: the
kernel reads NHWC bytes directly, i.e. an NCHW tensor in channels_last memory.
The models take the kernel only where `supports_fused_conv3x3` holds, as
JAX's do.

`conv3x3_train` (counterpart of JAX `conv3x3_train`) is the bare conv as a
`torch.autograd.Function` for the train step: its forward and its input
gradient run `fused_conv3x3` (identity affine), the weight gradient is the
library's, as JAX leaves it to XLA. `conv3x3_train_plain` is the same
function in plain PyTorch, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

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


def supports_fused_conv3x3(x: torch.Tensor, features: int, stride: int) -> bool:
    """JAX's gate (`supports_fused_conv3x3`): NCHW with 64 input channels, 64
    output channels, stride 1, W even and at least 2. The models take the
    kernel only where it holds and the module path otherwise; the kernel
    itself takes any H and W."""
    if x.dim() != 4 or x.shape[1] != 64 or features != 64 or stride != 1:
        return False
    _, _, H, W = x.shape
    return W % 2 == 0 and H >= 1 and W >= 2


def conv3x3_kernel(dtype: torch.dtype) -> str:
    """Which kernel a CUDA call launches: "mma" (bf16, mma.sync on the
    tensor cores) or "cuda_core" (float32 FMAs)."""
    return "mma" if dtype == torch.bfloat16 else "cuda_core"


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version, rounded as JAX's kernel rounds: the conv, the
    affine, the residual add and the ReLU in float32 on the widened inputs
    (float64 for a float64 `x`), then one rounding to `x`'s dtype. `w` is
    HWIO (3, 3, 64, 64)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.to(acc), w.permute(3, 2, 0, 1).to(acc), padding=1)
    y = y * scale.to(acc)[:, None, None] + bias.to(acc)[:, None, None]
    if residual is not None:
        y = y + residual.to(acc)
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


_IDENTITY: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _identity_affine(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (ones, zeros) of shape (64,) on `device`, made once per device."""
    if device not in _IDENTITY:
        _IDENTITY[device] = (torch.ones(64, device=device), torch.zeros(64, device=device))
    return _IDENTITY[device]


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """`t` in channels_last memory at a 16-byte aligned address: as it is, or
    a copy (autograd may hand a gradient in another layout), which the
    profile sees as the range "conv3x3_train_grad_copy"."""
    if t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0:
        return t
    with record_function("conv3x3_train_grad_copy"):
        return t.clone(memory_format=torch.channels_last)


class _Conv3x3Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        s, b = _identity_affine(x.device)
        return fused_conv3x3(x, w, s, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _kernel_layout(g)
        # dx[b, i, y, x] = sum g[b, o, y - dy + 1, x - dx + 1] w[dy, dx, i, o]: a pad-1 3x3
        # conv of g with w'[a, c, o, i] = w[2 - a, 2 - c, i, o]
        w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
        s, b = _identity_affine(x.device)
        dx = fused_conv3x3(g, w_flip, s, b)
        dw = torch.ops.aten.convolution_backward(
            g, x, w.permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]
        return dx, dw.permute(2, 3, 1, 0)


def conv3x3_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3/s1/pad1 64 -> 64 conv on the conv3x3 kernel.

    Forward: `fused_conv3x3` with an identity affine, no residual, no ReLU.
    Input gradient: the same kernel on the output gradient with the weight
    flipped in both spatial axes and in/out transposed. Weight gradient: the
    library's (`aten.convolution_backward`, weight only). A CPU tensor takes
    the plain versions inside `fused_conv3x3`.

    :param x: (B, 64, H, W) float32 or bf16, contiguous in channels_last
    :param w: (3, 3, 64, 64) HWIO in x's dtype, contiguous (`to_hwio`, which
        autograd carries back to the OIHW parameter)
    """
    return _Conv3x3Train.apply(x, w)


def conv3x3_train_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of `conv3x3_train`: `conv3x3_plain` with an identity
    affine, differentiated by autograd."""
    s, b = _identity_affine(x.device)
    return conv3x3_plain(x, w, s, b)
