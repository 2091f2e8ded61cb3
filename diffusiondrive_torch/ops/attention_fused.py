"""Fused self-attention of the GPT fusion blocks, forward and backward.

Counterpart of `diffusiondrive_tpu/ops/attention_fused.py`: for each (batch,
head), ``softmax(q kᵀ / √D)`` in float32, an optional uint8 keep mask that
zeroes dropped probabilities and scales kept ones by 1/(1-p), then ``· v``.
The CUDA kernels are `csrc/attention_fused.cu`; `attention_fwd_plain` and
`attention_bwd_plain` beside them are the same functions in plain PyTorch,
rounded where the JAX kernels round: the probabilities are cast to q's dtype
before ``p · v``, the score gradient before the dq and dk products, and
every product accumulates in float32.

q, k and v are (B, H, T, D), as in JAX. The kernels read any strides with a
contiguous last dimension, so the (B, T, H, D) view of a `Linear` output
reshaped by heads is read in place; their outputs are (B, H, T, D) views of
(B, T, H, D) memory, so merging the heads back is free.

On the card bf16 with D <= 128 (every fusion stage) runs on the tensor cores
(`attn_fwd_mma_kernel`; the backward's `attn_bwd_dq_mma_kernel` and
`attn_bwd_dkdv_mma_kernel`); float32 and bf16 with D > 128 run on the CUDA
cores (`forward_kernel` and `backward_kernel` name the kernels of a call).

`fused_attention` is a `torch.autograd.Function` whose forward and backward
dispatch on the tensors' device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. The dropout keep mask is drawn
outside the kernels (`dropout_keep_mask`), as the JAX package draws it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from diffusiondrive_torch.ops._build import load_library

_MAX_T = 512
_MMA_MAX_D = 128  # `csrc/attention_fused.cu:dispatch`, forward and backward


def supports_fused_attention(T: int, d_head: int) -> bool:
    """The JAX package's gate: 8 <= T <= 512, T % 8 == 0, 8 <= D <= 256."""
    return 8 <= T <= _MAX_T and T % 8 == 0 and 8 <= d_head <= 256


def forward_kernel(dtype: torch.dtype, d_head: int) -> str:
    """Which forward kernel a CUDA call launches: "mma" (bf16 with D <= 128,
    mma.sync on the tensor cores) or "cuda_core" (f32 FMAs)."""
    return "mma" if dtype == torch.bfloat16 and d_head <= _MMA_MAX_D else "cuda_core"


def backward_kernel(dtype: torch.dtype, d_head: int) -> str:
    """Which backward kernels a CUDA call launches: "mma" (bf16 with D <= 128,
    both launches on the tensor cores) or "cuda_core" (f32 FMAs): the
    forward's rule."""
    return forward_kernel(dtype, d_head)


def dropout_keep_mask(generator: Optional[torch.Generator], shape: Sequence[int], pdrop: float,
                      device: torch.device) -> torch.Tensor:
    """uint8 keep mask (1 = keep) with P(keep) = 1 - pdrop, drawn exactly as
    `models/layers.py:Dropout` draws its mask: the same draws from the same
    generator give the same mask."""
    return (torch.rand(tuple(shape), generator=generator, device=device) >= pdrop).to(torch.uint8)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _probs(q, k, mask, pdrop):
    """(p, p after the keep mask), float32 (float64 for float64 inputs)."""
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-2, -1)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.softmax(s, dim=-1)
    if mask is None:
        return p, p
    return p, torch.where(mask != 0, p * (1.0 / (1.0 - pdrop)), torch.zeros((), dtype=acc))


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, pdrop: float = 0.0) -> torch.Tensor:
    """Plain version of the forward kernel (JAX `_probs` and `_fwd_kernel`)."""
    acc = _acc(q.dtype)
    _, pd = _probs(q, k, mask, pdrop)
    return torch.matmul(pd.to(q.dtype).to(acc), v.to(acc)).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], do: torch.Tensor,
                        pdrop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel (JAX `_bwd_kernel`): (dq, dk, dv)."""
    dt, acc = q.dtype, _acc(q.dtype)
    p, pd = _probs(q, k, mask, pdrop)
    q, k, v, do = (t.to(acc) for t in (q, k, v, do))
    dv = torch.matmul(pd.to(dt).to(acc).transpose(-2, -1), do)
    dp = torch.matmul(do, v.transpose(-2, -1))
    if mask is not None:
        dp = torch.where(mask != 0, dp * (1.0 / (1.0 - pdrop)), torch.zeros((), dtype=acc))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))) * (1.0 / math.sqrt(q.shape[-1]))
    ds = ds.to(dt).to(acc)
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-2, -1), q)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _lib():
    lib = load_library("attention_fused")
    for name, n_ptr in (("ddt_attention_fwd", 5), ("ddt_attention_bwd", 9)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_void_p]      # tensors, strides
                           + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, q: torch.Tensor, tensors, mask: Optional[torch.Tensor]) -> None:
    """Raise unless q, k, v (and dO) and the mask are what the kernels take."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (B, H, T, D), got {tuple(q.shape)}")
    B, H, T, D = q.shape
    if not supports_fused_attention(T, D) or B < 1 or H < 1:
        raise ValueError(f"{name}: shape {tuple(q.shape)} not supported "
                         f"(8 <= T <= {_MAX_T}, T % 8 == 0, 8 <= D <= 256)")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v and dO must match in shape, dtype and device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    if mask is not None:
        if (mask.shape != (B, H, T, T) or mask.dtype != torch.uint8 or mask.device != q.device
                or not mask.is_contiguous()):
            raise ValueError(f"{name}: mask must be a contiguous uint8 (B, H, T, T) on q's device")
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")


def _bthd_like(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, T, D) view of fresh (B, T, H, D) memory."""
    B, H, T, D = q.shape
    return torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _strides(tensors) -> ctypes.Array:
    """(batch, head, token) element strides of each (B, H, T, D) tensor."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch_args(q, mask, pdrop):
    B, H, T, D = q.shape
    inv_keep = 1.0 / (1.0 - pdrop) if mask is not None else 1.0
    return (B, H, T, D, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D), inv_keep,
            torch.cuda.current_stream(q.device).cuda_stream)


def _attention_fwd(q, k, v, mask, pdrop):
    """The forward kernel's wrapper: plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, mask, pdrop)
    _check("fused_attention", q, (q, k, v), mask)
    out = _bthd_like(q)
    strides = _strides((q, k, v, out))
    err = _lib().ddt_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   None if mask is None else mask.data_ptr(), out.data_ptr(),
                                   strides, *_launch_args(q, mask, pdrop))
    if err != 0:
        raise RuntimeError(f"fused_attention: CUDA kernel launch failed (cudaError {err})")
    fused_attention.launches += 1
    return out


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], do: torch.Tensor,
                        pdrop: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `fused_attention`: the backward kernel (two launches:
    a pass over query tiles for dq and the per-row softmax statistics, then
    a pass over key tiles for dk and dv) or, for CPU tensors, the plain
    version."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, mask, do, pdrop)
    _check("fused_attention_bwd", q, (q, k, v, do), mask)
    B, H, T, D = q.shape
    dq, dk, dv = _bthd_like(q), _bthd_like(q), _bthd_like(q)
    stats = torch.empty((3, B * H * T), dtype=torch.float32, device=q.device)
    strides = _strides((q, k, v, do, dq, dk, dv))
    err = _lib().ddt_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   None if mask is None else mask.data_ptr(), do.data_ptr(),
                                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                                   strides, *_launch_args(q, mask, pdrop))
    if err != 0:
        raise RuntimeError(f"fused_attention_bwd: CUDA kernel launch failed (cudaError {err})")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, pdrop):
        ctx.save_for_backward(q, k, v, mask)
        ctx.pdrop = pdrop
        return _attention_fwd(q, k, v, mask, pdrop)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, mask, do, ctx.pdrop)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, pdrop: float = 0.0) -> torch.Tensor:
    """softmax(q kᵀ / √D) [keep mask, 1/(1-pdrop)] · v, differentiable in q, k, v.

    :param q, k, v: (B, H, T, D) float32 or bf16, last dimension contiguous
        (on the card: `supports_fused_attention(T, D)` must hold)
    :param mask: optional contiguous (B, H, T, T) uint8 keep mask from
        `dropout_keep_mask`; required for a dropout (pdrop > 0)
    :return: (B, H, T, D) in q's dtype
    """
    if mask is None and pdrop:
        raise ValueError("fused_attention: a dropout (pdrop > 0) needs its keep mask")
    return _FusedAttention.apply(q, k, v, mask, pdrop)


fused_attention.launches = 0
