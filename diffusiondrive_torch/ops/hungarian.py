"""Exact batched linear assignment (Jonker-Volgenant shortest augmenting path).

Counterpart of `diffusiondrive_tpu/ops/hungarian.py`. The CUDA kernel is
`csrc/lap.cu` (one warp per problem); `linear_sum_assignment_plain` beside
it is the same algorithm in plain PyTorch, batched over B.

It replaces the host-side `scipy.optimize.linear_sum_assignment` that the
reference calls once per training step (a device-to-host sync): the
detection loss keeps its assignment on the device.

The arithmetic is that of the JAX function, step for step and in float32:
1-indexed columns with a virtual column 0, `_INF = 1e18`, dual potentials
updated as ``u + delta``, ``v - delta``, ``minv - delta``, rows augmented in
the order 1..n, and the argmin taking the first index on ties. Both versions
therefore return the JAX package's assignment exactly, ties included.

`batched_linear_sum_assignment` dispatches on the tensor's device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from diffusiondrive_torch.ops._build import load_library

_INF = 1e18
MAX_N = 31  # one warp: lane 0 is the virtual column, lanes 1..n the columns


def linear_sum_assignment_plain(cost: torch.Tensor, steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: (B, n, n) costs -> (B, n) int32 `col`, with
    ``col[b, i]`` the column assigned to row i, minimising the total cost.

    The search loop leaves as soon as every problem has reached a free
    column; JAX runs a fixed n+1 trips with the finished problems masked,
    which changes nothing in the result.

    `steps`, if given, is a (B,) int64 tensor on the cost's device: each
    problem's search steps and augment hops are added to it, the length of
    its chain of dependent steps in the kernel. It changes nothing else.
    """
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"linear_sum_assignment: expects (B, n, n), got {tuple(cost.shape)}")
    B, n, _ = cost.shape
    dev = cost.device
    f32 = torch.float32
    cpad = torch.zeros((B, n + 1, n + 1), dtype=f32, device=dev)
    cpad[:, 1:, 1:] = cost.to(f32)
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    col0 = torch.arange(n + 1, device=dev) == 0
    batch = torch.arange(B, device=dev)
    u = torch.zeros((B, n + 1), dtype=f32, device=dev)
    v = torch.zeros((B, n + 1), dtype=f32, device=dev)
    p = torch.zeros((B, n + 1), dtype=torch.long, device=dev)

    for i in range(1, n + 1):
        p[:, 0] = i
        minv = inf.expand(B, n + 1).clone()
        used = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
        urow = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
        way = torch.zeros((B, n + 1), dtype=torch.long, device=dev)
        j0 = torch.zeros(B, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(n + 1):  # at most n+1 columns join the alternating tree
            if steps is not None:
                steps += ~done
            live = ~done[:, None]
            used2 = used.clone()
            used2[batch, j0] = True
            i0 = p[batch, j0]
            urow2 = urow.clone()
            urow2[batch, i0] = True
            cur = cpad[batch, i0] - u[batch, i0][:, None] - v
            better = (cur < minv) & ~used2
            minv2 = torch.where(better, cur, minv)
            way2 = torch.where(better, j0[:, None], way)
            masked = torch.where(used2 | col0, inf, minv2)
            j1 = torch.argmin(masked, dim=1)  # first index on ties
            delta = masked[batch, j1][:, None]
            u = torch.where(live & urow2, u + delta, u)
            v = torch.where(live & used2, v - delta, v)
            minv = torch.where(live, torch.where(used2, minv2, minv2 - delta), minv)
            used = torch.where(live, used2, used)
            urow = torch.where(live, urow2, urow)
            way = torch.where(live, way2, way)
            j0 = torch.where(done, j0, j1)
            done = done | (p[batch, j1] == 0)  # j1 free: this step was the last
            if bool(done.all()):
                break
        # augment along `way` back to the virtual column: at most n+1 hops
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(n + 1):
            if steps is not None:
                steps += ~done
            j1 = way[batch, j0]
            p[batch, j0] = torch.where(done, p[batch, j0], p[batch, j1])
            j0 = torch.where(done, j0, j1)
            done = done | (j1 == 0)
            if bool(done.all()):
                break

    # p[b, j] = row (1-indexed) matched to column j  ->  col[b, row - 1] = j - 1
    col = torch.empty((B, n), dtype=torch.int32, device=dev)
    col[batch[:, None], p[:, 1:] - 1] = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    return col


def _lib():
    fn = load_library("lap").ddt_lap
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def batched_linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Solve B independent square LAPs: (B, n, n) float32 -> (B, n) int32.

    A CPU tensor takes `linear_sum_assignment_plain`; a CUDA tensor launches
    the kernel (one launch for all B problems) or raises. The kernel takes
    contiguous float32 costs with 1 <= n <= 31, the JAX kernel's limit.
    """
    if cost.device.type == "cpu":
        return linear_sum_assignment_plain(cost)
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"batched_linear_sum_assignment: expects (B, n, n), got {tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"batched_linear_sum_assignment: cost must be float32, got {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("batched_linear_sum_assignment: cost must be contiguous")
    B, n, _ = cost.shape
    if not (1 <= n <= MAX_N and 0 < B < 2 ** 31 // 32):
        raise ValueError(f"batched_linear_sum_assignment: n={n}, B={B} outside the kernel's range "
                         f"(1 <= n <= {MAX_N})")
    if cost.device.type != "cuda":
        raise RuntimeError(f"batched_linear_sum_assignment: no kernel for device {cost.device}")
    out = torch.empty((B, n), dtype=torch.int32, device=cost.device)
    err = _lib()(cost.data_ptr(), out.data_ptr(), B, n,
                 torch.cuda.current_stream(cost.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"batched_linear_sum_assignment: CUDA kernel launch failed (cudaError {err})")
    batched_linear_sum_assignment.launches += 1
    return out


batched_linear_sum_assignment.launches = 0
