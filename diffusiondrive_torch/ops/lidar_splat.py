"""Lidar point -> BEV histogram splat.

Counterpart of `diffusiondrive_tpu/ops/lidar_splat.py`. The histogram is the
CUDA kernel `csrc/lidar_splat.cu` (all B clouds in one launch);
`histogram2d_plain` beside it is the same function in plain PyTorch, the
overflow-bucket scatter-add of the JAX package's `histogram2d_jax`.
`histogram2d` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.

The binning, the height filter, the clip at `hist_max_per_pixel` and the
normalisation stay elementwise PyTorch around the kernel. The bin
arithmetic is float32 with Python-float scalars, as JAX computes it, so the
bins agree bit for bit with the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from diffusiondrive_torch.ops._build import load_library

_MAX_SMEM = 232448     # bytes of shared memory a block may use on Hopper
_MAX_SEGMENT = 65535   # points a block counts at once: a count fits its 16-bit half


class SplatPlan(NamedTuple):
    """How `csrc/lidar_splat.cu` covers a (B, N) -> (B, bins, bins) call:
    `bands` bands of `band_rows` histogram rows (the last may be shorter),
    the B*N points cut into `segments` of `segment` points, one block per
    segment and band, each with `smem` bytes of 16-bit counts."""
    bands: int
    band_rows: int
    segments: int
    segment: int
    smem: int


def splat_plan(B: int, N: int, bins: int, sms: int) -> SplatPlan:
    """The splat kernel's launch plan: as few bands as the shared memory
    allows (2-byte counts), and enough segments of at most 65535 points that
    every one of `sms` SMs gets a block."""
    max_rows = _MAX_SMEM // (2 * bins)
    if max_rows < 1:
        raise ValueError(f"histogram2d: bins={bins} leaves no row in {_MAX_SMEM} bytes of shared memory")
    bands = -(-bins // max_rows)
    band_rows = -(-bins // bands)
    total = B * N
    if total == 0:
        return SplatPlan(bands, band_rows, 1, 0, 16 * -(-band_rows * bins // 8))
    blocks = max(-(-total // _MAX_SEGMENT), -(-sms // bands))  # per band
    segment = -(-total // blocks)
    return SplatPlan(bands, band_rows, -(-total // segment), segment, 16 * -(-band_rows * bins // 8))


def _bin_indices(points_xy: torch.Tensor, valid: torch.Tensor, min_x: float, max_x: float,
                 min_y: float, max_y: float, bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """np.histogramdd bin indices: [e_i, e_{i+1}) half-open, last bin closed;
    out-of-range or invalid points get -1. float32 `points_xy` (..., 2)."""
    scale_x = bins / (max_x - min_x)
    scale_y = bins / (max_y - min_y)
    x, y = points_xy[..., 0], points_xy[..., 1]
    ix = torch.floor((x - min_x) * scale_x).to(torch.int32)
    iy = torch.floor((y - min_y) * scale_y).to(torch.int32)
    in_x = (x >= min_x) & (x <= max_x)
    in_y = (y >= min_y) & (y <= max_y)
    ix = ix.clamp(0, bins - 1)  # right edge belongs to the last bin
    iy = iy.clamp(0, bins - 1)
    ok = in_x & in_y & valid
    skip = torch.full_like(ix, -1)
    return torch.where(ok, ix, skip), torch.where(ok, iy, skip)


def histogram2d_plain(ix: torch.Tensor, iy: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Plain PyTorch version: (B, N) bin indices -> (B, bins, bins) float32
    counts. A point counts iff 0 <= ix, iy < bins; the rest go to an
    overflow bucket that is dropped (`histogram2d_jax`)."""
    ok = (ix >= 0) & (ix < bins) & (iy >= 0) & (iy < bins)
    flat = torch.where(ok, ix.long() * bins + iy.long(), bins * bins)
    counts = torch.zeros((ix.shape[0], bins * bins + 1), dtype=torch.float32, device=ix.device)
    counts.scatter_add_(1, flat, torch.ones(flat.shape, dtype=torch.float32, device=ix.device))
    return counts[:, :-1].reshape(-1, bins, bins)


def _lib():
    fn = load_library("lidar_splat").ddt_lidar_splat
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def histogram2d(ix: torch.Tensor, iy: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """(B, N) int32 bin indices (-1 = skip) -> (B, bins, bins) float32 counts.

    A CPU tensor takes `histogram2d_plain`; a CUDA tensor launches the kernel
    (one launch for all B clouds, after a memset of the output on the same
    stream) or raises. Counts must stay below 2**24, where float32 holds
    every integer: the kernel merges its partial counts by float atomics.
    """
    if ix.device.type == "cpu":
        return histogram2d_plain(ix, iy, bins)
    if ix.dim() != 2 or ix.shape != iy.shape:
        raise ValueError(f"histogram2d: ix {tuple(ix.shape)} and iy {tuple(iy.shape)} must be "
                         f"the same (B, N)")
    if ix.dtype != torch.int32 or iy.dtype != torch.int32:
        raise TypeError(f"histogram2d: indices must be int32, got {ix.dtype} and {iy.dtype}")
    if not (ix.is_contiguous() and iy.is_contiguous()):
        raise ValueError("histogram2d: ix and iy must be contiguous")
    if iy.device != ix.device:
        raise ValueError("histogram2d: ix and iy must be on one device")
    if ix.device.type != "cuda":
        raise RuntimeError(f"histogram2d: no kernel for device {ix.device}")
    B, N = ix.shape
    if not (0 < B <= 65535 and 0 < bins <= 65535 and N < 2 ** 24):
        raise ValueError(f"histogram2d: B={B}, N={N}, bins={bins} outside the kernel's range")
    plan = splat_plan(B, N, bins, torch.cuda.get_device_properties(ix.device).multi_processor_count)
    out = torch.empty((B, bins, bins), device=ix.device, dtype=torch.float32)
    with torch.cuda.device(ix.device):  # the launcher launches on the current device
        err = _lib()(ix.data_ptr(), iy.data_ptr(), out.data_ptr(), B, N, bins, plan.bands, plan.band_rows,
                     plan.segment, plan.smem, torch.cuda.current_stream(ix.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"histogram2d: CUDA kernel launch failed (cudaError {err})")
    histogram2d.launches += 1
    return out


histogram2d.launches = 0


def batched_splat_points(points: torch.Tensor, valid: torch.Tensor,
                         min_x: float = -32.0, max_x: float = 32.0,
                         min_y: float = -32.0, max_y: float = 32.0,
                         bins: int = 256, max_height: float = 100.0, split_height: float = 0.2,
                         hist_max_per_pixel: int = 5) -> torch.Tensor:
    """Lidar BEV feature of B clouds: z-filter + above-plane histogram,
    clipped and normalised. (B, N, 3) float32 points and (B, N) bool mask
    -> (B, bins, bins, 1) float32."""
    keep = valid & (points[..., 2] < max_height) & (points[..., 2] > split_height)
    ix, iy = _bin_indices(points[..., :2], keep, min_x, max_x, min_y, max_y, bins)
    hist = histogram2d(ix.contiguous(), iy.contiguous(), bins)
    hist = torch.clamp_max(hist, hist_max_per_pixel) / hist_max_per_pixel
    return hist[..., None]


def splat_points(points: torch.Tensor, valid: torch.Tensor, **kwargs) -> torch.Tensor:
    """One cloud: (N, 3) points and (N,) mask -> (bins, bins, 1); keywords as
    `batched_splat_points`."""
    return batched_splat_points(points[None], valid[None], **kwargs)[0]
