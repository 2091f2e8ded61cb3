"""Device lists: the counterpart of `diffusiondrive_tpu/parallel/mesh.py`.

In the JAX package one program shards its batch over the `data` axis of a
`jax.sharding.Mesh`. In the port that split takes two shapes:

- training: one process per card under `DistributedDataParallel`
  (`parallel/distributed.py`, `training/trainer.py`); rank r of W holds
  rows ``[r * B / W, (r + 1) * B / W)`` of each global batch (`rank_rows`);
- evaluation: one process over an explicit list of devices, the "mesh"
  here; each batch is split by rows (`split_rows`), each device runs its
  chunk and the results are gathered on the first device (`gather_rows`).

A device list may repeat a device (``[cuda:0, cuda:0]``, ``[cpu, cpu]``):
the split, the per-device work and the gather are the same, so one card or
the CPU exercises the multi-device path.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

Mesh = Sequence[torch.device]


def local_devices(n: int, device: Optional[Union[str, torch.device]] = None) -> List[torch.device]:
    """The devices of `--mesh-devices n`: 0 none (no mesh), -1 every local
    device of `device`'s type, 1..k the first k. On the CPU there is one
    device. Anything else raises ValueError with the JAX CLI's message."""
    kind = torch.device(device).type if device is not None else "cuda"
    available = (torch.cuda.device_count() if torch.cuda.is_available() else 0) if kind == "cuda" else 1
    if n < -1 or n > available:
        raise ValueError(f"--mesh-devices must be 0 (no mesh), -1 (all) or 1..{available} "
                         f"(have {available} devices), got {n}")
    if n == 0:
        return []
    count = available if n == -1 else n
    return [torch.device(kind, i) if kind == "cuda" else torch.device(kind) for i in range(count)]


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad `axis` up to a multiple (for splitting uneven scene counts);
    returns (padded, original_length)."""
    length = array.shape[axis]
    remainder = (-length) % multiple
    if remainder == 0:
        return array, length
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, remainder)
    return np.pad(array, pad_width, mode="edge"), length


def rank_rows(batch_size: int, rank: int, world_size: int) -> slice:
    """The rows of a global batch that rank `rank` of `world_size` holds."""
    if batch_size % world_size:
        raise ValueError(f"a global batch of {batch_size} rows does not split over {world_size} ranks")
    per = batch_size // world_size
    return slice(rank * per, (rank + 1) * per)


def split_rows(batch: Union[torch.Tensor, Mapping[str, Any]], mesh: Mesh,
               non_blocking: bool = False) -> List[Any]:
    """A tensor (or a dict of tensors, numpy arrays become tensors) split by
    rows into ``len(mesh)`` equal chunks, chunk i on ``mesh[i]``."""
    if isinstance(batch, Mapping):
        per_key = {k: split_rows(v, mesh, non_blocking) for k, v in batch.items()}
        return [{k: chunks[i] for k, chunks in per_key.items()} for i in range(len(mesh))]
    t = torch.as_tensor(batch)
    rows = t.shape[0]
    return [t[rank_rows(rows, i, len(mesh))].to(dev, non_blocking=non_blocking) for i, dev in enumerate(mesh)]


def gather_rows(chunks: Sequence[Union[torch.Tensor, Mapping[str, torch.Tensor]]],
                device: Optional[torch.device] = None) -> Any:
    """Chunks of rows (tensors, or dicts of tensors) concatenated on `device`
    (default: the first chunk's device)."""
    first = chunks[0]
    if isinstance(first, Mapping):
        return {k: gather_rows([c[k] for c in chunks], device) for k in first}
    device = device if device is not None else first.device
    return torch.cat([c.to(device) for c in chunks])


def canonical_device(device: Union[str, torch.device]) -> torch.device:
    """`device` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_scope(device: Union[str, torch.device]):
    """A context in which `device` is the current card (a null context off
    the card): the kernels' launchers launch on the current device, so work
    for one device of a list runs under its scope."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def replicas(model: torch.nn.Module, mesh: Mesh, cache: Optional[Dict] = None) -> List[torch.nn.Module]:
    """One copy of `model` per device of `mesh` (the model itself on its own
    device; one copy a distinct device). With `cache` (a dict kept by the
    caller), copies are made once and refreshed only when a parameter or
    buffer of `model` changed in place since (its version counter moved)."""
    home = next(model.parameters()).device
    key = tuple(t._version for t in (*model.parameters(), *model.buffers()))
    cache = {} if cache is None else cache
    if cache.get("key") != key or cache.get("model") is not model:
        cache.clear()
        cache.update(key=key, model=model, copies={})
    copies = cache["copies"]
    out = []
    for dev in mesh:
        dev = canonical_device(dev)
        if dev == home:
            out.append(model)
            continue
        if dev not in copies:
            copies[dev] = copy.deepcopy(model).to(dev)
        out.append(copies[dev])
    return out
