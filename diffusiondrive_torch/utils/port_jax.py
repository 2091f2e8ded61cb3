"""Carry the JAX package's weights across to the port.

The port's modules carry the Flax scope names, so a Flax variable tree
(``{"params", "batch_stats", "constants"}`` of numpy arrays, e.g. from
`DiffusionDriveModel.init` or an orbax checkpoint) maps onto the port's
`state_dict` by a mechanical walk:

- conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` (in, out) ->
  Linear ``weight`` (out, in); ``bias`` -> ``bias``;
- BatchNorm / LayerNorm ``scale`` -> ``weight``; BatchNorm ``mean``/``var``
  -> ``running_mean``/``running_var``;
- free parameters (``pos_emb``, ``keyval_embedding``, ``query_embedding``)
  and constants (``plan_anchor``) keep their names.

The walk is strict: every Flax leaf must land on a port tensor of the same
shape and every port tensor must be filled, or it raises. BatchNorm's
``num_batches_tracked`` counter has no Flax counterpart and is set to 0.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _convert(collection: str, path: Tuple[str, ...], leaf: Any) -> Tuple[str, torch.Tensor]:
    arr = torch.from_numpy(np.array(leaf, dtype=np.float32))
    *scope, name = path
    if collection == "params":
        if name == "kernel":
            if arr.dim() == 4:
                arr = arr.permute(3, 2, 0, 1)
            elif arr.dim() == 2:
                arr = arr.t()
            else:
                raise ValueError(f"unexpected kernel rank {arr.dim()} at {'/'.join(path)}")
            name = "weight"
        elif name == "scale":
            name = "weight"
    elif collection == "batch_stats":
        if name not in _BN_STATS:
            raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
        name = _BN_STATS[name]
    elif collection != "constants":
        raise ValueError(f"unexpected variable collection {collection!r}")
    return ".".join(scope + [name]), arr.contiguous()


def jax_to_state_dict(variables: Mapping[str, Mapping], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert Flax `variables` into a complete `state_dict` for `model`; strict."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            key, tensor = _convert(collection, path, leaf)
            if key not in target:
                raise KeyError(f"Flax leaf {collection}/{'/'.join(path)} has no port tensor {key!r}")
            if tuple(tensor.shape) != tuple(target[key].shape):
                raise ValueError(f"{key}: Flax shape {tuple(tensor.shape)} != port shape "
                                 f"{tuple(target[key].shape)}")
            out[key] = tensor
    for key, value in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(value)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} port tensors have no Flax leaf, e.g. {missing[:5]}")
    return out


def load_jax_variables(model: nn.Module, variables: Mapping[str, Mapping]) -> nn.Module:
    """Fill `model` in place from Flax `variables` (strict) and return it."""
    model.load_state_dict(jax_to_state_dict(variables, model), strict=True)
    return model
