"""Reference-layout torch state dict -> Flax-layout numpy tree: the helpers.

Copies of the helpers of `diffusiondrive_tpu/utils/port_weights.py` that the
full-checkpoint converter (`utils/port_transfuser.py`) uses. numpy only;
`utils/port_jax.py` then turns the tree into the port's `state_dict`.

Conventions:
- torch conv weight (O, I, kH, kW) -> flax kernel (kH, kW, I, O)
- torch linear weight (O, I)       -> flax kernel (I, O)
- BatchNorm weight/bias -> params scale/bias; running stats -> batch_stats
- torch nn.MultiheadAttention in_proj (3E, E) -> split q/k/v kernels
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def _np(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def conv_kernel(w) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def linear_kernel(w) -> np.ndarray:
    return _np(w).T


def port_batchnorm(sd: Dict[str, Any], prefix: str) -> Tuple[Dict, Dict]:
    """-> (params {scale, bias}, batch_stats {mean, var})."""
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def port_mha(sd: Dict[str, Any], prefix: str, d_model: int) -> Dict[str, Any]:
    """torch nn.MultiheadAttention -> MultiHeadAttention params."""
    in_w = _np(sd[f"{prefix}.in_proj_weight"])   # (3E, E)
    in_b = _np(sd[f"{prefix}.in_proj_bias"])     # (3E,)
    qw, kw, vw = np.split(in_w, 3, axis=0)
    qb, kb, vb = np.split(in_b, 3, axis=0)
    return {
        "q_proj": {"kernel": qw.T, "bias": qb},
        "k_proj": {"kernel": kw.T, "bias": kb},
        "v_proj": {"kernel": vw.T, "bias": vb},
        "out_proj": {
            "kernel": linear_kernel(sd[f"{prefix}.out_proj.weight"]),
            "bias": _np(sd[f"{prefix}.out_proj.bias"]),
        },
    }


def port_linear(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    out = {"kernel": linear_kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def port_conv(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    out = {"kernel": conv_kernel(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def port_layernorm(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def port_resnet_stem(sd: Dict[str, Any], prefix: str = "") -> Tuple[Dict, Dict]:
    """-> (params, batch_stats) for `ResNetStem` (conv1 + bn1)."""
    bn_p, bn_s = port_batchnorm(sd, f"{prefix}bn1")
    return {"conv1": port_conv(sd, f"{prefix}conv1"), "bn1": bn_p}, {"bn1": bn_s}


def port_resnet_block(sd: Dict[str, Any], prefix: str, bottleneck: bool = False) -> Tuple[Dict, Dict]:
    """One BasicBlock/Bottleneck `<prefix>.convN/bnN[/downsample]`."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(1, (3 if bottleneck else 2) + 1):
        params[f"conv{i}"] = port_conv(sd, f"{prefix}.conv{i}")
        params[f"bn{i}"], stats[f"bn{i}"] = port_batchnorm(sd, f"{prefix}.bn{i}")
    if f"{prefix}.downsample.0.weight" in sd:
        params["downsample_conv"] = port_conv(sd, f"{prefix}.downsample.0")
        params["downsample_bn"], stats["downsample_bn"] = port_batchnorm(sd, f"{prefix}.downsample.1")
    return params, stats


def port_resnet_stage(sd: Dict[str, Any], prefix: str, num_blocks: int,
                      bottleneck: bool = False) -> Tuple[Dict, Dict]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for b in range(num_blocks):
        params[f"block{b}"], stats[f"block{b}"] = port_resnet_block(sd, f"{prefix}.{b}", bottleneck)
    return params, stats


RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3)}


def port_backbone_encoder(sd: Dict[str, Any], architecture: str, torch_prefix: str,
                          flax_prefix: str) -> Tuple[Dict, Dict]:
    """A ResNet encoder branch inside `TransfuserBackbone` (flat naming:
    `<flax_prefix>_stem`, `<flax_prefix>_layer{i}`)."""
    bottleneck = architecture == "resnet50"
    stem_p, stem_s = port_resnet_stem(sd, torch_prefix)
    params = {f"{flax_prefix}_stem": stem_p}
    stats = {f"{flax_prefix}_stem": stem_s}
    for i, n in enumerate(RESNET_STAGES[architecture]):
        p, s = port_resnet_stage(sd, f"{torch_prefix}layer{i + 1}", n, bottleneck)
        params[f"{flax_prefix}_layer{i + 1}"] = p
        stats[f"{flax_prefix}_layer{i + 1}"] = s
    return params, stats


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a torch checkpoint (lightning 'state_dict' unwrapped, 'agent.'
    prefix stripped — `transfuser_agent.py:59-106`)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k.replace("agent.", "", 1) if k.startswith("agent.") else k: v for k, v in sd.items()}
