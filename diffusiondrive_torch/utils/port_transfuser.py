"""Full DiffusionDrive (V2TransfuserModel) checkpoint -> the port's weights.

Copy of `diffusiondrive_tpu/utils/port_transfuser.py`: maps the torch module
tree of the reference model (`transfuser_model_v2.py:19-641`,
`transfuser_backbone.py`) onto the Flax-layout numpy tree, whose names the
port's modules carry; `utils/port_jax.py:jax_to_state_dict` then fills the
port's `state_dict` from it, strictly. So the published checkpoint format
(`.pth`/`.ckpt`, names after the 'agent.' prefix strip,
`transfuser_agent.py:59-106`) loads directly.
"""

from __future__ import annotations

from typing import Any, Dict

import torch.nn as nn

from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.utils.port_jax import jax_to_state_dict
from diffusiondrive_torch.utils.port_weights import (
    _np,
    load_torch_state_dict,
    port_backbone_encoder,
    port_conv,
    port_layernorm,
    port_linear,
    port_mha,
)


def _linear_relu_ln(sd, prefix: str, out_loops: int) -> Dict[str, Any]:
    """torch `linear_relu_ln(in_loops=1)` Sequential -> LinearReluLn params.
    Layout per out_loop: [Linear, ReLU, LayerNorm] => indices 3*o, 3*o+2."""
    out: Dict[str, Any] = {}
    for o in range(out_loops):
        out[f"dense_{o}_0"] = port_linear(sd, f"{prefix}.{3 * o}")
        out[f"ln_{o}"] = port_layernorm(sd, f"{prefix}.{3 * o + 2}")
    return out


def _gpt_fusion(sd, i: int, n_layer: int) -> Dict[str, Any]:
    """`_backbone.transformers.{i}` (GPT) -> fusion{i} params."""
    p = f"_backbone.transformers.{i}"
    out: Dict[str, Any] = {"pos_emb": _np(sd[f"{p}.pos_emb"])}
    for j in range(n_layer):
        b = f"{p}.blocks.{j}"
        out[f"block{j}"] = {
            "ln1": port_layernorm(sd, f"{b}.ln1"),
            "ln2": port_layernorm(sd, f"{b}.ln2"),
            "attn": {
                "query": port_linear(sd, f"{b}.attn.query"),
                "key": port_linear(sd, f"{b}.attn.key"),
                "value": port_linear(sd, f"{b}.attn.value"),
                "proj": port_linear(sd, f"{b}.attn.proj"),
            },
            "mlp_fc1": port_linear(sd, f"{b}.mlp.0"),
            "mlp_fc2": port_linear(sd, f"{b}.mlp.2"),
        }
    out["ln_f"] = port_layernorm(sd, f"{p}.ln_f")
    return out


def _tf_decoder_layer(sd, prefix: str, d_model: int) -> Dict[str, Any]:
    """torch nn.TransformerDecoderLayer -> our TransformerDecoderLayer."""
    return {
        "self_attn": port_mha(sd, f"{prefix}.self_attn", d_model),
        "cross_attn": port_mha(sd, f"{prefix}.multihead_attn", d_model),
        "linear1": port_linear(sd, f"{prefix}.linear1"),
        "linear2": port_linear(sd, f"{prefix}.linear2"),
        "norm1": port_layernorm(sd, f"{prefix}.norm1"),
        "norm2": port_layernorm(sd, f"{prefix}.norm2"),
        "norm3": port_layernorm(sd, f"{prefix}.norm3"),
    }


def _diff_decoder_layer(sd, prefix: str, d_model: int) -> Dict[str, Any]:
    """`CustomTransformerDecoderLayer` -> DiffusionDecoderLayer params."""
    return {
        "cross_bev": {
            "attention_weights": port_linear(sd, f"{prefix}.cross_bev_attention.attention_weights"),
            "output_proj": port_linear(sd, f"{prefix}.cross_bev_attention.output_proj"),
            "value_conv": port_conv(sd, f"{prefix}.cross_bev_attention.value_proj.0"),
        },
        "cross_agent": port_mha(sd, f"{prefix}.cross_agent_attention", d_model),
        "cross_ego": port_mha(sd, f"{prefix}.cross_ego_attention", d_model),
        "ffn_fc1": port_linear(sd, f"{prefix}.ffn.0"),
        "ffn_fc2": port_linear(sd, f"{prefix}.ffn.2"),
        "norm1": port_layernorm(sd, f"{prefix}.norm1"),
        "norm2": port_layernorm(sd, f"{prefix}.norm2"),
        "norm3": port_layernorm(sd, f"{prefix}.norm3"),
        "time_modulation": {"scale_shift": port_linear(sd, f"{prefix}.time_modulation.scale_shift_mlp.1")},
        "task_decoder": {
            "cls_ln": _linear_relu_ln(sd, f"{prefix}.task_decoder.plan_cls_branch", out_loops=2),
            "cls_out": port_linear(sd, f"{prefix}.task_decoder.plan_cls_branch.6"),
            "reg_fc1": port_linear(sd, f"{prefix}.task_decoder.plan_reg_branch.0"),
            "reg_fc2": port_linear(sd, f"{prefix}.task_decoder.plan_reg_branch.2"),
            "reg_out": port_linear(sd, f"{prefix}.task_decoder.plan_reg_branch.4"),
        },
    }


def port_transfuser_checkpoint(
    sd: Dict[str, Any], config: TransfuserConfig = None
) -> Dict[str, Any]:
    """torch state dict (agent.-stripped) -> {'params', 'batch_stats', 'constants'}."""
    config = config or TransfuserConfig()
    d = config.tf_d_model

    # --- backbone -------------------------------------------------------- #
    bb_params: Dict[str, Any] = {}
    bb_stats: Dict[str, Any] = {}
    for torch_prefix, flax_prefix, arch in (
        ("_backbone.image_encoder.", "image_encoder", config.image_architecture),
        ("_backbone.lidar_encoder.", "lidar_encoder", config.lidar_architecture),
    ):
        p, s = port_backbone_encoder(sd, arch, torch_prefix, flax_prefix)
        bb_params.update(p)
        bb_stats.update(s)
    for i in range(4):
        bb_params[f"fusion{i}"] = _gpt_fusion(sd, i, config.n_layer)
        bb_params[f"lidar_to_img{i}"] = port_conv(sd, f"_backbone.lidar_channel_to_img.{i}")
        bb_params[f"img_to_lidar{i}"] = port_conv(sd, f"_backbone.img_channel_to_lidar.{i}")
    bb_params["c5_conv"] = port_conv(sd, "_backbone.c5_conv")
    bb_params["up_conv5"] = port_conv(sd, "_backbone.up_conv5")
    bb_params["up_conv4"] = port_conv(sd, "_backbone.up_conv4")

    # --- trajectory head -------------------------------------------------- #
    th: Dict[str, Any] = {
        "anchor_encoder_ln": _linear_relu_ln(sd, "_trajectory_head.plan_anchor_encoder", out_loops=1),
        "anchor_encoder_out": port_linear(sd, "_trajectory_head.plan_anchor_encoder.3"),
        "time_fc1": port_linear(sd, "_trajectory_head.time_mlp.1"),
        "time_fc2": port_linear(sd, "_trajectory_head.time_mlp.3"),
    }
    for i in range(config.diff_decoder_layers):
        th[f"layer{i}"] = _diff_decoder_layer(sd, f"_trajectory_head.diff_decoder.layers.{i}", d)

    params: Dict[str, Any] = {
        "backbone": bb_params,
        "bev_downscale": port_conv(sd, "_bev_downscale"),
        "status_encoding": port_linear(sd, "_status_encoding"),
        "keyval_embedding": _np(sd["_keyval_embedding.weight"]),
        "query_embedding": _np(sd["_query_embedding.weight"]),
        "bev_proj": _linear_relu_ln(sd, "bev_proj", out_loops=1),
        "bev_semantic_conv1": port_conv(sd, "_bev_semantic_head.0"),
        "bev_semantic_conv2": port_conv(sd, "_bev_semantic_head.2"),
        "tf_decoder": {
            f"layer{i}": _tf_decoder_layer(sd, f"_tf_decoder.layers.{i}", d)
            for i in range(config.tf_num_layers)
        },
        "agent_head": {
            "states_fc1": port_linear(sd, "_agent_head._mlp_states.0"),
            "states_fc2": port_linear(sd, "_agent_head._mlp_states.2"),
            "label_fc": port_linear(sd, "_agent_head._mlp_label.0"),
        },
        "trajectory_head": th,
    }

    return {
        "params": params,
        "batch_stats": {"backbone": bb_stats},
        "constants": {"trajectory_head": {"plan_anchor": _np(sd["_trajectory_head.plan_anchor"])}},
    }


def load_transfuser_checkpoint(path: str, config: TransfuserConfig = None) -> Dict[str, Any]:
    """torch .ckpt/.pth -> Flax-layout variables (lightning unwrap + prefix strip)."""
    return port_transfuser_checkpoint(load_torch_state_dict(path), config)


def load_transfuser_state_dict(path: str, model: nn.Module) -> Dict[str, Any]:
    """torch .ckpt/.pth -> a complete `state_dict` for the port's `model`; strict."""
    return jax_to_state_dict(load_transfuser_checkpoint(path, model.config), model)
