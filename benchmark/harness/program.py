"""The benchmark's handle on the program under test: the registry's agent
with the benchmark's weights, its configuration as run, and the trainer.

This is the only module of the harness that imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def build_agent(doc: dict, device: torch.device, preprocess_on_device: bool = False):
    """The configuration file's registry agent, built and initialised on `device`."""
    from diffusiondrive_torch.config.registry import build_agent as registry_build

    agent = registry_build(doc["agent"], device=str(device), preprocess_on_device=preprocess_on_device,
                           **doc["agent_kwargs"])
    agent.initialize()
    return agent


def config_as_run(agent) -> dict:
    """The agent's `TransfuserConfig` as a flat dict, the trajectory sampling
    as `num_poses`, `time_horizon` and `interval_length`."""
    cfg = agent.config
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "trajectory_sampling":
            out["num_poses"] = int(v.num_poses)
            out["time_horizon"] = float(v.time_horizon)
            out["interval_length"] = float(v.interval_length)
        else:
            out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def weight_specs(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def make_trainer(agent, optimizer: dict, seed: int):
    """(`Trainer` over the agent's model with the configuration file's
    AdamW settings, those settings as the trainer holds them)."""
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    opt = OptimizerConfig(**optimizer)
    return Trainer(agent.model, agent.config, opt, seed=seed), dataclasses.asdict(opt)


def kernel_launch_counters() -> Dict[str, int]:
    """The hand-written kernels' wrapper counters (launches since import)."""
    from diffusiondrive_torch.ops.attention_fused import fused_attention, fused_attention_bwd
    from diffusiondrive_torch.ops.conv_fused import fused_conv3x3
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.ops.lidar_splat import histogram2d
    from diffusiondrive_torch.ops.stem_fused import fused_stem

    fns = {"stem": fused_stem, "conv3x3": fused_conv3x3, "attention_fwd": fused_attention,
           "attention_bwd": fused_attention_bwd, "lap": batched_linear_sum_assignment, "splat": histogram2d}
    return {k: int(getattr(f, "launches", 0)) for k, f in fns.items()}
