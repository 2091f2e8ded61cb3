"""The port's agent registry (counterpart of `diffusiondrive_tpu/config/registry.py`).

Agents register under the JAX package's names; entry points build them from
a name and a kwargs dict (a composed config group). The names are JAX's
`available_agents()`:

- `constant_velocity_agent`, `human_agent` and `ego_status_mlp_agent` build
  the port's agents;
- `diffusiondrive_agent` builds the port's `DiffusionDriveAgent`: a
  `config` mapping becomes a `TransfuserConfig`, a YAML `dtype` string
  ("bfloat16", "float32") a torch dtype, `trajectory_head_type` ("diffusion",
  "unet", "mlp") passes through; the others are it with JAX's settings:
  `transfuser_agent` (the Transfuser baseline's MLP head),
  `diffusion_policy_agent` (the diffusion-policy UNet head),
  `diffusiondrive_vanilla_ddim_agent` (the 20-step DDIM ablation,
  `diffusion_test_steps=20`) and `diffusiondrive_nuscenes_agent` (ResNet-50
  encoders, 6 poses at 0.5 s, where the config leaves them unset).

`device=` passes through to the agents that own a model; the others run on
the host and take none. A checkpoint the port cannot read (an orbax
directory of the JAX package) raises and says how to convert it.
`load_split` and `scene_filter_from_split` are copies.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

_AGENTS: Dict[str, Callable[..., Any]] = {}

REPO_SPLIT_ROOT = Path(__file__).resolve().parents[2] / "splits"

ORBAX_NOT_READ = ("is not a checkpoint the port reads (an orbax checkpoint of the JAX package?): "
                  "convert its variables with diffusiondrive_torch/utils/port_jax.py "
                  "(load_jax_variables) and save them with torch.save")


def register_agent(name: str):
    def wrap(factory):
        _AGENTS[name] = factory
        return factory

    return wrap


def available_agents():
    _ensure_builtins()
    return sorted(_AGENTS)


def build_agent(name: str, **kwargs):
    _ensure_builtins()
    if name not in _AGENTS:
        raise KeyError(f"Unknown agent '{name}'. Available: {available_agents()}")
    return _AGENTS[name](**kwargs)


def check_checkpoint(path: Optional[str]) -> None:
    """Raise for a checkpoint path the port cannot read: a directory that
    is not a `Trainer` checkpoint (no `state.pt`), as orbax writes."""
    if path and Path(path).is_dir() and not (Path(path) / "state.pt").exists():
        raise ValueError(f"checkpoint {path} {ORBAX_NOT_READ}")


def _host_agent(cls):
    """A host-only agent: `device` is accepted and unused."""

    def factory(device=None, **kwargs):
        return cls(**kwargs)

    return factory


def _ensure_builtins() -> None:
    """Register the built-in agents lazily (avoids import cycles)."""
    if _AGENTS:
        return
    from diffusiondrive_torch.agents.constant_velocity_agent import ConstantVelocityAgent
    from diffusiondrive_torch.agents.ego_status_mlp_agent import EgoStatusMLPAgent
    from diffusiondrive_torch.agents.human_agent import HumanAgent

    _AGENTS.setdefault("constant_velocity_agent", _host_agent(ConstantVelocityAgent))
    _AGENTS.setdefault("human_agent", _host_agent(HumanAgent))

    def _ego_status_mlp(**kwargs):
        check_checkpoint(kwargs.get("checkpoint_path"))
        return EgoStatusMLPAgent(**kwargs)

    def _diffusiondrive(**kwargs):
        from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
        from diffusiondrive_torch.models.config import TransfuserConfig

        config_kwargs = kwargs.pop("config", {}) or {}
        if isinstance(kwargs.get("dtype"), str):
            # YAML configs name the compute dtype as a string ("bfloat16",
            # "float32"); parameters stay float32 either way (mixed precision)
            kwargs["dtype"] = getattr(torch, kwargs["dtype"])
        check_checkpoint(kwargs.get("checkpoint_path"))
        return DiffusionDriveAgent(config=TransfuserConfig(**config_kwargs), **kwargs)

    def _transfuser(**kwargs):
        return _diffusiondrive(trajectory_head_type="mlp", **kwargs)

    def _vanilla_ddim(**kwargs):
        # ablation: 20-step full DDIM rollout (vs the 2-step truncated one)
        config_kwargs = dict(kwargs.pop("config", {}) or {})
        config_kwargs.setdefault("diffusion_test_steps", 20)
        return _diffusiondrive(config=config_kwargs, **kwargs)

    def _diffusiondrive_nuscenes(**kwargs):
        # nuScenes variant: ResNet-50 encoders, 6-pose horizon at 0.5 s
        from diffusiondrive_torch.common.dataclasses import TrajectorySampling

        config_kwargs = dict(kwargs.pop("config", {}) or {})
        config_kwargs.setdefault("image_architecture", "resnet50")
        config_kwargs.setdefault("lidar_architecture", "resnet50")
        config_kwargs.setdefault("trajectory_sampling", TrajectorySampling(time_horizon=3, interval_length=0.5))
        return _diffusiondrive(config=config_kwargs, **kwargs)

    def _diffusion_policy(**kwargs):
        # ablation: the diffusion-policy UNet head, full-range training noise,
        # 20-step DDIM from pure noise
        return _diffusiondrive(trajectory_head_type="unet", **kwargs)

    _AGENTS.setdefault("ego_status_mlp_agent", _ego_status_mlp)
    _AGENTS.setdefault("diffusiondrive_agent", _diffusiondrive)
    _AGENTS.setdefault("transfuser_agent", _transfuser)
    _AGENTS.setdefault("diffusion_policy_agent", _diffusion_policy)
    _AGENTS.setdefault("diffusiondrive_vanilla_ddim_agent", _vanilla_ddim)
    _AGENTS.setdefault("diffusiondrive_nuscenes_agent", _diffusiondrive_nuscenes)


def agent_from_config(agent_cfg: Dict[str, Any], device: Optional[str] = None):
    """Build an agent from a composed config group: {name: ..., **kwargs}."""
    kwargs = dict(agent_cfg)
    name = kwargs.pop("name")
    return build_agent(name, device=device, **kwargs)


def load_yaml(path: Optional[str]) -> Dict[str, Any]:
    if not path:
        return {}
    import yaml

    with open(path) as fp:
        return yaml.safe_load(fp) or {}


def load_split(path: Optional[str]) -> Dict[str, Any]:
    """Load a train/test split YAML (see `splits/`): scene-filter fields plus
    optional log_names/tokens lists and the OpenScene `data_split` subdir.
    A bare name (e.g. "navtest") resolves against the repo's `splits/`."""
    if path and not str(path).endswith((".yaml", ".yml")):
        candidate = REPO_SPLIT_ROOT / f"{path}.yaml"
        if candidate.exists():
            path = str(candidate)
    data = load_yaml(path)
    return {
        "log_names": data.get("log_names"),
        "tokens": data.get("tokens"),
        "data_split": data.get("data_split"),
        "num_history_frames": data.get("num_history_frames", 4),
        "num_future_frames": data.get("num_future_frames", 10),
        "frame_interval": data.get("frame_interval"),
        "has_route": data.get("has_route", True),
        "max_scenes": data.get("max_scenes"),
    }


def scene_filter_from_split(split: Dict[str, Any]):
    """SceneFilter from a loaded split dict."""
    from diffusiondrive_torch.common.dataclasses import SceneFilter

    return SceneFilter(
        num_history_frames=split.get("num_history_frames", 4),
        num_future_frames=split.get("num_future_frames", 10),
        frame_interval=split.get("frame_interval"),
        has_route=split.get("has_route", True),
        max_scenes=split.get("max_scenes"),
        log_names=split.get("log_names"),
        tokens=split.get("tokens"),
    )
