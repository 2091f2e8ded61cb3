"""Shared CLI plumbing for the port's `run_*` entry points.

Copy of `diffusiondrive_tpu/script/cli_common.py`, plus `--device`. Every
entry point accepts the same two operating modes:
- legacy flags (`--agent ... --split ...`), or
- `--config <name|path>` + positional `key=value` / `group=name` overrides,
  composed by `config/compose.py` from the layered `configs/` tree.

The resolved config dict is snapshotted to `<output_dir>/config.yaml`, so any
run is reproducible with `--config <snapshot>` and nothing else.
`load_submission` reads a submission pickle of either package.
`--device` (or `device` in a config) picks the torch device; without it an
entry point runs on the current CUDA device and raises when there is none.
"""

from __future__ import annotations

import argparse
import os
import pickle
from pathlib import Path

from diffusiondrive_torch.config.registry import load_yaml


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device, e.g. cpu or cuda:1 (default: the current CUDA device)")


def add_common_args(parser: argparse.ArgumentParser, default_agent: str = "constant_velocity_agent") -> None:
    parser.add_argument("--config", default=None,
                        help="composed config (name under configs/ or a YAML path); "
                             "positional key=value / group=name overrides apply to it")
    parser.add_argument("--navsim-log-path", default=os.environ.get("OPENSCENE_DATA_ROOT"))
    parser.add_argument("--sensor-blobs-path", default=os.environ.get("OPENSCENE_SENSOR_ROOT"))
    parser.add_argument("--split", default=None, help="split name in splits/ or a YAML path")
    parser.add_argument("--output-dir", default=os.environ.get("NAVSIM_EXP_ROOT", "exp"))
    parser.add_argument("--agent", default=default_agent)
    parser.add_argument("--agent-config", default=None, help="YAML of agent kwargs")
    parser.add_argument("--host-id", type=int, default=int(os.environ.get("HOST_ID", 0)))
    parser.add_argument("--num-hosts", type=int, default=int(os.environ.get("NUM_HOSTS", 1)))
    add_device_arg(parser)
    parser.add_argument("overrides", nargs="*", default=[],
                        help="config overrides (with --config)")


def resolve_run_config(args: argparse.Namespace) -> dict:
    """Run settings: composed config (+ overrides) when --config is given,
    else the legacy flags mapped onto the same keys. `--device` applies in
    both modes."""
    from diffusiondrive_torch.config.compose import compose

    if args.config:
        cfg = compose(args.config, args.overrides)
        if getattr(args, "device", None):
            cfg["device"] = args.device
        return cfg
    cfg = {k: v for k, v in vars(args).items() if k not in ("config", "overrides")}
    if hasattr(args, "agent"):
        cfg["agent"] = {"name": args.agent, **load_yaml(getattr(args, "agent_config", None))}
        cfg.pop("agent_config", None)
    return cfg


def snapshot_config(config: dict, output_dir: Path) -> None:
    """Persist the resolved run config (hydra snapshot parity)."""
    from diffusiondrive_torch.config.compose import snapshot

    snapshot(config, Path(output_dir))


# The JAX package's classes a submission pickle may hold, read as the port's.
_SUBMISSION_CLASSES = {
    ("diffusiondrive_tpu.common.dataclasses", "Trajectory"): "Trajectory",
    ("diffusiondrive_tpu.common.dataclasses", "TrajectorySampling"): "TrajectorySampling",
}


class SubmissionUnpickler(pickle.Unpickler):
    """Reads a submission pickle written by either package without importing
    the JAX package: its `Trajectory` and `TrajectorySampling` become the
    port's classes; any other class of the JAX package is refused."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "diffusiondrive_tpu":
            if (module, name) not in _SUBMISSION_CLASSES:
                raise pickle.UnpicklingError(f"submission holds {module}.{name}, which the port does not read")
            from diffusiondrive_torch.common import dataclasses

            return getattr(dataclasses, _SUBMISSION_CLASSES[(module, name)])
        return super().find_class(module, name)


def load_submission(path) -> dict:
    """A submission pickle ({team fields..., "predictions": [{token: Trajectory}]}).
    Unpickling runs code: read only submissions from a trusted source."""
    with open(path, "rb") as fp:
        return SubmissionUnpickler(fp).load()
