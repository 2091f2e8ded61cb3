"""Create a submission pickle of {token: Trajectory} + team metadata.

Counterpart of `diffusiondrive_tpu/script/run_create_submission_pickle.py`
(navsim's `run_create_submission_pickle.py`). The agent runs on `--device`
(default: the current CUDA device; it raises without one unless `--device
cpu` is given). The pickle holds the port's `Trajectory` and
`TrajectorySampling`; the JAX package's readers take it as well.
"""

from __future__ import annotations

import argparse
import logging
import pickle
import traceback
from pathlib import Path
from typing import Dict, Optional, Sequence

from diffusiondrive_torch.common.dataclasses import Trajectory
from diffusiondrive_torch.common.dataloader import SceneLoader
from diffusiondrive_torch.config.registry import agent_from_config, load_split, scene_filter_from_split
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.script.cli_common import add_common_args, resolve_run_config, snapshot_config

logger = logging.getLogger(__name__)

TEAM_FIELDS = ("team_name", "authors", "email", "institution", "country")


def run_test_evaluation(agent, scene_loader) -> Dict[str, Trajectory]:
    """Per-token trajectories, a failing token logged and left out."""
    if agent.requires_scene:
        raise ValueError("Submission agents cannot require privileged scenes.")
    agent.initialize()
    output: Dict[str, Trajectory] = {}
    for token in scene_loader.tokens:
        try:
            agent_input = scene_loader.get_agent_input_from_token(token)
            output[token] = agent.compute_trajectory(agent_input)
        except Exception:  # noqa: BLE001 — per-token quarantine, as the reference
            logger.error("Token %s failed:\n%s", token, traceback.format_exc())
    return output


def main(argv: Optional[Sequence[str]] = None) -> Path:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_args(parser, default_agent="diffusiondrive_agent")
    for field in TEAM_FIELDS:
        parser.add_argument(f"--{field.replace('_', '-')}", default=None)
    args = parser.parse_args(argv)

    cfg = resolve_run_config(args)
    for field in TEAM_FIELDS:
        if getattr(args, field, None):
            cfg[field] = getattr(args, field)
        if not cfg.get(field):
            parser.error(f"--{field.replace('_', '-')} (or {field} in --config) is required")
    snapshot_config(cfg, Path(cfg["output_dir"]))

    agent = agent_from_config(cfg["agent"], device=resolve_device(cfg.get("device")))
    split = load_split(cfg.get("split"))
    scene_loader = SceneLoader(
        Path(cfg["navsim_log_path"]),
        Path(cfg["sensor_blobs_path"]) if cfg.get("sensor_blobs_path") else None,
        scene_filter_from_split(split),
        agent.get_sensor_config(),
        build_map_api=False,
    )
    predictions = run_test_evaluation(agent, scene_loader)
    submission = {**{field: cfg[field] for field in TEAM_FIELDS}, "predictions": [predictions]}
    out = Path(cfg["output_dir"])
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "submission.pkl", "wb") as fp:
        pickle.dump(submission, fp)
    logger.info("Wrote %d predictions to %s", len(predictions), out / "submission.pkl")
    return out / "submission.pkl"


if __name__ == "__main__":
    main()
