"""nuScenes open-loop planning metrics: L2 displacement + collision rate
(counterpart of `diffusiondrive_tpu/evaluate/nuscenes_metrics.py`, in torch).

Parity target: the reference's nuScenes evaluation protocol (`README.md:86`:
L2 avg over 1s/2s/3s and collision %, ST-P3 convention — metrics averaged
over the horizon prefix at each marker). The planner predicts 6 poses at
0.5 s on nuScenes; collisions test the ego footprint against BEV occupancy
of other agents at each future step.

Batched: L2 is pure tensor math; collision uses the same padded
polygon-intersection primitive as the PDM scorer (`evaluate/geometry.py`).
`l2_displacement` and `collision_rate` compute on the device their tensors
come on; `evaluate_nuscenes` takes numpy arrays and runs on the card unless
`device="cpu"` is asked for.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.evaluate.geometry import polygons_intersect
from diffusiondrive_torch.evaluate.state_array import box_to_corners, get_pacifica_parameters


def l2_displacement(
    pred: torch.Tensor,     # (B, T, >=2) predicted poses (ego frame)
    target: torch.Tensor,   # (B, T, >=2) GT poses
    horizons_s: Sequence[float] = (1.0, 2.0, 3.0),
    interval_s: float = 0.5,
    st_p3_average: bool = True,
) -> Dict[str, torch.Tensor]:
    """Per-horizon L2 [m]. With `st_p3_average` each marker averages the error
    over all steps up to that horizon (the convention behind 0.27/0.54/0.90)."""
    err = torch.linalg.vector_norm(pred[..., :2] - target[..., :2], dim=-1)  # (B, T)
    out = {}
    for h in horizons_s:
        idx = int(round(h / interval_s))
        if st_p3_average:
            out[f"l2_{h:.0f}s"] = err[:, :idx].mean(dim=-1)
        else:
            out[f"l2_{h:.0f}s"] = err[:, idx - 1]
    out["l2_avg"] = torch.stack([out[f"l2_{h:.0f}s"] for h in horizons_s], -1).mean(-1)
    return out


def collision_rate(
    pred: torch.Tensor,          # (B, T, 3) predicted ego poses (ego frame @ t=0)
    agent_boxes: torch.Tensor,   # (B, T, O, 5) future agent boxes (x,y,heading,l,w), ego frame
    agent_valid: torch.Tensor,   # (B, T, O) bool
    horizons_s: Sequence[float] = (1.0, 2.0, 3.0),
    interval_s: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Fraction of samples whose ego footprint hits any agent box within each
    horizon (cumulative, ST-P3 style); float32 per sample, as in JAX."""
    vehicle = get_pacifica_parameters()

    cx = pred[..., 0] + vehicle.rear_axle_to_center * torch.cos(pred[..., 2])
    cy = pred[..., 1] + vehicle.rear_axle_to_center * torch.sin(pred[..., 2])
    ego_corners = box_to_corners(cx, cy, pred[..., 2],
                                 torch.full_like(cx, vehicle.length), torch.full_like(cx, vehicle.width),
                                 xp=torch)                            # (B, T, 4, 2)
    agent_corners = box_to_corners(
        agent_boxes[..., 0], agent_boxes[..., 1], agent_boxes[..., 2],
        agent_boxes[..., 3], agent_boxes[..., 4], xp=torch,
    )                                                                 # (B, T, O, 4, 2)

    hits = polygons_intersect(ego_corners[:, :, None], agent_corners) & agent_valid  # (B, T, O)
    any_hit = hits.any(dim=-1)  # (B, T)

    out = {}
    for h in horizons_s:
        idx = int(round(h / interval_s))
        out[f"collision_{h:.0f}s"] = any_hit[:, :idx].any(dim=-1).to(torch.float32)
    out["collision_avg"] = torch.stack([out[f"collision_{h:.0f}s"] for h in horizons_s], -1).mean(-1)
    return out


def evaluate_nuscenes(
    pred_trajectories: np.ndarray,
    gt_trajectories: np.ndarray,
    agent_boxes: np.ndarray,
    agent_valid: np.ndarray,
    interval_s: float = 0.5,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, float]:
    """Aggregate L2 + collision metrics over a dataset (reference table format),
    computed on `device` and brought back as one transfer."""
    device = resolve_device(device)
    pred, gt, boxes, valid = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                              for a in (pred_trajectories, gt_trajectories, agent_boxes, agent_valid))
    l2 = l2_displacement(pred, gt, interval_s=interval_s)
    col = collision_rate(pred, boxes, valid, interval_s=interval_s)
    metrics = {**l2, **col}
    # each mean in its metric's dtype (the collision rates are float32, as in JAX)
    means = torch.stack([v.mean().to(torch.float64) for v in metrics.values()]).cpu().numpy()
    return {k: float(m) for k, m in zip(metrics, means)}
