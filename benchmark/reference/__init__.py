"""Plain PyTorch and NumPy reference of the benchmarked model (see `model.py`).

It imports nothing of the program under test: the benchmark hands it the
weights and inputs it made itself, and it works out everything else again.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from benchmark.reference.loss import AdamW, loss
from benchmark.reference.model import Draws, Net
from benchmark.reference.precision import Precision
from benchmark.reference.sensors import camera, lidar_bev

BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked", "plan_anchor")
# the training forward's outputs compared at the first step
OUTPUTS = ("poses_reg_layers", "poses_cls_layers", "agent_states", "agent_labels", "bev_semantic_map")


def is_parameter(name: str) -> bool:
    """Whether the weight `name` is trained (not a BatchNorm statistic or a constant)."""
    return not name.endswith(BUFFER_SUFFIXES)


def train(weights: Dict[str, torch.Tensor], cfg: dict, opt: dict, batches: Sequence[Dict[str, torch.Tensor]],
          generator_at: Callable[[int], torch.Generator], prec: Precision) -> dict:
    """The first `len(batches)` training steps from `weights`: each step's
    loss, the first step's `OUTPUTS`, each parameter's gradient at step 1
    (on the host) and its norm, and each parameter's change over all the
    steps (norms, by name).
    `generator_at(step)` gives the generator that feeds step `step`'s draws."""
    W = {k: v.detach().float().clone() for k, v in weights.items()}
    params = {k: v.requires_grad_() for k, v in W.items() if is_parameter(k)}
    start = {k: v.detach().clone() for k, v in params.items()}
    adam = AdamW(params, opt)
    losses: List[float] = []
    grads: Dict[str, torch.Tensor] = {}
    for step, batch in enumerate(batches):
        for p in params.values():
            p.grad = None
        net = Net(W, cfg, prec, train=True, draws=Draws(generator_at(step)))
        cam = batch["camera_feature"]
        cam = cam.float() / 255.0 if cam.dtype == torch.uint8 else cam.float()
        out = net(cam, batch["lidar_feature"].float(), batch["status_feature"].float())
        terms = loss(out, batch, cfg)
        terms["loss"].backward()
        losses.append(float(terms["loss"].detach()))
        if step == 0:
            grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu() for k, p in params.items()}
            first = {k: out[k].detach().float().cpu() for k in OUTPUTS}
        adam.step()
        del out, terms, net
    change = {k: float(torch.linalg.vector_norm(p.detach() - start[k])) for k, p in params.items()}
    grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    return {"losses": losses, "outputs": first, "grads": grads, "grad_norms": grad_norms, "change_norms": change}


@torch.no_grad()
def predict(weights: Dict[str, torch.Tensor], cfg: dict, inputs: Dict[str, torch.Tensor], noise: torch.Tensor,
            prec: Precision, rows: int = 32) -> Dict[str, torch.Tensor]:
    """The eval forward on raw sensors in blocks of `rows` scenes: the
    truncated-diffusion head's trajectory, every mode's poses and scores."""
    W = {k: v.float() for k, v in weights.items()}
    keys = ("trajectory", "poses_reg", "poses_cls")
    parts: Dict[str, list] = {k: [] for k in keys}
    B = inputs["status_feature"].shape[0]
    for s in range(0, B, rows):
        sl = slice(s, min(s + rows, B))
        cam = camera(inputs["camera_l0"][sl], inputs["camera_f0"][sl], inputs["camera_r0"][sl], cfg)
        bev = lidar_bev(inputs["lidar_points"][sl], inputs["lidar_valid"][sl], cfg)
        out = Net(W, cfg, prec, train=False, draws=Draws(noise=noise[sl].float()))(
            cam, bev, inputs["status_feature"][sl].float())
        for k in keys:
            parts[k].append(out[k].float())
    return {k: torch.cat(v) for k, v in parts.items()}
