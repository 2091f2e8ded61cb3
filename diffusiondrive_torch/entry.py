"""Entry points: the planner and the raw-sensor agent, with seeded inputs.

`entry()` builds the full-width DiffusionDrive planner (default
`TransfuserConfig`: ResNet-34 branches, 256x1024 camera, 256x256 lidar BEV)
in eval mode with seeded random weights, plus example inputs, on CUDA unless
`device="cpu"` is passed; it is the port's counterpart of
`__graft_entry__.entry()`. `agent_entry()` builds the
`DiffusionDriveAgent` that preprocesses the raw sensors on the device, plus a
seeded `AgentInput` (`example_agent_input`), for
``agent.compute_trajectory(agent_input)``. Both take a `config` and a
`trajectory_head_type`, so every model variant of the registry is driven
through them (`VARIANTS`: the Transfuser baseline's MLP head, the
diffusion-policy UNet, the ResNet-50 nuScenes model, the 20-step
vanilla-DDIM ablation). `example_training_sample` and
`write_example_cache` make seeded feature/target pairs and a training cache
of them (the format `training/dataset.py` reads) for the training path;
`place_targets_at_predictions` makes a batch's detection assignment unique
for comparisons across devices or packages; `train_step_on` runs one
float32 or float64 train step of a copy of a model on a device and returns
what such a comparison reads (`grad_distances`, `output_distances`,
`gradient_limits`); `Kinks` records, compares or imposes the side a train
step's forward takes at each ReLU, |x| and max-pool, so that two steps'
gradients are compared on the same side of every kink.
"""

from __future__ import annotations

import contextlib
import copy
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from diffusiondrive_torch.common.dataclasses import (
    CAMERA_NAMES, AgentInput, Camera, Cameras, EgoStatus, Lidar)
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.layers import disable_dropout, flax_default_init_
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel


# the registry's model variants beyond `diffusiondrive_agent`
VARIANTS = ("diffusion_policy_agent", "diffusiondrive_nuscenes_agent", "diffusiondrive_vanilla_ddim_agent",
            "transfuser_agent")


def variant_config(name: str, **overrides) -> Tuple[str, TransfuserConfig]:
    """(trajectory head type, config) of the registry's DiffusionDrive agent
    `name` (one of `VARIANTS` or "diffusiondrive_agent"), as the registry
    builds it with `overrides` as its `config` mapping."""
    from diffusiondrive_torch.config.registry import build_agent

    agent = build_agent(name, config=overrides, device="cpu")
    return agent.trajectory_head_type, agent.config


def build_model(config: Optional[TransfuserConfig] = None, dtype: torch.dtype = torch.float32,
                seed: int = 0, trajectory_head_type: str = "diffusion") -> DiffusionDriveModel:
    """The planner on the CPU in eval mode, weights drawn from `seed`.

    The BatchNorm statistics are drawn too (mean ~ N(0, 0.3), var ~
    U(0.7, 1.5)), so that folding them into the kernels' affine is exercised.
    """
    gen = torch.Generator().manual_seed(seed)
    model = DiffusionDriveModel(config or TransfuserConfig(), trajectory_head_type, dtype=dtype)
    flax_default_init_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.7, 1.5, generator=gen)
    return model.eval()


def example_inputs(config: TransfuserConfig, batch: int, device: torch.device,
                   seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded uint8 camera, float lidar BEV and status on `device`."""
    gen = torch.Generator().manual_seed(seed)
    camera = torch.randint(0, 256, (batch, config.camera_height, config.camera_width, 3),
                           generator=gen, dtype=torch.uint8)
    lidar = torch.rand((batch, config.lidar_resolution_height, config.lidar_resolution_width,
                        config.lidar_in_channels), generator=gen)
    status = torch.randn((batch, 8), generator=gen)
    return {"camera_feature": camera.to(device), "lidar_feature": lidar.to(device),
            "status_feature": status.to(device)}


def entry(device: Optional[Union[str, torch.device]] = None, dtype: torch.dtype = torch.bfloat16,
          batch: int = 1, seed: int = 0, config: Optional[TransfuserConfig] = None,
          trajectory_head_type: str = "diffusion") -> Tuple[DiffusionDriveModel, Dict[str, torch.Tensor]]:
    """(model, example inputs) for the planner forward, on CUDA by default;
    `config` defaults to `TransfuserConfig()` (see `variant_config`).

    Raises without a GPU unless `device="cpu"` is passed. Call as
    ``with torch.no_grad(): model(**inputs)``.
    """
    device = resolve_device(device)
    config = config or TransfuserConfig()
    model = build_model(config, dtype=dtype, seed=seed, trajectory_head_type=trajectory_head_type).to(device)
    return model, example_inputs(config, batch, device, seed=seed + 1)


def example_point_cloud(rng: np.random.Generator, num_points: int,
                        config: Optional[TransfuserConfig] = None) -> np.ndarray:
    """A seeded (6, num_points) float32 cloud shaped like a lidar sweep.

    Ranges are exponential around the ego (scale 10 m), so most points lie
    within +-32 m and the bins next to the ego are hot; points are ordered
    by ring and azimuth, as a scan is, so neighbours share bins. Heights mix
    obstacles above the split plane, ground below it and a few returns above
    `max_height_lidar`. Some points sit exactly on the grid's outer edges
    (+-32.0) and on inner bin edges. Rows: x, y, z, intensity, ring, id.
    """
    cfg = config or TransfuserConfig()
    r = rng.exponential(10.0, num_points)
    phi = rng.uniform(-np.pi, np.pi, num_points)
    order = np.lexsort((phi, np.floor(r * 2.0)))
    r, phi = r[order], phi[order]
    x, y = r * np.cos(phi), r * np.sin(phi)
    kind = rng.uniform(size=num_points)
    z = np.where(kind < 0.65, rng.uniform(0.0, 3.0, num_points),             # straddles the split
                 np.where(kind < 0.95, rng.normal(-0.1, 0.1, num_points),     # ground
                          rng.uniform(cfg.max_height_lidar - 1.0, cfg.max_height_lidar + 50.0,
                                      num_points)))
    edge = rng.choice(num_points, size=max(num_points // 100, 8), replace=False)
    edges = np.array([cfg.lidar_min_x, cfg.lidar_max_x, cfg.lidar_min_y, cfg.lidar_max_y,
                      0.0, 0.25, -0.25, 12.5], np.float64)
    x[edge[0::2]] = rng.choice(edges, size=len(edge[0::2]))
    y[edge[1::2]] = rng.choice(edges, size=len(edge[1::2]))
    z[edge] = 1.0
    pc = np.zeros((6, num_points), np.float32)
    pc[0], pc[1], pc[2] = x, y, z
    pc[3] = rng.uniform(0.0, 255.0, num_points)
    pc[4] = np.floor(r * 2.0) % 128
    return pc


def example_agent_input(config: Optional[TransfuserConfig] = None, seed: int = 0,
                        num_points: int = 131072,
                        camera_shape: Sequence[int] = (1080, 1920)) -> AgentInput:
    """A seeded one-frame `AgentInput`: uint8 l0/f0/r0 cameras of
    (*camera_shape, 3) (the other five empty), an `example_point_cloud` of
    `num_points` and an ego status with a one-hot driving command."""
    rng = np.random.default_rng(seed)
    images = {name: Camera(image=rng.integers(0, 256, (*camera_shape, 3), dtype=np.uint8))
              for name in ("cam_l0", "cam_f0", "cam_r0")}
    cameras = Cameras(**{name: images.get(name, Camera()) for name in CAMERA_NAMES})
    command = np.zeros(4, np.float32)
    command[rng.integers(0, 4)] = 1.0
    status = EgoStatus(ego_pose=np.zeros(3, np.float32),
                       ego_velocity=rng.normal(0.0, 5.0, 2).astype(np.float32),
                       ego_acceleration=rng.normal(0.0, 1.0, 2).astype(np.float32),
                       driving_command=command)
    return AgentInput(ego_statuses=[status], cameras=[cameras],
                      lidars=[Lidar(example_point_cloud(rng, num_points, config))])


def agent_entry(device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0, num_points: int = 131072,
                config: Optional[TransfuserConfig] = None, trajectory_head_type: str = "diffusion"):
    """(agent, agent_input) for the raw-sensor agent path, on CUDA by default.

    The agent is the full-width `DiffusionDriveAgent(preprocess_on_device=True)`
    (of `config`, default `TransfuserConfig()`, and `trajectory_head_type`)
    with seeded weights, initialized; call ``agent.compute_trajectory(agent_input)``
    or ``agent.forward(features)``. Raises without a GPU unless `device="cpu"`.
    """
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent

    config = config or TransfuserConfig()
    agent = DiffusionDriveAgent(config, trajectory_head_type=trajectory_head_type, dtype=dtype, seed=seed,
                                preprocess_on_device=True, device=device)
    agent.initialize()
    return agent, example_agent_input(config, seed=seed + 1, num_points=num_points)


def example_training_sample(config: TransfuserConfig, rng: np.random.Generator
                            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """One seeded (features, targets) pair in the cache's layout: a uint8
    camera, a lidar BEV in [0, 1], the status; a forward-driving GT
    trajectory, `num_bounding_boxes` agent slots with about a third valid,
    and a BEV semantic map of class indices."""
    cfg = config
    camera = rng.integers(0, 256, (cfg.camera_height, cfg.camera_width, 3), dtype=np.uint8)
    lidar = (rng.integers(0, 6, (cfg.lidar_resolution_height, cfg.lidar_resolution_width,
                                 cfg.lidar_in_channels)) / 5.0).astype(np.float32)
    command = np.eye(4, dtype=np.float32)[rng.integers(0, 4)]
    status = np.concatenate([command, rng.normal(0.0, [5.0, 1.0, 1.0, 0.5], 4).astype(np.float32)])
    speed = rng.uniform(0.0, 12.0)
    t = np.arange(1, cfg.num_poses + 1) * cfg.trajectory_sampling.interval_length
    heading = np.cumsum(rng.normal(0.0, 0.03, cfg.num_poses))
    trajectory = np.stack([speed * t, np.cumsum(speed * 0.5 * np.sin(heading)), heading], -1)
    n = cfg.num_bounding_boxes
    agent_states = np.stack([rng.uniform(-32, 32, n), rng.uniform(-32, 32, n), rng.uniform(-np.pi, np.pi, n),
                             rng.uniform(3.5, 6.0, n), rng.uniform(1.6, 2.4, n)], -1).astype(np.float32)
    agent_labels = rng.uniform(size=n) < 0.35
    agent_states[~agent_labels] = 0.0
    bev = rng.integers(0, cfg.num_bev_classes, cfg.bev_semantic_frame).astype(np.int32)
    features = {"camera_feature": camera, "lidar_feature": lidar, "status_feature": status}
    targets = {"trajectory": trajectory.astype(np.float32), "agent_states": agent_states,
               "agent_labels": agent_labels, "bev_semantic_map": bev}
    return features, targets


def write_example_cache(path: Union[str, Path], config: TransfuserConfig, num_samples: int,
                        seed: int = 0) -> Path:
    """A training cache of `num_samples` `example_training_sample`s under
    ``<path>/example_log/<token>/`` (`transfuser_feature.gz`,
    `transfuser_target.gz`), as dataset caching writes it. Returns `path`."""
    from diffusiondrive_torch.training.dataset import dump_feature_target

    rng = np.random.default_rng(seed)
    root = Path(path)
    for i in range(num_samples):
        token_dir = root / "example_log" / f"token_{i:05d}"
        token_dir.mkdir(parents=True, exist_ok=True)
        features, targets = example_training_sample(config, rng)
        dump_feature_target(features, token_dir / "transfuser_feature.gz")
        dump_feature_target(targets, token_dir / "transfuser_target.gz")
    return root


def place_targets_at_predictions(batch: Dict[str, np.ndarray], pred_states: np.ndarray,
                                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """`batch` with each sample's agent target boxes moved to a random
    permutation of the model's own predicted boxes (B, N, 5), plus 0.1 of
    noise.

    Near a random initialisation the predicted boxes cluster, and the L1 box
    cost of a cluster against targets outside it is separable, so many
    detection assignments cost the same; a last-bit difference between two
    runs (another device, another package) then picks another one and the
    losses differ. With every target next to its own prediction the optimal
    assignment is mostly unique, so such runs can be compared; but the
    classification cost may still send a valid target to another
    prediction than its own, and the L1 cost of two such matches is again
    separable, so `comparison_batch` also checks the margin.
    """
    perm = np.stack([rng.permutation(pred_states.shape[1]) for _ in range(pred_states.shape[0])])
    moved = np.take_along_axis(pred_states, perm[..., None], 1) + rng.normal(0.0, 0.1, pred_states.shape)
    return {**batch, "agent_states": moved.astype(np.float32)}


# the least margin (`assignment_margin`, in cost units) of a comparison
# batch's detection assignment: above what float32 rounding moves the costs
# between two runs (their boxes differ by up to ~1.5e-2 m: PERF.md §6)
MIN_ASSIGNMENT_MARGIN = 0.05
PLACEMENT_TRIES = 20


def _placement_margin(placed: Dict[str, np.ndarray], b: int, pred: torch.Tensor, logits: torch.Tensor,
                      config: TransfuserConfig) -> float:
    """Row `b`'s `assignment_margin` on the detection cost of the float32
    predictions `pred` and `logits` against the `placed` targets, as the
    loss computes it."""
    from diffusiondrive_torch.ops.hungarian import linear_sum_assignment_plain
    from diffusiondrive_torch.training.losses import _ce_cost, _l1_cost

    valid = torch.from_numpy(placed["agent_labels"][b:b + 1]).float()
    cost = (config.agent_class_weight * _ce_cost(valid, logits[b:b + 1])
            + config.agent_box_weight * _l1_cost(torch.from_numpy(placed["agent_states"][b:b + 1]),
                                                 pred[b:b + 1], valid))
    cols = linear_sum_assignment_plain(cost)[0].long()
    return assignment_margin(cost[0], cols, valid[0].bool())


def comparison_batch(model: DiffusionDriveModel, config: TransfuserConfig, batch_size: int,
                     seed: int) -> Tuple[Dict[str, np.ndarray], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(batch, timesteps, noise) for comparing train steps of `model`:
    seeded `example_training_sample`s and the head's draws (timesteps in
    [0, `train_max_t`), noise of `noise_shape` a row; None, None for the
    MLP head, which draws nothing), with the agent
    targets placed at the model's own predictions for those draws
    (`place_targets_at_predictions`, a float32 training forward on the CPU
    with dropout off), so the detection assignment is unique: a row whose
    optimal assignment beats every other by less than
    `MIN_ASSIGNMENT_MARGIN` is placed again (another permutation and
    noise), up to `PLACEMENT_TRIES` times, else this raises. Where two
    assignments cost the same but for rounding, two runs may take either,
    and their box losses, over all five box values where the cost reads
    only the centres, then differ (PERF.md §6).

    The camera comes normalised to float32 on the host, so every device
    reads the same input: on the card the model's own ``x / 255`` of a
    uint8 camera runs as ``x * (1 / 255)``, one ulp off the CPU's division
    for some pixels, and the train step's gradients amplify that (PERF.md).
    """
    from diffusiondrive_torch.training.dataset import collate

    rng = np.random.default_rng(seed)
    batch = collate([example_training_sample(config, rng) for _ in range(batch_size)])
    batch["camera_feature"] = batch["camera_feature"].astype(np.float32) / np.float32(255.0)
    head = model.trajectory_head
    timesteps = noise = None
    if head.noise_shape is not None:
        timesteps = torch.from_numpy(rng.integers(0, head.train_max_t, batch_size))
        noise = torch.from_numpy(rng.normal(size=(batch_size, *head.noise_shape)).astype(np.float32))
    probe = copy.deepcopy(model).cpu().train()
    disable_dropout(probe)
    with torch.no_grad():
        out = probe(*(torch.from_numpy(batch[k]) for k in ("camera_feature", "lidar_feature", "status_feature")),
                    targets={"trajectory": torch.from_numpy(batch["trajectory"])}, timesteps=timesteps,
                    diffusion_noise=noise)
    pred, logits = out["agent_states"], out["agent_labels"]
    placed = place_targets_at_predictions(batch, pred.numpy(), rng)
    for b in range(batch_size):
        for _ in range(PLACEMENT_TRIES):
            if _placement_margin(placed, b, pred, logits, config) >= MIN_ASSIGNMENT_MARGIN:
                break
            placed["agent_states"][b] = place_targets_at_predictions({}, pred[b:b + 1].numpy(), rng)["agent_states"][0]
        else:
            raise RuntimeError(f"comparison_batch: row {b} has no placement with a unique detection assignment "
                               f"in {PLACEMENT_TRIES} tries")
    return placed, timesteps, noise


def _record_outputs(model: torch.nn.Module, store: Dict[str, List[torch.Tensor]], size: int = 4096):
    """Forward hooks keeping, per module and call, up to `size` evenly spaced
    elements of each floating tensor output (in float64 on the CPU)."""
    def hook(module, args, out, name):
        if torch.is_tensor(out) and out.is_floating_point():
            flat = out.detach().reshape(-1)
            store.setdefault(name, []).append(flat[::max(1, flat.numel() // size)][:size].double().cpu())

    return [m.register_forward_hook(lambda mod, a, o, n=name: hook(mod, a, o, n))
            for name, m in model.named_modules() if name]


@contextlib.contextmanager
def recording_kernel_calls(store: dict, keep: Optional[int] = None):
    """The kernels' call sites in the model (`models/resnet.py`: the stem and
    conv3x3) and in the detection loss (`training/losses.py`: the LAP, "lap",
    and its plain solver past `MAX_N`, "lap_plain") wrapped to keep the
    inputs and the output of the first `keep` calls (all with None) of each
    kernel at each input shape and dtype, with or without a residual:
    `store[(kernel, shape, dtype, residual)]` lists `(args, kwargs, out)`,
    detached clones on their device, in call order. The calls themselves
    run and count as before."""
    from diffusiondrive_torch.models import resnet
    from diffusiondrive_torch.training import losses

    sites = {"stem": (resnet, "fused_stem"), "conv3x3": (resnet, "fused_conv3x3"),
             "lap": (losses, "batched_linear_sum_assignment"), "lap_plain": (losses, "linear_sum_assignment_plain")}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in sites.items()}

    def clone(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def keeping(kernel, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            x = args[0]
            calls = store.setdefault((kernel, tuple(x.shape), str(x.dtype), kwargs.get("residual") is not None), [])
            if keep is None or len(calls) < keep:
                calls.append(([clone(a) for a in args], {k: clone(v) for k, v in kwargs.items()}, clone(out)))
            return out
        return call

    for k, (mod, attr) in sites.items():
        setattr(mod, attr, keeping(k, originals[k]))
    try:
        yield store
    finally:
        for k, (mod, attr) in sites.items():
            setattr(mod, attr, originals[k])


def assignment_margin(cost: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor) -> float:
    """How much more one row's optimal assignment `cols` of the (n, n) cost
    costs once any one of its edges to a valid target is forbidden: 0 where
    the optimum is not unique, so that rounding may pick another (the plain
    solver, in float64)."""
    from diffusiondrive_torch.ops.hungarian import linear_sum_assignment_plain

    cost = cost.double()
    rows = torch.arange(cost.shape[0])
    best = cost[rows, cols].sum()
    margin = float("inf")
    for i, j in zip(rows.tolist(), cols.tolist()):
        if valid[j]:
            forced = cost.clone()
            forced[i, j] = 1e12
            again = linear_sum_assignment_plain(forced[None])[0].long()
            margin = min(margin, (forced[rows, again].sum() - best).item())
    return margin


def box_loss_move_bound(run: dict, ref: dict, valid: torch.Tensor, config: TransfuserConfig) -> float:
    """The most the weighted box loss of the step `run` can lie from that
    of the step `ref` when both take `ref`'s assignment: the sum, over the
    predictions `ref` matched to valid targets, of |box - `ref`'s box| (all
    five values), over the valid count (triangle inequality on the loss's
    L1). `run` and `ref` come from `train_step_on(record=True)`."""
    boxes, ref_boxes = run["assignment"]["agent_states"], ref["assignment"]["agent_states"]
    matched = valid.double().gather(1, ref["assignment"]["cols"].long())
    moved = ((boxes - ref_boxes).abs().sum(-1) * matched).sum().item()
    return config.agent_box_weight * moved / max(valid.sum().item(), 1.0)


def train_step_on(model: DiffusionDriveModel, config: TransfuserConfig, batch: Dict[str, np.ndarray],
                  timesteps: torch.Tensor, noise: torch.Tensor, device: Union[str, torch.device],
                  dtype: torch.dtype = torch.float32, cudnn: bool = True, record: bool = False,
                  kinks: Optional["Kinks"] = None) -> dict:
    """One train step (default `OptimizerConfig`) of a copy of the float32
    `model` on `device`, dropout off, with the diffusion draws fixed.

    `dtype=torch.float64` runs it with float64 parameters, statistics and
    compute (the detection cost is rounded to float32 for the assignment,
    as in every run). `cudnn=False` runs it with cuDNN switched off.
    Returns the loss terms, every parameter's gradient and the BatchNorm
    running statistics after the step (float64, on the CPU), the number of
    LAP launches the step made and, with `record`, a sample of every
    module's forward output (`_record_outputs`) and, under "assignment",
    the detection loss's float32 cost (B, n, n), its assignment `cols` (B,
    n) and the predicted boxes `agent_states` (B, n, 5, float64). With
    `kinks`, the step runs
    under it (`Kinks`: records, compares or imposes the side taken at each
    ReLU, |x| and max-pool).
    """
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.training.train import OptimizerConfig, create_train_state, train_step

    device = torch.device(device)
    if dtype == torch.float64:
        m = DiffusionDriveModel(config, model.trajectory_head_type, dtype=torch.float64)
        m.load_state_dict(model.state_dict())
        m = m.to(device, torch.float64)
    else:
        m = copy.deepcopy(model).to(device)
    disable_dropout(m)
    store: Dict[str, List[torch.Tensor]] = {}
    calls: dict = {}
    handles = (_record_outputs(m, store) if record else []) + (kinks.attach(m) if kinks is not None else [])
    boxes: List[torch.Tensor] = []
    if record:
        handles.append(m.agent_head.register_forward_hook(
            lambda mod, a, out: boxes.append(out["agent_states"].detach().double().cpu())))
    state = create_train_state(m, OptimizerConfig())
    lap0 = batched_linear_sum_assignment.launches
    cudnn_was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        with kinks if kinks is not None else contextlib.nullcontext(), \
                recording_kernel_calls(calls) if record else contextlib.nullcontext():
            losses = train_step(state, config, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                timesteps=None if timesteps is None else timesteps.to(device),
                                noise=None if noise is None else noise.to(device))
    finally:
        torch.backends.cudnn.enabled = cudnn_was
        for h in handles:
            h.remove()
    solved = [(args[0].cpu(), cols.cpu()) for (kernel, *_), kept in calls.items() if kernel in ("lap", "lap_plain")
              for args, _, cols in kept]
    return {"losses": {k: v.item() for k, v in losses.items()},
            "grads": {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()},
            "stats": {k: b.detach().double().cpu() for k, b in m.named_buffers() if "running" in k},
            "lap_launches": batched_linear_sum_assignment.launches - lap0, "outputs": store,
            **({"assignment": {"cost": solved[0][0], "cols": solved[0][1], "agent_states": boxes[0]}}
               if solved else {})}


_RELU = (F.relu, torch.relu, torch.Tensor.relu)
_ABS = (torch.abs, torch.Tensor.abs)


class Kinks(TorchFunctionMode):
    """The points where a train step's forward is not differentiable, in call
    order: the input of every ReLU and |x|, and the windows of every max-pool.

    With no `ref` it records, per call, the input (a copy on the CPU) and the
    side taken: x > 0 for a ReLU, sign(x) for |x|, each window's argmax for a
    pool. Given the record of another run it compares instead, per call
    (`seen`): `err`, the largest |x - x_ref| over max |x_ref|, and `flips`,
    the elements that took another side, with `near`, the largest |x_ref|
    over max |x_ref| among them (for a pool, the gap between the two
    windows' picks in `ref`): how far from the kink the reference lay where
    the two runs parted. With `impose`, the forward takes `ref`'s side at
    every kink: a ReLU as x * [x_ref > 0], |x| as x * sign(x_ref), a pool
    gathering at `ref`'s argmax. Where an input lies within rounding of a
    kink, a float32 and a float64 step may take either side, and the
    gradients downstream then differ by all that the unit carries; imposing
    one run's sides on another compares their gradients on the same side of
    every kink (PERF.md §6). Imposing a run's own record changes none
    of its values. Use through `train_step_on(kinks=...)`, which attaches it
    to the model (`attach` names the module of each call) and runs the step
    under it; a second run needs a new instance.
    """

    def __init__(self, ref: Optional["Kinks"] = None, impose: bool = False):
        super().__init__()
        if impose and ref is None:
            raise ValueError("Kinks: impose needs a reference record")
        self.ref, self.impose = ref, impose
        self.calls: List[Tuple[str, str, torch.Tensor, torch.Tensor]] = []
        self.seen: List[dict] = []
        self._where = ["(loss)"]

    def attach(self, model: torch.nn.Module) -> List[torch.utils.hooks.RemovableHandle]:
        """Forward hooks on `model`'s modules that keep the innermost running
        module's name, to label each call."""
        def enter(module, args, name):
            self._where.append(name)

        def leave(module, args, out):
            self._where.pop()

        handles = []
        for name, mod in model.named_modules():
            if name:
                handles.append(mod.register_forward_pre_hook(lambda m, a, n=name: enter(m, a, n)))
                handles.append(mod.register_forward_hook(leave))
        return handles

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = "relu" if func in _RELU else "abs" if func in _ABS else "max_pool2d" if func is F.max_pool2d else None
        if op is None or not args[0].is_floating_point():
            return func(*args, **kwargs)
        x = args[0]
        if op == "max_pool2d":
            out, side = F.max_pool2d_with_indices(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            side = x.detach() > 0 if op == "relu" else torch.sign(x.detach())
        where = self._where[-1]
        if self.ref is None:
            self.calls.append((op, where, x.detach().to("cpu", copy=True), side.to("cpu", copy=True)))
            return out
        i = len(self.seen)
        rop, rwhere, rx, rside = self.ref.calls[i]
        if rop != op or rx.shape != x.shape:
            raise RuntimeError(f"Kinks: call {i} is {op} {tuple(x.shape)} at {where}, the reference's "
                               f"{rop} {tuple(rx.shape)} at {rwhere}")
        rx, rside = rx.to(x.device), rside.to(x.device)
        scale = rx.abs().max().double().clamp_min(1e-300)
        differ = side != rside
        flips = int(differ.sum())
        near = 0.0
        if flips:
            if op == "max_pool2d":
                flat = rx.flatten(2)
                gap = (flat.gather(2, side.flatten(2)) - flat.gather(2, rside.flatten(2))).abs()
                near = (gap.view(side.shape)[differ].max().double() / scale).item()
            else:
                near = (rx.abs()[differ].max().double() / scale).item()
        err = ((x.detach().double() - rx.double()).abs().max() / scale).item()
        self.seen.append({"op": op, "where": where, "err": err, "flips": flips, "near": near})
        if not self.impose:
            return out
        if op == "max_pool2d":
            picked = x.flatten(2).gather(2, rside.flatten(2)).view(out.shape)
            return picked.contiguous(memory_format=torch.channels_last) \
                if x.is_contiguous(memory_format=torch.channels_last) else picked
        return x * rside.to(x.dtype)

    def summary(self, ops: Sequence[str] = ("relu", "abs", "max_pool2d")) -> dict:
        """After a compared run, over the calls of `ops`: their number, the
        largest `err` and where, the flips by part of the model (first name
        component; the backbone's two), each call with flips outside the
        backbone, and the three backbone calls whose flips lay farthest from
        the kink in the reference: ``[where, op, flips, near]``."""
        seen = [c for c in self.seen if c["op"] in ops]
        worst = max(seen, key=lambda c: c["err"])
        parts: Dict[str, int] = {}
        for c in seen:
            if c["flips"]:
                part = ".".join(c["where"].split(".")[:2 if c["where"].startswith("backbone") else 1])
                parts[part] = parts.get(part, 0) + c["flips"]
        flipped = [c for c in seen if c["flips"]]
        head = [c for c in flipped if not c["where"].startswith("backbone")]
        far = sorted((c for c in flipped if c["where"].startswith("backbone")), key=lambda c: -c["near"])[:3]
        return {"kinks": len(seen), "max_err": [worst["where"], worst["op"], worst["err"]],
                "flips": sum(c["flips"] for c in seen), "flips_by_part": parts,
                "flips_outside_backbone": [[c["where"], c["op"], c["flips"], c["near"]] for c in head],
                "farthest_backbone_flips": [[c["where"], c["op"], c["flips"], c["near"]] for c in far]}


def gradient_limits(cpu_f32: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The float32 gradient gate per parameter: relative L2 to the float64
    step `ref` within min(1e-2 + 2 x the CPU float32 step's own distance to
    it, 0.1), so a device's float32 step is held to the CPU's float32
    accuracy (PERF.md §2)."""
    return {k: min(1e-2 + 2.0 * v, 0.1) for k, v in grad_distances(cpu_f32, ref).items()}


def grad_distances(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                   floor: float = 1e-6) -> Dict[str, float]:
    """Per parameter, |got - want|_2 / max(|want|_2, floor * the largest
    |want|_2 of all). The floor keeps gradients that are zero but for
    rounding (an attention key's bias: softmax ignores a shift shared by all
    keys) from reading as 100% apart."""
    top = max(w.norm().item() for w in want.values())
    return {k: (got[k] - w).norm().item() / max(w.norm().item(), floor * top, 1e-300)
            for k, w in want.items()}


def output_distances(got: Dict[str, List[torch.Tensor]],
                     want: Dict[str, List[torch.Tensor]]) -> Dict[str, float]:
    """Per module output recorded by `train_step_on(record=True)`, in the
    order of the forward: |got - want|_2 / |want|_2, keyed ``name#call``
    for a module called more than once."""
    return {(f"{k}#{i}" if len(w) > 1 else k): (g - x).norm().item() / max(x.norm().item(), 1e-300)
            for k, w in want.items() if k in got for i, (g, x) in enumerate(zip(got[k], w))}


# ----------------------------------------------------------------------------
# the multi-device dry run (counterpart of `__graft_entry__.dryrun_multichip`)
# ----------------------------------------------------------------------------

DRYRUN_CONFIG = dict(image_architecture="resnet18", lidar_architecture="resnet18", camera_height=64,
                     camera_width=256, lidar_resolution_height=64, lidar_resolution_width=64,
                     img_vert_anchors=2, img_horz_anchors=8, lidar_vert_anchors=2, lidar_horz_anchors=2,
                     bev_pixel_height=32, bev_pixel_width=64)
# the JAX dry run's tiers: `agent_box_loss` owns the Hungarian near-tie
# channel, "loss" inherits it weighted; every other term is a float reorder
DRYRUN_REL = {"agent_box_loss": 1e-2, "loss": 1e-3}
DRYRUN_REL_OTHER = 1e-4


def dryrun_batch(batch_size: int) -> Dict[str, np.ndarray]:
    """The JAX dry run's seeded batch (`__graft_entry__.py:112-124`) at
    `DRYRUN_CONFIG`'s shapes."""
    rng = np.random.default_rng(0)
    cam_h, cam_w, lid = 64, 256, 64
    return {
        "camera_feature": rng.normal(size=(batch_size, cam_h, cam_w, 3)).astype(np.float32),
        "lidar_feature": rng.normal(size=(batch_size, lid, lid, 1)).astype(np.float32),
        "status_feature": rng.normal(size=(batch_size, 8)).astype(np.float32),
        "trajectory": rng.normal(size=(batch_size, 8, 3)).astype(np.float32),
        "agent_states": rng.normal(size=(batch_size, 30, 5)).astype(np.float32),
        "agent_labels": (rng.uniform(size=(batch_size, 30)) > 0.5).astype(np.float32),
        "bev_semantic_map": rng.integers(0, 7, size=(batch_size, lid // 2, lid)).astype(np.int32),
    }


def dryrun_train_step(config: TransfuserConfig, batch: Dict[str, np.ndarray], device: torch.device):
    """One `Trainer` step (default `OptimizerConfig`) of the seeded model on
    `batch`, dropout off; under a process group on this rank's rows of the
    global `batch`. Returns (the step's loss terms as floats, the trainer)."""
    from diffusiondrive_torch.parallel.distributed import rank, world_size
    from diffusiondrive_torch.parallel.mesh import rank_rows
    from diffusiondrive_torch.training.train import OptimizerConfig
    from diffusiondrive_torch.training.trainer import Trainer

    model = build_model(config, seed=0).to(device)
    disable_dropout(model)
    rows = rank_rows(len(batch["status_feature"]), rank(), world_size())
    trainer = Trainer(model, config, OptimizerConfig(), seed=0)
    trainer.fit(lambda epoch: [{k: v[rows] for k, v in batch.items()}], 1)
    return trainer.last_train_metrics, trainer


def _dryrun_rank(rank_: int, world: int, device: torch.device, config: TransfuserConfig,
                 batch: Dict[str, np.ndarray]) -> dict:
    """A dry-run rank: the DDP step on its rows; its terms, its LAP launches
    and a digest of its parameters after the step."""
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment

    lap0 = batched_linear_sum_assignment.launches
    metrics, trainer = dryrun_train_step(config, batch, device)
    digest = sum(float(p.detach().double().sum()) for p in trainer.model.parameters())
    return {"metrics": metrics, "lap_launches": batched_linear_sum_assignment.launches - lap0,
            "param_digest": digest, "backend": torch.distributed.get_backend()}


def golden_tailgating_scenes(scenes: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """`scenes` copies of the JAX dry run's golden scenario
    (`__graft_entry__.py:199-241`): a clean 10 m/s drive tailgating a 9 m/s
    lead car 12 m ahead, two identical proposals; it scores 7/12 (a TTC
    infraction only). Returns (proposals, context) in
    `pdm_score.simulate_and_score_on`'s order."""
    from diffusiondrive_torch.common.enums import MapLayer

    T, O, P, num_local = 41, 4, 4, 26
    proposal = np.zeros((T, 11), np.float32)
    proposal[:, 0] = 1.0 * np.arange(T)
    proposal[:, 3] = 10.0
    poses = np.full((num_local, O, 3), 1e6, np.float32)
    poses[..., 2] = 0.0
    extents = np.ones((O, 2), np.float32)
    valid = np.zeros(O, bool)
    is_stopped = np.ones(O, bool)
    valid[0], extents[0], is_stopped[0] = True, (4.5, 2.0), False
    for li in range(num_local):
        poses[li, 0] = (12.0 + 9.0 * li * 0.2, 0.0, 0.0)
    polys = np.full((P, 8, 2), 1e6, np.float32)
    pvalid = np.zeros(P, bool)
    layers = np.zeros(P, np.int32)
    on_route = np.zeros(P, bool)
    rect = np.array([[-20, -8], [220, -8], [220, 8], [-20, 8]], np.float32)
    for i, (layer, route) in enumerate([(MapLayer.ROADBLOCK, False), (MapLayer.LANE, True)]):
        polys[i, :4], polys[i, 4:] = rect, rect[3]
        pvalid[i], layers[i], on_route[i] = True, layer, route
    cl_x = np.linspace(-20, 220, 121, dtype=np.float32)
    centerline = np.stack([cl_x, np.zeros_like(cl_x)], -1)

    def tile(a):
        return np.tile(a, (scenes,) + (1,) * a.ndim)

    ctx = [proposal[0], poses, extents, valid, valid.copy(), np.zeros(O, bool), is_stopped, np.zeros(O, bool),
           np.array([i // 2 for i in range(52)], np.int32), polys, pvalid, layers, on_route, centerline]
    return tile(np.stack([proposal, proposal])), [tile(a) for a in ctx]


def dryrun_multichip(n: int, device: Optional[Union[str, torch.device]] = None,
                     init_method: Optional[str] = None, timeout: float = 900.0) -> dict:
    """One data-parallel train step on `n` ranks and the evaluation path over
    an `n`-device list, each held to a one-device golden; the port's
    counterpart of `__graft_entry__.dryrun_multichip`.

    1. The JAX dry run's tiny ResNet-18 config and seeded batch of ``2 n``
       rows; the golden is one `Trainer` step of the seeded model on the
       whole batch in this process, with no process group. Then `n` spawned
       ranks (`parallel/distributed.py:launch`) each take the same step
       under `DistributedDataParallel` on their rows; every loss term must
       equal the golden within the JAX dry run's tiers and the ranks'
       parameters must agree bit for bit. Dropout is off: the JAX dry run
       draws one global mask, the port one mask a rank.
    2. The golden model's planner forward split over the device list,
       against the one-device forward (1e-4), and the golden tailgating
       scenario simulated and scored over it: 7/12 on every scene.

    On the card (the default) rank r takes card r over NCCL and the device
    list is the first `n` cards; fewer cards raise. ``device="cpu"`` runs
    gloo ranks and a list of `n` CPU devices. `init_method` is the ranks'
    rendezvous (``file:///path``; default a free localhost port).
    """
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent
    from diffusiondrive_torch.common.dataclasses import TrajectorySampling
    from diffusiondrive_torch.evaluate.pdm_score import simulate_and_score_on
    from diffusiondrive_torch.evaluate.scorer import PDMScorerConfig
    from diffusiondrive_torch.evaluate.simulator import PDMSimulator
    from diffusiondrive_torch.parallel.distributed import launch

    dev0 = resolve_device(device)
    if dev0.type == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, have {torch.cuda.device_count()}")
        dev0, rank_dev = torch.device("cuda", 0), "cuda"
        mesh = [torch.device("cuda", i) for i in range(n)]
    else:
        rank_dev, mesh = "cpu", [dev0] * n
    config = TransfuserConfig(**DRYRUN_CONFIG)
    batch = dryrun_batch(2 * n)

    golden, trainer = dryrun_train_step(config, batch, dev0)
    ranks = launch(_dryrun_rank, n, args=(config, batch), device=rank_dev, init_method=init_method,
                   timeout=timeout, threads=torch.get_num_threads())
    for r in ranks:
        for key, want in golden.items():
            got = r["metrics"][key]
            rel = DRYRUN_REL.get(key, DRYRUN_REL_OTHER)
            if not abs(got - want) <= rel * max(abs(want), 1e-6):
                raise AssertionError(f"dryrun_multichip({n}): {key} {got!r} on {n} ranks, golden {want!r}")
    if len({r["param_digest"] for r in ranks}) != 1:
        raise AssertionError(f"dryrun_multichip({n}): parameters differ across ranks {ranks}")
    loss = ranks[0]["metrics"]["loss"]
    print(f"dryrun_multichip({n}): train ok, loss={loss:.4f} (== 1-device golden {golden['loss']:.4f})")

    agent = DiffusionDriveAgent(config, dtype=torch.float32, device=dev0)
    agent.model = trainer.model.eval()
    features = {k: batch[k] for k in ("camera_feature", "lidar_feature", "status_feature")}
    one = agent.forward(features)["trajectory"]
    agent.set_mesh(mesh)
    split = agent.forward(features)["trajectory"]
    if split.shape != (2 * n, config.num_poses, 3) or not np.isfinite(split).all() \
            or not np.allclose(split, one, rtol=0.0, atol=1e-4):
        raise AssertionError(f"dryrun_multichip({n}): split forward {split} vs one device {one}")

    proposals, ctx = golden_tailgating_scenes(n)
    simulator = PDMSimulator(TrajectorySampling(num_poses=40, interval_length=0.1))
    scores = simulate_and_score_on(mesh, simulator, PDMScorerConfig(), proposals, ctx).score
    if scores.shape != (n, 2) or np.abs(scores - 7.0 / 12.0).max() >= 1e-4:
        raise AssertionError(f"dryrun_multichip({n}): eval scores {scores.ravel()} != 7/12")
    score = float(scores.mean())
    print(f"dryrun_multichip({n}): ok, loss={loss:.4f}, eval_score={score:.4f}")
    return {"n": n, "backend": ranks[0]["backend"], "loss": loss, "golden": golden,
            "terms": ranks[0]["metrics"], "lap_launches": [r["lap_launches"] for r in ranks],
            "max_abs_trajectory_diff": float(np.abs(split - one).max()), "eval_score": score}
