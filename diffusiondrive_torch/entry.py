"""Entry points: the planner and the raw-sensor agent, with seeded inputs.

`entry()` builds the full-width DiffusionDrive planner (default
`TransfuserConfig`: ResNet-34 branches, 256x1024 camera, 256x256 lidar BEV)
in eval mode with seeded random weights, plus example inputs, on CUDA unless
`device="cpu"` is passed; it is the port's counterpart of
`__graft_entry__.entry()`. `agent_entry()` builds the
`DiffusionDriveAgent` that preprocesses the raw sensors on the device, plus a
seeded `AgentInput` (`example_agent_input`), for
``agent.compute_trajectory(agent_input)``. `example_training_sample` and
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


def build_model(config: Optional[TransfuserConfig] = None, dtype: torch.dtype = torch.float32,
                seed: int = 0) -> DiffusionDriveModel:
    """The planner on the CPU in eval mode, weights drawn from `seed`.

    The BatchNorm statistics are drawn too (mean ~ N(0, 0.3), var ~
    U(0.7, 1.5)), so that folding them into the kernels' affine is exercised.
    """
    gen = torch.Generator().manual_seed(seed)
    model = DiffusionDriveModel(config or TransfuserConfig(), dtype=dtype)
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
          batch: int = 1, seed: int = 0) -> Tuple[DiffusionDriveModel, Dict[str, torch.Tensor]]:
    """(model, example inputs) for the planner forward, on CUDA by default.

    Raises without a GPU unless `device="cpu"` is passed. Call as
    ``with torch.no_grad(): model(**inputs)``.
    """
    device = resolve_device(device)
    config = TransfuserConfig()
    model = build_model(config, dtype=dtype, seed=seed).to(device)
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
                dtype: torch.dtype = torch.bfloat16, seed: int = 0, num_points: int = 131072):
    """(agent, agent_input) for the raw-sensor agent path, on CUDA by default.

    The agent is the full-width `DiffusionDriveAgent(preprocess_on_device=True)`
    with seeded weights, initialized; call ``agent.compute_trajectory(agent_input)``
    or ``agent.forward(features)``. Raises without a GPU unless `device="cpu"`.
    """
    from diffusiondrive_torch.agents.diffusiondrive.agent import DiffusionDriveAgent

    config = TransfuserConfig()
    agent = DiffusionDriveAgent(config, dtype=dtype, seed=seed, preprocess_on_device=True,
                                device=device)
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
    assignment is unique, so such runs can be compared.
    """
    perm = np.stack([rng.permutation(pred_states.shape[1]) for _ in range(pred_states.shape[0])])
    moved = np.take_along_axis(pred_states, perm[..., None], 1) + rng.normal(0.0, 0.1, pred_states.shape)
    return {**batch, "agent_states": moved.astype(np.float32)}


def comparison_batch(model: DiffusionDriveModel, config: TransfuserConfig, batch_size: int,
                     seed: int) -> Tuple[Dict[str, np.ndarray], torch.Tensor, torch.Tensor]:
    """(batch, timesteps, noise) for comparing train steps of `model`:
    seeded `example_training_sample`s and diffusion draws, with the agent
    targets placed at the model's own predictions for those draws
    (`place_targets_at_predictions`, a float32 training forward on the CPU
    with dropout off), so the detection assignment is unique.

    The camera comes normalised to float32 on the host, so every device
    reads the same input: on the card the model's own ``x / 255`` of a
    uint8 camera runs as ``x * (1 / 255)``, one ulp off the CPU's division
    for some pixels, and the train step's gradients amplify that (PERF.md).
    """
    from diffusiondrive_torch.training.dataset import collate

    rng = np.random.default_rng(seed)
    batch = collate([example_training_sample(config, rng) for _ in range(batch_size)])
    batch["camera_feature"] = batch["camera_feature"].astype(np.float32) / np.float32(255.0)
    timesteps = torch.from_numpy(rng.integers(0, config.diffusion_train_max_t, batch_size))
    noise = torch.from_numpy(rng.normal(size=(batch_size, config.ego_fut_mode, config.num_poses, 2))
                             .astype(np.float32))
    probe = copy.deepcopy(model).cpu().train()
    disable_dropout(probe)
    with torch.no_grad():
        pred = probe(*(torch.from_numpy(batch[k]) for k in ("camera_feature", "lidar_feature", "status_feature")),
                     timesteps=timesteps, diffusion_noise=noise)["agent_states"].numpy()
    return place_targets_at_predictions(batch, pred, rng), timesteps, noise


def _record_outputs(model: torch.nn.Module, store: Dict[str, List[torch.Tensor]], size: int = 4096):
    """Forward hooks keeping, per module and call, up to `size` evenly spaced
    elements of each floating tensor output (in float64 on the CPU)."""
    def hook(module, args, out, name):
        if torch.is_tensor(out) and out.is_floating_point():
            flat = out.detach().reshape(-1)
            store.setdefault(name, []).append(flat[::max(1, flat.numel() // size)][:size].double().cpu())

    return [m.register_forward_hook(lambda mod, a, o, n=name: hook(mod, a, o, n))
            for name, m in model.named_modules() if name]


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
    module's forward output (`_record_outputs`). With `kinks`, the step runs
    under it (`Kinks`: records, compares or imposes the side taken at each
    ReLU, |x| and max-pool).
    """
    from diffusiondrive_torch.ops.hungarian import batched_linear_sum_assignment
    from diffusiondrive_torch.training.train import OptimizerConfig, create_train_state, train_step

    device = torch.device(device)
    if dtype == torch.float64:
        m = DiffusionDriveModel(config, dtype=torch.float64)
        m.load_state_dict(model.state_dict())
        m = m.to(device, torch.float64)
    else:
        m = copy.deepcopy(model).to(device)
    disable_dropout(m)
    store: Dict[str, List[torch.Tensor]] = {}
    handles = (_record_outputs(m, store) if record else []) + (kinks.attach(m) if kinks is not None else [])
    state = create_train_state(m, OptimizerConfig())
    lap0 = batched_linear_sum_assignment.launches
    cudnn_was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        with kinks if kinks is not None else contextlib.nullcontext():
            losses = train_step(state, config, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                timesteps=timesteps.to(device), noise=noise.to(device))
    finally:
        torch.backends.cudnn.enabled = cudnn_was
        for h in handles:
            h.remove()
    return {"losses": {k: v.item() for k, v in losses.items()},
            "grads": {k: p.grad.detach().double().cpu() for k, p in m.named_parameters()},
            "stats": {k: b.detach().double().cpu() for k, b in m.named_buffers() if "running" in k},
            "lap_launches": batched_linear_sum_assignment.launches - lap0, "outputs": store}


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
