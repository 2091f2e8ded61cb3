"""DiffusionDrive agent (counterpart of `diffusiondrive_tpu/agents/diffusiondrive/agent.py`).

Owns the port's `DiffusionDriveModel` on one device. `forward` takes a
batched numpy feature dict, either the host builder's (`camera_feature`,
`lidar_feature`, `status_feature`) or the raw sensors of
`RawSensorFeatureBuilder` (`preprocess_on_device=True`), whose stitch,
resize and BEV splat then run on the device (`ops/preprocessing.py`), and
returns numpy float32. Weights come from a seed, from a reference-layout
`.pth`/`.ckpt` (the published checkpoint format) or from a checkpoint
directory written by the port's `Trainer` (`use_ema` picks its EMA
weights). The training interface (target builder, loss, optimiser,
callbacks) is that of the JAX agent.

`trajectory_head_type` ("diffusion", "unet" or "mlp") picks the model's
head, as in JAX. The head's noise (`draw_noise`: the diffusion head's
(B, modes, poses, 2), the UNet's (B, poses, 3), none for the MLP) is drawn
from a per-device generator re-seeded to 7 on each call: repeatable, as
the JAX agent's fixed `PRNGKey(7)` is, but a different draw by
construction.

`set_mesh(devices)` is the counterpart of the JAX agent's: the forward's
rows are split over the list, a replica of the model on each device (its
weights copied once, and again only when they change) preprocesses and
runs its rows, and the outputs are gathered on the first device. Without
a list the agent's device is a list of one. The noise is drawn for the
whole batch on the agent's device and split with the rows, so the rows
equal the one-device forward's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from diffusiondrive_torch.agents.abstract_agent import AbstractAgent
from diffusiondrive_torch.agents.diffusiondrive.features import (
    RawSensorFeatureBuilder,
    TransfuserFeatureBuilder,
    TransfuserTargetBuilder,
)
from diffusiondrive_torch.common.dataclasses import SensorConfig
from diffusiondrive_torch.device import resolve_device
from diffusiondrive_torch.entry import build_model
from diffusiondrive_torch.models.config import TransfuserConfig
from diffusiondrive_torch.models.transfuser_model import DiffusionDriveModel
from diffusiondrive_torch.ops.preprocessing import lidar_bev, stitch_cameras
from diffusiondrive_torch.parallel.mesh import canonical_device, device_scope, gather_rows, replicas, split_rows
from diffusiondrive_torch.training.abstract_feature_target_builder import (
    AbstractFeatureBuilder,
    AbstractTargetBuilder,
)
from diffusiondrive_torch.training.callbacks import BEVVisualizationCallback, TimeLoggingCallback
from diffusiondrive_torch.training.losses import transfuser_loss
from diffusiondrive_torch.training.train import OptimizerConfig, build_optimizer
from diffusiondrive_torch.training.trainer import checkpoint_state_dict, load_checkpoint
from diffusiondrive_torch.utils.port_transfuser import load_transfuser_state_dict

_TORCH_CHECKPOINTS = (".pth", ".ckpt", ".pt", ".bin")
_NOISE_SEED = 7


class DiffusionDriveAgent(AbstractAgent):
    """Truncated-diffusion end-to-end planner (camera + lidar fusion).

    Runs on CUDA unless `device="cpu"` is passed; without a GPU and without
    that request the constructor raises.
    """

    requires_scene = False

    def __init__(self, config: Optional[TransfuserConfig] = None, lr: float = 6e-4,
                 checkpoint_path: Optional[str] = None, trajectory_head_type: str = "diffusion",
                 dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, preprocess_on_device: bool = False, use_ema: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self._config = config or TransfuserConfig()
        self._lr = lr
        self._checkpoint_path = checkpoint_path
        self.trajectory_head_type = trajectory_head_type
        self._dtype = dtype
        self._seed = seed
        self._preprocess_on_device = preprocess_on_device
        self._use_ema = use_ema  # load the EMA weights of a `Trainer` checkpoint
        self.device = resolve_device(device)
        self.model: Optional[DiffusionDriveModel] = None
        self._generator = torch.Generator(device=self.device)
        self._mesh: Optional[List[torch.device]] = None
        self._replicas: Dict = {}

    @property
    def config(self) -> TransfuserConfig:
        return self._config

    def name(self) -> str:
        return self.__class__.__name__

    def initialize(self) -> None:
        """Build the model once (idempotent): seeded weights, a reference
        `.pth` or a `Trainer` checkpoint directory, then the
        `plan_anchor_path` override; moves it to the device."""
        if self.model is not None:
            return
        cfg = self._config
        path = self._checkpoint_path
        if path and Path(path).suffix in _TORCH_CHECKPOINTS:
            model = DiffusionDriveModel(cfg, self.trajectory_head_type, dtype=self._dtype)
            model.load_state_dict(load_transfuser_state_dict(path, model), strict=True)
            model.eval()
        elif path:
            model = DiffusionDriveModel(cfg, self.trajectory_head_type, dtype=self._dtype)
            payload = load_checkpoint(path, torch.device("cpu"))
            model.load_state_dict(checkpoint_state_dict(payload, self._use_ema), strict=True)
            model.eval()
        else:
            model = build_model(cfg, self._dtype, seed=self._seed, trajectory_head_type=self.trajectory_head_type)
        # only the diffusion head has anchors
        if cfg.plan_anchor_path and Path(cfg.plan_anchor_path).exists() and self.trajectory_head_type == "diffusion":
            anchors = torch.from_numpy(np.load(cfg.plan_anchor_path).astype(np.float32))
            with torch.no_grad():
                model.trajectory_head.plan_anchor.copy_(anchors)
        self.model = model.to(self.device)

    def get_sensor_config(self) -> SensorConfig:
        # the sensors the feature builders consume, current frame only
        return SensorConfig(cam_f0=[3], cam_l0=[3], cam_l1=False, cam_l2=False,
                            cam_r0=[3], cam_r1=False, cam_r2=False, cam_b0=False,
                            lidar_pc=[3])

    def get_feature_builders(self) -> List[AbstractFeatureBuilder]:
        if self._preprocess_on_device:
            return [RawSensorFeatureBuilder(self._config)]
        return [TransfuserFeatureBuilder(self._config)]

    def get_target_builders(self) -> List[AbstractTargetBuilder]:
        return [TransfuserTargetBuilder(self._config)]

    def features_to_device(self, features: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batched feature dict as tensors on the agent's device. Cameras
        stay uint8 (the device normalizes them); status becomes float32."""
        out = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in features.items()}
        out["status_feature"] = out["status_feature"].float()
        return out

    def preprocess(self, tensors: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(camera, lidar BEV) model inputs from raw or cached features on the device."""
        cfg = self._config
        if "camera_l0" in tensors:  # raw path: stitch/resize + BEV splat on the device
            camera = stitch_cameras(tensors["camera_l0"], tensors["camera_f0"], tensors["camera_r0"],
                                    cfg.camera_height, cfg.camera_width)
            return camera, lidar_bev(tensors["lidar_points"], tensors["lidar_valid"], cfg)
        return tensors["camera_feature"], tensors["lidar_feature"].float()

    def set_mesh(self, mesh: Optional[Sequence[Union[str, torch.device]]]) -> None:
        """Split the forward's rows over the devices of `mesh` (None or an
        empty list: the agent's device alone). Callers pad the batch to a
        multiple of its length (the runner does)."""
        self._mesh = [canonical_device(d) for d in mesh] if mesh else None

    def predict(self, tensors: Mapping[str, torch.Tensor],
                diffusion_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The eval forward on device tensors; outputs stay on the device.
        `diffusion_noise` (the head's noise: (B, modes, poses, 2) for the
        diffusion head, (B, poses, 3) for the UNet) fixes the trajectory
        head's draw, else it is drawn for the whole batch from the generator
        re-seeded to 7 (the MLP head draws nothing). The rows are split over
        the device list of `set_mesh` (default: the agent's device): each
        device's replica preprocesses and runs its rows, and the outputs are
        gathered on the first device."""
        self.initialize()
        mesh = self._mesh or [self.device]
        if diffusion_noise is None:
            diffusion_noise = self.model.trajectory_head.draw_noise(len(tensors["status_feature"]),
                                                                    self._generator.manual_seed(_NOISE_SEED))
        noise = {} if diffusion_noise is None else {"noise": diffusion_noise}
        chunks = split_rows({**tensors, **noise}, mesh)
        outs = []
        with torch.no_grad():
            for dev, model, chunk in zip(mesh, replicas(self.model, mesh, self._replicas), chunks):
                with device_scope(dev):
                    camera, lidar = self.preprocess(chunk)
                    outs.append(model(camera, lidar, chunk["status_feature"], diffusion_noise=chunk.get("noise")))
        return gather_rows(outs)

    def forward(self, features: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = self.predict(self.features_to_device(features))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def compute_loss(self, features, targets, predictions):
        return transfuser_loss(targets, predictions, self._config)["loss"]

    def get_optimizers(self):
        """(AdamW, LambdaLR) over the model's parameters, the image encoder's
        group at `cfg_lr_mult`."""
        self.initialize()
        opt_cfg = OptimizerConfig(lr=self._lr, weight_decay=self._config.weight_decay,
                                  image_encoder_lr_mult=self._config.cfg_lr_mult)
        return build_optimizer(opt_cfg, self.model)

    def get_training_callbacks(self, output_dir=None):
        """The epoch timer, and with `output_dir` the BEV visualisation
        tiles under `<output_dir>/viz`, as the JAX agent's."""
        callbacks = [TimeLoggingCallback()]
        if output_dir is not None:
            callbacks.append(BEVVisualizationCallback(str(Path(output_dir) / "viz")))
        return callbacks
