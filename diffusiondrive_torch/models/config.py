"""Model hyperparameter config.

Copy of `diffusiondrive_tpu/models/config.py:TransfuserConfig` without the
TPU-only knobs `fused_conv_mode` and `fused_attention_mode`: in the port the
kernels are chosen by the tensor's device and the module's mode (see
`models/resnet.py`), and the GPT fusion attention is plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from diffusiondrive_torch.common.dataclasses import TrajectorySampling


@dataclass(frozen=True)
class TransfuserConfig:
    """Global config of the Transfuser/DiffusionDrive model family."""

    trajectory_sampling: TrajectorySampling = field(
        default_factory=lambda: TrajectorySampling(time_horizon=4, interval_length=0.5)
    )

    image_architecture: str = "resnet34"
    lidar_architecture: str = "resnet34"
    bkb_path: Optional[str] = None
    plan_anchor_path: Optional[str] = None

    latent: bool = False

    # Lidar BEV rasterization
    max_height_lidar: float = 100.0
    pixels_per_meter: float = 4.0
    hist_max_per_pixel: int = 5
    lidar_min_x: float = -32.0
    lidar_max_x: float = 32.0
    lidar_min_y: float = -32.0
    lidar_max_y: float = 32.0
    lidar_split_height: float = 0.2
    use_ground_plane: bool = False
    lidar_seq_len: int = 1

    # Camera stitching
    camera_width: int = 1024
    camera_height: int = 256
    lidar_resolution_width: int = 256
    lidar_resolution_height: int = 256

    # GPT fusion token grids
    img_vert_anchors: int = 256 // 32
    img_horz_anchors: int = 1024 // 32
    lidar_vert_anchors: int = 256 // 32
    lidar_horz_anchors: int = 256 // 32

    # GPT fusion transformer
    block_exp: int = 4
    n_layer: int = 2
    n_head: int = 4
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    gpt_linear_layer_init_mean: float = 0.0
    gpt_linear_layer_init_std: float = 0.02
    gpt_layer_norm_init_weight: float = 1.0

    detect_boxes: bool = True
    use_bev_semantic: bool = True

    # Main transformer decoder
    tf_d_model: int = 256
    tf_d_ffn: int = 1024
    tf_num_layers: int = 3
    tf_num_head: int = 8
    tf_dropout: float = 0.0

    # Detection head
    num_bounding_boxes: int = 30

    # Diffusion head
    ego_fut_mode: int = 20
    diff_decoder_layers: int = 2
    diffusion_train_max_t: int = 50
    diffusion_test_trunc_t: int = 8
    diffusion_test_steps: int = 2
    diffusion_test_span: int = 20

    # Vanilla diffusion-policy ablation head (not ported yet)
    unet_down_dims: Tuple[int, ...] = (256, 512, 1024)
    unet_test_steps: int = 20

    # Loss weights
    trajectory_weight: float = 12.0
    trajectory_cls_weight: float = 10.0
    trajectory_reg_weight: float = 8.0
    diff_loss_weight: float = 20.0
    agent_class_weight: float = 10.0
    agent_box_weight: float = 1.0
    bev_semantic_weight: float = 14.0

    # BEV semantic map
    num_bev_classes: int = 7
    bev_features_channels: int = 64
    bev_down_sample_factor: int = 4
    bev_upsample_factor: int = 2
    bev_pixel_width: int = 256
    bev_pixel_height: int = 128
    bev_pixel_size: float = 0.25

    # Optimizer
    weight_decay: float = 1e-4
    cfg_lr_mult: float = 0.5  # lr multiplier for the image encoder

    @property
    def bev_semantic_frame(self) -> Tuple[int, int]:
        return (self.bev_pixel_height, self.bev_pixel_width)

    @property
    def bev_radius(self) -> float:
        return max(abs(v) for v in (self.lidar_min_x, self.lidar_max_x, self.lidar_min_y, self.lidar_max_y))

    @property
    def lidar_in_channels(self) -> int:
        return (2 if self.use_ground_plane else 1) * self.lidar_seq_len

    @property
    def num_poses(self) -> int:
        return self.trajectory_sampling.num_poses
