"""High-level plotting entry points.

Parity: `navsim/visualization/plots.py` — BEV frame plots, agent-vs-human
trajectory comparisons, frame sequence -> GIF.

Counterpart of `diffusiondrive_tpu/visualization/plots.py`: host code,
matplotlib and PIL imported inside the functions.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from diffusiondrive_torch.agents.abstract_agent import AbstractAgent
from diffusiondrive_torch.common.dataclasses import Scene
from diffusiondrive_torch.visualization.bev import (
    add_configured_bev_on_ax,
    add_trajectory_to_bev_ax,
    render_bev_semantic_map,
)
from diffusiondrive_torch.visualization.config import BEV_PLOT_CONFIG


def _new_ax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=BEV_PLOT_CONFIG["figure_size"])
    return fig, ax


def plot_bev_frame(scene: Scene, frame_idx: Optional[int] = None):
    """BEV plot of one frame."""
    fig, ax = _new_ax()
    add_configured_bev_on_ax(ax, scene, frame_idx)
    fig.tight_layout()
    return fig, ax


def plot_bev_with_agent(scene: Scene, agent: AbstractAgent):
    """BEV plot comparing the agent trajectory to the human trajectory."""
    human_trajectory = scene.get_future_trajectory()
    if agent.requires_scene:
        agent_trajectory = agent.compute_trajectory(scene.get_agent_input(), scene)
    else:
        agent_trajectory = agent.compute_trajectory(scene.get_agent_input())

    fig, ax = _new_ax()
    add_configured_bev_on_ax(ax, scene)
    add_trajectory_to_bev_ax(ax, human_trajectory, "human")
    add_trajectory_to_bev_ax(ax, agent_trajectory, "agent")
    fig.tight_layout()
    return fig, ax


_CAMERA_GRID = [
    ["cam_l0", "cam_f0", "cam_r0"],
    ["cam_l1", None, "cam_r1"],      # center tile = BEV
    ["cam_l2", "cam_b0", "cam_r2"],
]


def plot_cameras_frame(scene: Scene, frame_idx: Optional[int] = None, overlay: Optional[str] = None):
    """3x3 grid: 8 cameras around a BEV center tile
    (`plots.py:plot_cameras_frame{,_with_lidar,_with_annotations}`).

    :param overlay: None (raw images), "lidar" (depth-colored point
        projection), or "annotations" (projected 3D boxes + GT trajectory).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from diffusiondrive_torch.visualization.camera import (
        add_annotations_to_camera,
        add_lidar_to_camera,
        add_trajectory_to_camera,
    )

    frame_idx = frame_idx if frame_idx is not None else scene.scene_metadata.num_history_frames - 1
    frame = scene.frames[frame_idx]
    future = None
    if overlay == "annotations" and frame_idx == scene.scene_metadata.num_history_frames - 1:
        try:
            future = scene.get_future_trajectory()
        except Exception:  # end-of-log frames have no future
            future = None

    fig, axes = plt.subplots(3, 3, figsize=(12, 6))
    for r, row in enumerate(_CAMERA_GRID):
        for c, name in enumerate(row):
            ax = axes[r, c]
            if name is None:
                add_configured_bev_on_ax(ax, scene, frame_idx)
                ax.set_aspect("equal")
                continue
            camera = getattr(frame.cameras, name)
            if camera.image is None:
                ax.set_facecolor("#202020")
            else:
                image = camera.image
                if overlay == "lidar" and frame.lidar is not None:
                    image = add_lidar_to_camera(image, camera, frame.lidar)
                elif overlay == "annotations":
                    image = add_annotations_to_camera(
                        image, camera, frame.annotations.boxes, frame.annotations.names
                    )
                    if future is not None:
                        image = add_trajectory_to_camera(image, camera, future.poses)
                ax.imshow(image)
            ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    fig.subplots_adjust(wspace=0.01, hspace=0.01, left=0.01, right=0.99, top=0.99, bottom=0.01)
    return fig, axes


def plot_cameras_frame_with_lidar(scene: Scene, frame_idx: Optional[int] = None):
    return plot_cameras_frame(scene, frame_idx, overlay="lidar")


def plot_cameras_frame_with_annotations(scene: Scene, frame_idx: Optional[int] = None):
    return plot_cameras_frame(scene, frame_idx, overlay="annotations")


def frame_plot_to_image(callable_frame_plot: Callable, scene: Scene, frame_idx: int) -> np.ndarray:
    """Render one frame plot to an (H, W, 3) uint8 array."""
    import matplotlib.pyplot as plt

    fig, ax = callable_frame_plot(scene, frame_idx)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def frame_plot_to_gif(
    file_name: str,
    callable_frame_plot: Callable,
    scene: Scene,
    frame_indices: Optional[List[int]] = None,
    duration: float = 500,
) -> None:
    """Render several frames and write an animated GIF."""
    from PIL import Image

    frame_indices = frame_indices if frame_indices is not None else list(range(len(scene.frames)))
    images = [
        Image.fromarray(frame_plot_to_image(callable_frame_plot, scene, idx)) for idx in frame_indices
    ]
    Path(file_name).parent.mkdir(parents=True, exist_ok=True)
    images[0].save(file_name, save_all=True, append_images=images[1:], duration=duration, loop=0)


def plot_bev_semantic_comparison(gt_map: np.ndarray, pred_logits: np.ndarray):
    """Side-by-side GT vs argmax-predicted BEV semantic raster."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred = np.argmax(pred_logits, axis=-1) if pred_logits.ndim == 3 else pred_logits
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].imshow(render_bev_semantic_map(gt_map))
    axes[0].set_title("GT")
    axes[1].imshow(render_bev_semantic_map(pred))
    axes[1].set_title("Predicted")
    for ax in axes:
        ax.set_xticks([]), ax.set_yticks([])
    fig.tight_layout()
    return fig, axes
