"""Visualisation (counterpart of `diffusiondrive_tpu/visualization/`): host
code, matplotlib and cv2 imported inside the functions."""

from diffusiondrive_torch.visualization.bev import (
    add_configured_bev_on_ax,
    add_trajectory_to_bev_ax,
    render_bev_semantic_map,
)
from diffusiondrive_torch.visualization.camera import (
    add_annotations_to_camera,
    add_lidar_to_camera,
    add_trajectory_to_camera,
    camera_tile,
    project_points_to_camera,
)
from diffusiondrive_torch.visualization.plots import (
    frame_plot_to_gif,
    frame_plot_to_image,
    plot_bev_frame,
    plot_bev_semantic_comparison,
    plot_bev_with_agent,
    plot_cameras_frame,
    plot_cameras_frame_with_annotations,
    plot_cameras_frame_with_lidar,
)
from diffusiondrive_torch.visualization.lidar import add_lidar_to_bev_ax, plot_lidar_bev
