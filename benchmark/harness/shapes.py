"""The shapes at which the model launches its hand-written kernels, from
the configuration as run: what the kernel files count their work at."""

from __future__ import annotations

from typing import List, Tuple

from benchmark.reference.model import RESNETS


def branches(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """(architecture, input height, width, channels) of the image and lidar branches."""
    return [(cfg["image_architecture"], cfg["camera_height"], cfg["camera_width"], 3),
            (cfg["lidar_architecture"], cfg["lidar_resolution_height"], cfg["lidar_resolution_width"], 1)]


def layer1_convs(cfg: dict) -> List[Tuple[int, int, int]]:
    """(H, W, blocks) of each branch's first stage where its 3x3 convs take
    the conv3x3 kernel: basic blocks, 64 channels, stride 1."""
    out = []
    for arch, h, w, _ in branches(cfg):
        kind, sizes, _, _ = RESNETS[arch]
        if kind == "basic":
            out.append((h // 4, w // 4, sizes[0]))
    return out


def attention_stages(cfg: dict) -> List[Tuple[int, int, int]]:
    """(heads, tokens, head width) of each GPT fusion stage whose attention
    the fused kernel takes (8 <= T <= 512, T % 8 == 0, 8 <= D <= 256)."""
    T = cfg["img_vert_anchors"] * cfg["img_horz_anchors"] + cfg["lidar_vert_anchors"] * cfg["lidar_horz_anchors"]
    H = cfg["n_head"]
    out = []
    for C in RESNETS[cfg["image_architecture"]][3]:
        D = C // H
        if 8 <= T <= 512 and T % 8 == 0 and 8 <= D <= 256:
            out.append((H, T, D))
    return out
