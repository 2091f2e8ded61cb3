"""Ego-state array helpers: 11-field dynamic state <-> footprint corners.

Copy of `diffusiondrive_tpu/evaluate/state_array.py` (numpy or torch through
the `xp` parameter), with the ego vehicle's parameters
(`VehicleParameters`, `get_pacifica_parameters`) of
`diffusiondrive_tpu/evaluate/vehicle.py`: the public Chrysler Pacifica spec
of nuplan-devkit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from diffusiondrive_torch.common.enums import BBCoordsIndex, StateIndex


@dataclass(frozen=True)
class VehicleParameters:
    width: float
    front_length: float   # [m] rear axle to front bumper (nuplan convention)
    rear_length: float    # [m] rear axle to rear bumper
    wheel_base: float
    cog_position_from_rear_axle: float
    height: float
    vehicle_name: str = "pacifica"

    @property
    def length(self) -> float:
        return self.front_length + self.rear_length

    @property
    def half_length(self) -> float:
        return self.length / 2.0

    @property
    def half_width(self) -> float:
        return self.width / 2.0

    @property
    def rear_axle_to_center(self) -> float:
        return self.half_length - self.rear_length


def get_pacifica_parameters() -> VehicleParameters:
    return VehicleParameters(width=2.297, front_length=4.049, rear_length=1.127, wheel_base=3.089,
                             cog_position_from_rear_axle=1.67, height=1.777)


def state_array_to_coords_array(states, vehicle: VehicleParameters = None, xp=np):
    """(..., 11) states -> (..., 5, 2) footprint coords (FL, RL, RR, FR,
    center); the center is the box center, `rear_axle_to_center` ahead of
    the rear axle along the heading."""
    vehicle = vehicle or get_pacifica_parameters()
    half_length, half_width, r2c = vehicle.half_length, vehicle.half_width, vehicle.rear_axle_to_center

    headings = states[..., StateIndex.HEADING]
    c, s = xp.cos(headings), xp.sin(headings)
    centers_x = states[..., StateIndex.X] + r2c * c
    centers_y = states[..., StateIndex.Y] + r2c * s

    # lateral unit vector = (cos(h + pi/2), sin(h + pi/2)) = (-s, c)
    def corner(lon, lat):
        return xp.stack([centers_x + lon * c - lat * s, centers_y + lon * s + lat * c], axis=-1)

    fl = corner(half_length, half_width)
    rl = corner(-half_length, half_width)
    rr = corner(-half_length, -half_width)
    fr = corner(half_length, -half_width)
    center = xp.stack([centers_x, centers_y], axis=-1)
    return xp.stack([fl, rl, rr, fr, center], axis=-2)


def coords_to_exterior(coords, xp=np):
    """(..., 5, 2) coords -> the closed 5-vertex ring FL, RL, RR, FR, FL (the
    center slot replaced by FRONT_LEFT)."""
    fl = coords[..., BBCoordsIndex.FRONT_LEFT:BBCoordsIndex.FRONT_LEFT + 1, :]
    return xp.concatenate([coords[..., :BBCoordsIndex.CENTER, :], fl], axis=-2)


def box_to_corners(center_x, center_y, heading, length, width, xp=np):
    """Oriented box parameters -> (..., 4, 2) corners (FL, RL, RR, FR)."""
    c, s = xp.cos(heading), xp.sin(heading)
    hl, hw = length / 2.0, width / 2.0

    def corner(lon, lat):
        return xp.stack([center_x + lon * c - lat * s, center_y + lon * s + lat * c], axis=-1)

    return xp.stack([corner(hl, hw), corner(-hl, hw), corner(-hl, -hw), corner(hl, -hw)], axis=-2)
