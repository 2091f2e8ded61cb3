"""Batched LQR-tracked kinematic-bicycle re-simulation (counterpart of
`diffusiondrive_tpu/evaluate/simulator.py`).

Parity targets:
- `pdm_planner/simulation/batch_kinematic_bicycle.py` (rear-axle bicycle,
  1st-order lag on accel tau=0.2 / steering tau=0.05, Euler integration,
  steering clip +-pi/3),
- `pdm_planner/simulation/batch_lqr.py` (decoupled longitudinal 1-state LQR +
  lateral 3-state LTV LQR over a 10-step horizon, stopping P-controller below
  0.2 m/s),
- `pdm_planner/simulation/batch_lqr_utils.py` (velocity/curvature profile
  estimation from poses via jerk/curvature-rate-regularized least squares),
- `pdm_planner/simulation/pdm_simulator.py` (the 40-step rollout).

The JAX rollout is one `lax.scan`; here it is a Python loop over the 40
steps, each a fixed sequence of elementwise launches over the whole batch
(scenes x proposals flattened), with no host sync: the profile fits use
`cholesky_ex(check_errors=False)` and triangular solves, and a matrix that
is not positive definite gives NaN, as `jnp.linalg.cholesky` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from diffusiondrive_torch.common.dataclasses import TrajectorySampling
from diffusiondrive_torch.common.enums import StateIndex
from diffusiondrive_torch.common.geometry import normalize_angle
from diffusiondrive_torch.evaluate.state_array import VehicleParameters, get_pacifica_parameters

INITIAL_CURVATURE_PENALTY = 1e-10


def _solve_spd(AtA: torch.Tensor, Aty: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via Cholesky: (B, M, M), (B, M) -> (B, M). A factor
    that fails (not PD) is NaN, as JAX's, and never checked on the host."""
    L, info = torch.linalg.cholesky_ex(AtA, check_errors=False)
    L = torch.where((info > 0)[:, None, None], torch.nan, L)
    z = torch.linalg.solve_triangular(L, Aty[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), z, upper=True)[..., 0]


# --------------------------------------------------------------------------- #
# Velocity / curvature profile estimation (batch_lqr_utils.py)
# --------------------------------------------------------------------------- #


def _generate_profile(initial: torch.Tensor, derivatives: torch.Tensor, dt: float) -> torch.Tensor:
    """Euler-integrate derivatives: (B,), (B, M-1) -> (B, M)."""
    cumsum = (derivatives * dt).cumsum(-1)
    return torch.cat([initial[:, None], initial[:, None] + cumsum], dim=-1)


@functools.lru_cache(maxsize=None)
def _velocity_fit_constants(M: int, dtype: torch.dtype, device: torch.device):
    """(keep mask (2M, M), RᵀR (M, M)) of the velocity fit, on `device` once.

    The jerk regularizer R = [0 | banded] of shape (M-2, M) is replicated
    EXACTLY from the reference (`batch_lqr_utils.py:_make_banded_difference_matrix`):
    the second assignment there OVERWRITES the +1 band it just set, so every
    row but the last penalizes -a_i directly and only the last row is a true
    difference a_{M-2} - a_{M-3}. A textbook difference matrix shifts fitted
    velocities by ~4%."""
    row_i = np.repeat(np.arange(M), 2)                     # displacement index per row
    col_j = np.arange(M)
    keep = ~(col_j[None, :] > row_i[:, None])              # zero where j > i (cols >= 1)
    keep[:, 0] = True
    banded = np.zeros((M - 2, M - 1))
    banded[:, 1:] = np.eye(M - 2)
    banded[:, :-1] = -np.eye(M - 2)
    R = np.concatenate([np.zeros((M - 2, 1)), banded], axis=1)
    # R holds 0 and +-1, so RᵀR is exact in any float dtype
    return (torch.from_numpy(keep).to(dtype).to(device), torch.from_numpy(R.T @ R).to(dtype).to(device))


def fit_velocity_and_acceleration(
    xy_displacements: torch.Tensor,  # (B, M, 2)
    heading_profile: torch.Tensor,   # (B, M) headings at the starting pose of each displacement
    dt: float,
    jerk_penalty: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least squares [v_0, a_0..a_{M-2}] with jerk regularization
    (`_fit_initial_velocity_and_acceleration_profile`)."""
    B, M, _ = xy_displacements.shape
    y = xy_displacements.reshape(B, 2 * M)
    keep, RtR = _velocity_fit_constants(M, y.dtype, y.device)

    # a_col[b, 2i] = cos h_i, a_col[b, 2i+1] = sin h_i
    a_col = torch.stack([heading_profile.cos(), heading_profile.sin()], dim=-1).reshape(B, 2 * M)
    # A[b, 2i+c, 0] = u_i * dt ; A[b, 2i+c, j>=1] = u_i * dt^2 for j <= i else 0
    A = torch.cat([(a_col * dt)[..., None], (a_col[..., None] * dt ** 2).expand(B, 2 * M, M - 1)], dim=-1)
    A = A * keep

    AtA = A.transpose(1, 2) @ A + jerk_penalty * RtR
    Aty = (A.transpose(1, 2) @ y[..., None])[..., 0]
    x = _solve_spd(AtA, Aty)
    return x[:, 0], x[:, 1:]


@functools.lru_cache(maxsize=None)
def _curvature_fit_constants(M: int, curvature_rate_penalty: float, dtype: torch.dtype, device: torch.device):
    """(lower-triangular ones (M, M), Q (M, M)) of the curvature fit, on `device` once."""
    Q = curvature_rate_penalty * np.eye(M)
    Q[0, 0] = INITIAL_CURVATURE_PENALTY
    return (torch.from_numpy(np.tril(np.ones((M, M)))).to(dtype).to(device),
            torch.from_numpy(Q).to(dtype).to(device))


def fit_curvature_and_curvature_rate(
    heading_displacements: torch.Tensor,  # (B, M)
    velocity_profile: torch.Tensor,       # (B, M)
    dt: float,
    curvature_rate_penalty: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least squares [k_0, kdot_0..kdot_{M-2}] with curvature-rate
    regularization (`_fit_initial_curvature_and_curvature_rate_profile`)."""
    B, M = heading_displacements.shape
    y = heading_displacements
    tril, Q = _curvature_fit_constants(M, float(curvature_rate_penalty), y.dtype, y.device)

    A = tril.expand(B, M, M).clone()
    A[:, :, 0] = velocity_profile * dt
    scale = velocity_profile * dt ** 2  # (B, M)
    A[:, 1:, 1:] *= scale[:, 1:, None]

    AtA = A.transpose(1, 2) @ A + Q
    Aty = (A.transpose(1, 2) @ y[..., None])[..., 0]
    x = _solve_spd(AtA, Aty)
    return x[:, 0], x[:, 1:]


def velocity_curvature_profiles_from_poses(
    poses: torch.Tensor, dt: float, jerk_penalty: float, curvature_rate_penalty: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N+1, 3) poses -> velocity (B, N) and curvature (B, N) profiles."""
    diffs = poses.diff(dim=1)
    xy_displacements = diffs[..., :2]
    heading_displacements = normalize_angle(diffs[..., 2], xp=torch)

    v0, accel = fit_velocity_and_acceleration(xy_displacements, poses[:, :-1, 2], dt, jerk_penalty)
    velocity = _generate_profile(v0, accel, dt)
    k0, k_rate = fit_curvature_and_curvature_rate(heading_displacements, velocity, dt, curvature_rate_penalty)
    curvature = _generate_profile(k0, k_rate, dt)
    return velocity, curvature


# --------------------------------------------------------------------------- #
# LQR tracker (batch_lqr.py)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LQRParams:
    q_longitudinal: float = 10.0
    r_longitudinal: float = 1.0
    q_lateral: Tuple[float, float, float] = (1.0, 10.0, 0.0)
    r_lateral: float = 1.0
    discretization_time: float = 0.1
    tracking_horizon: int = 10
    jerk_penalty: float = 1e-4
    curvature_rate_penalty: float = 1e-2
    stopping_proportional_gain: float = 0.5
    stopping_velocity: float = 0.2


@functools.lru_cache(maxsize=None)
def _horizon_steps(H: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """0..H-1 in `dtype` on `device`, once."""
    return torch.arange(H, dtype=dtype).to(device)


def lqr_track_step(
    params: LQRParams,
    wheel_base: float,
    current_states: torch.Tensor,        # (B, 11) simulated states at time t
    reference_states: torch.Tensor,      # (B, 11) proposal states at time t
    reference_velocities: torch.Tensor,  # (B,) velocity at the lookahead index
    curvature_profiles: torch.Tensor,    # (B, H) curvature window starting at t
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tracking step -> (accel_cmd, steering_rate_cmd), each (B,)."""
    dt, H = params.discretization_time, params.tracking_horizon

    # Initial velocity + Frenet lateral state
    x_err = current_states[:, StateIndex.X] - reference_states[:, StateIndex.X]
    y_err = current_states[:, StateIndex.Y] - reference_states[:, StateIndex.Y]
    head_ref = reference_states[:, StateIndex.HEADING]
    lateral_err = -x_err * head_ref.sin() + y_err * head_ref.cos()
    heading_err = normalize_angle(current_states[:, StateIndex.HEADING] - head_ref, xp=torch)
    v0 = current_states[:, StateIndex.VELOCITY_X]
    steering = current_states[:, StateIndex.STEERING_ANGLE]

    # Stopping P-controller
    should_stop = (reference_velocities <= params.stopping_velocity) & (v0 <= params.stopping_velocity)
    stop_accel = -params.stopping_proportional_gain * (v0 - reference_velocities)

    # Longitudinal 1-step LQR: v_N = v_0 + (H*dt) a
    Blon = H * dt
    err0 = v0 - reference_velocities
    lqr_accel = (-1.0 / (Blon * params.q_longitudinal * Blon + params.r_longitudinal)) * (
        Blon * params.q_longitudinal * err0
    )

    accel_cmd = torch.where(should_stop, stop_accel, lqr_accel)

    # Velocity profile under constant accel over the horizon (length H)
    steps = _horizon_steps(H, v0.dtype, v0.device)
    velocity_profile = v0[:, None] + accel_cmd[:, None] * steps[None, :] * dt  # (B, H)

    # Lateral LTV composition over the H-step horizon, in closed form (see the
    # JAX module): with a_k = v_k dt, b_k = v_k dt / L, sufa_j = sum_{i>j} a_i
    # and gamma_k = -v_k c_k dt, the composed system is
    #   A = I + (sum a) E01 + (sum b) E12 + (sum_{i>j} a_i b_j) E02,
    #   B = dt * [sum_j j b_j sufa_j, sum_j j b_j, H],
    #   g = [sum_k gamma_k sufa_k, sum_k gamma_k, 0].
    a = velocity_profile * dt                               # (B, H)
    b = velocity_profile * (dt / wheel_base)                # (B, H)
    gamma = -velocity_profile * curvature_profiles * dt     # (B, H)
    sum_a = a.sum(-1)
    sum_b = b.sum(-1)
    sufa = sum_a[:, None] - a.cumsum(-1)                    # (B, H): sum_{i>j} a_i
    cross = (sufa * b).sum(-1)                              # sum_{i>j} a_i b_j
    kb = steps * b

    B0 = dt * (kb * sufa).sum(-1)
    B1 = dt * kb.sum(-1)
    B2 = H * dt

    # err = A @ lat_state + g, heading and steering terms wrapped
    err0 = lateral_err + sum_a * heading_err + cross * steering + (gamma * sufa).sum(-1)
    err1 = normalize_angle(heading_err + sum_b * steering + gamma.sum(-1), xp=torch)
    err2 = normalize_angle(steering, xp=torch)

    q0, q1, q2 = params.q_lateral
    inv = -1.0 / (B0 * q0 * B0 + B1 * q1 * B1 + B2 * q2 * B2 + params.r_lateral)
    tail = B0 * q0 * err0 + B1 * q1 * err1 + B2 * q2 * err2
    steering_rate_cmd = torch.where(should_stop, 0.0, inv * tail)
    return accel_cmd, steering_rate_cmd


# --------------------------------------------------------------------------- #
# Kinematic bicycle model (batch_kinematic_bicycle.py)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class BicycleParams:
    max_steering_angle: float = float(np.pi / 3)
    accel_time_constant: float = 0.2
    steering_angle_time_constant: float = 0.05


def bicycle_propagate(
    params: BicycleParams,
    vehicle: VehicleParameters,
    states: torch.Tensor,          # (B, 11)
    accel_cmds: torch.Tensor,      # (B,)
    steering_rate_cmds: torch.Tensor,  # (B,)
    dt: float,
) -> torch.Tensor:
    """One Euler step of the rear-axle bicycle with 1st-order command lag."""
    S = StateIndex
    accel = states[:, S.ACCELERATION_X]
    steering_angle = states[:, S.STEERING_ANGLE]

    ideal_steering = dt * steering_rate_cmds + steering_angle
    updated_accel = dt / (dt + params.accel_time_constant) * (accel_cmds - accel) + accel
    updated_steering = (
        dt / (dt + params.steering_angle_time_constant) * (ideal_steering - steering_angle) + steering_angle
    )
    updated_steering_rate = (updated_steering - steering_angle) / dt

    vx = states[:, S.VELOCITY_X]
    heading = states[:, S.HEADING]

    new_vx = vx + updated_accel * dt
    # lateral velocity is zero in the bicycle model
    new_steering = (steering_angle + updated_steering_rate * dt).clamp(
        -params.max_steering_angle, params.max_steering_angle)
    new_angular_velocity = new_vx * new_steering.tan() / vehicle.wheel_base
    zeros = torch.zeros_like(vx)
    # one stacked write in StateIndex order (X..ANGULAR_ACCELERATION)
    return torch.stack(
        [
            states[:, S.X] + vx * heading.cos() * dt,
            states[:, S.Y] + vx * heading.sin() * dt,
            normalize_angle(heading + vx * steering_angle.tan() / vehicle.wheel_base * dt, xp=torch),
            new_vx,
            zeros,                                   # VELOCITY_Y
            updated_accel,                           # ACCELERATION_X
            zeros,                                   # ACCELERATION_Y
            new_steering,
            updated_steering_rate,
            new_angular_velocity,
            (new_angular_velocity - states[:, S.ANGULAR_VELOCITY]) / dt,
        ],
        dim=-1,
    )


# --------------------------------------------------------------------------- #
# PDM simulator (pdm_simulator.py)
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _lookahead_indices(num_poses: int, H: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reference velocity index (N,), curvature window index (N, H)) on `device` once:
    ref_velocity[t] = velocity[min(t+H, N-1)], window[t, k] = curvature[min(t+k, N-1)]."""
    t_idx = np.arange(num_poses)
    ref_v_idx = np.minimum(t_idx + H, num_poses - 1)
    win_idx = np.minimum(t_idx[:, None] + np.arange(H)[None, :], num_poses - 1)
    return torch.from_numpy(ref_v_idx).to(device), torch.from_numpy(win_idx).to(device)


@dataclasses.dataclass(frozen=True)
class PDMSimulator:
    """Batch re-simulation of proposals."""

    proposal_sampling: TrajectorySampling
    lqr: LQRParams = LQRParams()
    bicycle: BicycleParams = BicycleParams()
    vehicle: VehicleParameters = dataclasses.field(default_factory=get_pacifica_parameters)

    def simulate_proposals(self, states: torch.Tensor, initial_state: torch.Tensor) -> torch.Tensor:
        """
        :param states: (..., >=N+1, 11) proposal state arrays (absolute frame);
            any batch dims, e.g. (scenes, proposals)
        :param initial_state: (..., 11) current ego state array, broadcast
            against the batch dims (JAX's (11,); (scenes, 1, 11) per scene)
        :return: (..., N+1, 11) simulated states
        """
        num_poses = self.proposal_sampling.num_poses
        dt = self.proposal_sampling.interval_length
        lqr = dataclasses.replace(self.lqr, discretization_time=dt)
        H = lqr.tracking_horizon

        batch_shape = states.shape[:-2]
        proposal_states = states[..., : num_poses + 1, :].reshape(-1, num_poses + 1, states.shape[-1])
        B = proposal_states.shape[0]

        velocity, curvature = velocity_curvature_profiles_from_poses(
            proposal_states[..., StateIndex.STATE_SE2], dt, lqr.jerk_penalty, lqr.curvature_rate_penalty
        )  # (B, N), (B, N)

        ref_v_idx, win_idx = _lookahead_indices(num_poses, H, velocity.device)
        ref_velocities = velocity[:, ref_v_idx]                       # (B, N)
        curv_windows = curvature[:, win_idx]                          # (B, N, H)

        init = initial_state.to(proposal_states.dtype).expand(*batch_shape, initial_state.shape[-1])
        current = init.reshape(B, -1)
        rollout = [current]
        for t in range(num_poses):
            accel, steer_rate = lqr_track_step(
                lqr, self.vehicle.wheel_base, current, proposal_states[:, t], ref_velocities[:, t],
                curv_windows[:, t])
            current = bicycle_propagate(self.bicycle, self.vehicle, current, accel, steer_rate, dt)
            rollout.append(current)
        return torch.stack(rollout, dim=1).reshape(*batch_shape, num_poses + 1, -1)
