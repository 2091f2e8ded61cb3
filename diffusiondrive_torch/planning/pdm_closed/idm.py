"""Batched IDM longitudinal policies + proposal bookkeeping.

Parity: `pdm_planner/proposal/batch_idm_policy.py` (vectorized IDM ODE with
acceleration exponent 10 and s* gap law) and
`pdm_planner/proposal/pdm_proposal.py` (lateral x longitudinal proposal
cross-product).

Copy of `diffusiondrive_tpu/planning/pdm_closed/idm.py` (numpy on the host, as there).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np

from diffusiondrive_torch.planning.pdm_closed.pdm_path import PDMPath

ACCELERATION_EXPONENT = 10


def _as_array(value: Union[float, Sequence[float]], n: int) -> np.ndarray:
    if isinstance(value, (int, float)):
        return np.full(n, float(value))
    return np.asarray(value, dtype=np.float64)


class BatchIDMPolicy:
    """A bank of IDM policies propagated over a batch of proposals."""

    def __init__(
        self,
        fallback_target_velocity: Union[float, Sequence[float]] = 15.0,
        speed_limit_fraction: Union[float, Sequence[float]] = (0.2, 0.4, 0.6, 0.8, 1.0),
        min_gap_to_lead_agent: Union[float, Sequence[float]] = 1.0,
        headway_time: Union[float, Sequence[float]] = 1.5,
        accel_max: Union[float, Sequence[float]] = 1.5,
        decel_max: Union[float, Sequence[float]] = 3.0,
    ):
        lengths = [len(v) for v in (fallback_target_velocity, speed_limit_fraction, min_gap_to_lead_agent,
                                    headway_time, accel_max, decel_max) if hasattr(v, "__len__")]
        assert not lengths or all(l == lengths[0] for l in lengths), "IDM parameter lists must match"
        n = lengths[0] if lengths else 1

        self._fallback_target_velocities = _as_array(fallback_target_velocity, n)
        self._speed_limit_fractions = _as_array(speed_limit_fraction, n)
        self._min_gap_to_lead_agent = _as_array(min_gap_to_lead_agent, n)
        self._headway_time = _as_array(headway_time, n)
        self._accel_max = _as_array(accel_max, n)
        self._decel_max = _as_array(decel_max, n)
        self._target_velocities = np.zeros(n)

    @property
    def num_policies(self) -> int:
        return len(self._target_velocities)

    @property
    def max_target_velocity(self) -> float:
        return float(np.max(self._target_velocities))

    def update(self, speed_limit_mps: float = None) -> None:
        if speed_limit_mps is not None:
            self._target_velocities = self._speed_limit_fractions * speed_limit_mps
        else:
            self._target_velocities = self._speed_limit_fractions * self._fallback_target_velocities

    def propagate(
        self,
        previous_idm_states: np.ndarray,   # (B, 2): progress, velocity
        leading_agent_states: np.ndarray,  # (B, 3): progress, velocity, rear length
        longitudinal_idcs: List[int],
        sampling_time: float,
    ) -> np.ndarray:
        x, v = previous_idm_states[:, 0], previous_idm_states[:, 1]
        x_lead, v_lead, l_r = (
            leading_agent_states[:, 0],
            leading_agent_states[:, 1],
            leading_agent_states[:, 2],
        )
        idcs = np.asarray(longitudinal_idcs)
        v0 = self._target_velocities[idcs]
        s0 = self._min_gap_to_lead_agent[idcs]
        T = self._headway_time[idcs]
        a_max = self._accel_max[idcs]
        b_max = self._decel_max[idcs]

        s_star = s0 + v * T + v * (v - v_lead) / (2 * np.sqrt(a_max * b_max))
        s_alpha = np.maximum(x_lead - x - l_r, s0)

        v_dot = a_max * (1 - (v / v0) ** ACCELERATION_EXPONENT - (s_star / s_alpha) ** 2)
        v_dot = np.clip(v_dot, -b_max, a_max)

        out = np.zeros_like(previous_idm_states)
        out[:, 0] = x + sampling_time * v
        out[:, 1] = v + sampling_time * v_dot
        return out


@dataclass
class PDMProposal:
    """One (lateral path, longitudinal policy) proposal."""

    proposal_idx: int
    lateral_idx: int
    longitudinal_idx: int
    path: PDMPath


class PDMProposalManager:
    """Cross-product of lateral paths and IDM policies."""

    def __init__(self, lateral_proposals: List[PDMPath], longitudinal_policies: BatchIDMPolicy):
        self._proposals: List[PDMProposal] = []
        self.longitudinal_policies = longitudinal_policies
        idx = 0
        for lateral_idx, path in enumerate(lateral_proposals):
            for longitudinal_idx in range(longitudinal_policies.num_policies):
                self._proposals.append(PDMProposal(idx, lateral_idx, longitudinal_idx, path))
                idx += 1

    def __len__(self) -> int:
        return len(self._proposals)

    def __getitem__(self, proposal_idx: int) -> PDMProposal:
        return self._proposals[proposal_idx]

    def update(self, speed_limit_mps: float = None) -> None:
        self.longitudinal_policies.update(speed_limit_mps)

    @property
    def max_target_velocity(self) -> float:
        return self.longitudinal_policies.max_target_velocity
