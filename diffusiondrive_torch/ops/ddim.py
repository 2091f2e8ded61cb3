"""DDIM scheduler (scaled-linear betas, sample prediction, eta=0).

Counterpart of `diffusiondrive_tpu/ops/ddim.py`: the same float64 schedule
rounded once to a float32 `alphas_cumprod` table, so both packages index
identical constants. `add_noise` indexes the table on the tensor's device
(copied there once per device: a host-to-device copy synchronises the
stream); `step` takes a Python timestep and reads its float32 coefficients
on the host. Both compute in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """Immutable DDIM schedule."""

    num_train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "sample"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True

    alphas_cumprod: np.ndarray = dataclasses.field(init=False, repr=False, default=None)
    final_alpha_cumprod: float = dataclasses.field(init=False, repr=False, default=1.0)
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        init=False, repr=False, compare=False, default_factory=dict)

    def __post_init__(self):
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5,
                                self.num_train_timesteps, dtype=np.float64) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, self.num_train_timesteps, dtype=np.float64)
        else:
            raise ValueError(f"Unsupported beta schedule: {self.beta_schedule}")
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        object.__setattr__(self, "alphas_cumprod", alphas_cumprod)
        object.__setattr__(self, "final_alpha_cumprod",
                           1.0 if self.set_alpha_to_one else float(alphas_cumprod[0]))

    def _table(self, device: torch.device) -> torch.Tensor:
        table = self._tables.get(device)
        if table is None:
            table = self._tables[device] = torch.from_numpy(self.alphas_cumprod).to(device)
        return table

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_t) x_0 + sqrt(1 - a_t) eps; `timesteps` (B,) int."""
        a_t = self._table(original_samples.device)[timesteps.to(original_samples.device)]
        a_t = a_t.reshape(a_t.shape + (1,) * (original_samples.dim() - a_t.dim()))
        return torch.sqrt(a_t) * original_samples + torch.sqrt(1.0 - a_t) * noise

    def step(self, model_output: torch.Tensor, timestep: int, sample: torch.Tensor,
             num_inference_steps: int = 1000) -> torch.Tensor:
        """One deterministic (eta=0) DDIM update; returns prev_sample."""
        one = np.float32(1.0)
        prev_t = int(timestep) - self.num_train_timesteps // num_inference_steps
        alpha_prod_t = self.alphas_cumprod[int(timestep)]
        alpha_prod_t_prev = (self.alphas_cumprod[prev_t] if prev_t >= 0
                             else np.float32(self.final_alpha_cumprod))
        beta_prod_t = one - alpha_prod_t
        sqrt_a_t = float(np.sqrt(alpha_prod_t))

        if self.prediction_type == "sample":
            pred_original_sample = model_output
        elif self.prediction_type == "epsilon":
            pred_original_sample = (sample - float(np.sqrt(beta_prod_t)) * model_output) / sqrt_a_t
        else:
            raise ValueError(f"Unsupported prediction type: {self.prediction_type}")

        if self.clip_sample:
            pred_original_sample = pred_original_sample.clamp(-self.clip_sample_range, self.clip_sample_range)

        pred_epsilon = (sample - sqrt_a_t * pred_original_sample) / float(np.sqrt(beta_prod_t))
        pred_sample_direction = float(np.sqrt(one - alpha_prod_t_prev)) * pred_epsilon
        return float(np.sqrt(alpha_prod_t_prev)) * pred_original_sample + pred_sample_direction

    def rollout_timesteps(self, num_inference_steps: int) -> Tuple[int, ...]:
        """The full DDIM schedule with "leading" spacing: descending
        ``arange(n) * (T // n)``, e.g. (950, 900, ..., 50, 0) for 20 steps."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return tuple(int(t) for t in ts)

    def truncated_rollout_timesteps(self, num_steps: int = 2, span: int = 20) -> Tuple[int, ...]:
        """Descending ``(arange(num_steps) * span/num_steps).round()``, e.g. (10, 0)."""
        ratio = span / num_steps
        ts = np.round(np.arange(num_steps) * ratio)[::-1].astype(np.int64)
        return tuple(int(t) for t in ts)
