"""Flow-matching Euler schedule (the port's own numpy copy of
vorta_tpu/schedulers/flow_match.py).

  sigma(t) = t / T on a linspace grid, then time-shifted
  sigma' = shift * sigma / (1 + (shift - 1) * sigma)
  x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v_theta(x_i, t_i)

``train_sigmas`` is the trainer's table of shifted sigmas over every
training timestep.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def time_shift(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerSchedule:
    """Precomputed sigma/timestep tables for one sampling run."""

    sigmas: np.ndarray  # (N + 1,), last entry 0
    timesteps: np.ndarray  # (N,), in train-timestep units (0..T)
    num_train_timesteps: int = 1000

    @classmethod
    def create(cls, num_inference_steps: int, shift: float = 5.0,
               num_train_timesteps: int = 1000) -> "FlowMatchEulerSchedule":
        t = np.linspace(num_train_timesteps, 1.0, num_inference_steps, dtype=np.float64)
        sigmas = time_shift(t / num_train_timesteps, shift)
        timesteps = sigmas * num_train_timesteps
        sigmas = np.append(sigmas, 0.0)
        return cls(sigmas=sigmas.astype(np.float32), timesteps=timesteps.astype(np.float32),
                   num_train_timesteps=num_train_timesteps)

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def step(self, x, velocity, i: int):
        """One Euler step on a tensor or an array, dt in f32."""
        dt = np.float32(self.sigmas[i + 1] - self.sigmas[i])
        return x + float(dt) * velocity


def train_sigmas(shift: float = 5.0, num_train_timesteps: int = 1000) -> np.ndarray:
    """The training-time sigma table indexed by integer timestep order
    (descending timesteps T..1), as the trainer reads it (vorta_tpu's
    ``train_sigmas``)."""
    t = np.linspace(num_train_timesteps, 1.0, num_train_timesteps, dtype=np.float64)
    return time_shift(t / num_train_timesteps, shift).astype(np.float32)
