"""The OSL prosthetic leg's impedance controller on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/osl.py``: the four-state gait
machine of MyoSuite's MyoOSLController with its published impedance gains,
transition thresholds and peak torques (the port keeps its own copy of the
tables). States: 0 early stance, 1 late stance, 2 early swing, 3 late
swing; any matching threshold advances a state to its successor.

Batch-first: ``state`` is [B] (integer), ``sens`` is [B, 5] with the
columns knee angle, knee velocity, ankle angle, ankle velocity and the
load cell's load.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_D = np.deg2rad

# per state: [knee_K, knee_B, knee_theta, ankle_K, ankle_B, ankle_theta]
GAINS = np.array([
    [99.372, 3.180, _D(5), 19.874, 0.000, _D(-2)],    # early stance
    [99.372, 1.272, _D(8), 79.498, 0.063, _D(-20)],   # late stance
    [39.749, 0.063, _D(60), 7.949, 0.000, _D(25)],    # early swing
    [15.899, 3.816, _D(5), 7.949, 0.000, _D(15)],     # late swing
])

PEAK_TORQUE = np.array([142.272, 168.192])  # knee, ankle (N m)


@dataclasses.dataclass(frozen=True)
class OSLParams:
  body_weight: float            # mass * 9.81
  # per-state gains [4, 6]; a caller may set its own
  gains: np.ndarray = dataclasses.field(default_factory=lambda: GAINS)
  # the gains and the peak torques as tensors, per (dtype, device)
  _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

  def tables(self, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(gains [4, 6], peak torques [2]) in ``dtype`` on ``device``."""
    key = (dtype, torch.device(device))
    if key not in self._tables:
      self._tables[key] = (
          torch.as_tensor(np.asarray(self.gains), dtype=dtype, device=device),
          torch.as_tensor(PEAK_TORQUE, dtype=dtype, device=device))
    return self._tables[key]


def transition(state: torch.Tensor, sens: torch.Tensor,
               p: OSLParams) -> torch.Tensor:
  """The next state [B]."""
  knee_angle, knee_vel, ankle_angle, load = (
      sens[:, 0], sens[:, 1], sens[:, 2], sens[:, 4])
  bw = p.body_weight
  adv = torch.where(
      state == 0, (load > 0.25 * bw) | (ankle_angle > _D(6)),
      torch.where(
          state == 1, load < 0.15 * bw,
          torch.where(state == 2,
                      (knee_angle > _D(50)) | (knee_vel < _D(3)),
                      (load > 0.4 * bw) | (knee_angle < _D(30)))))
  return torch.where(adv, torch.remainder(state + 1, 4), state)


def torque(state: torch.Tensor, sens: torch.Tensor,
           p: OSLParams) -> torch.Tensor:
  """[B, 2] knee and ankle impedance torques, clipped to the peaks."""
  gains, peak = p.tables(sens.dtype, sens.device)
  g = gains[state.long()]
  knee = g[:, 0] * (g[:, 2] - sens[:, 0]) - g[:, 1] * sens[:, 1]
  ankle = g[:, 3] * (g[:, 5] - sens[:, 2]) - g[:, 4] * sens[:, 3]
  return torch.clamp(torch.stack([knee, ankle], -1), -peak, peak)


def step(state: torch.Tensor, sens: torch.Tensor, p: OSLParams):
  """Advance the machine on fresh sensors, then the torques of the new
  state: (state [B], torques [B, 2])."""
  new_state = transition(state, sens, p)
  return new_state, torque(new_state, sens, p)
