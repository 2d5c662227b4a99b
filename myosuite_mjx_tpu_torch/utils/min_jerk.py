"""Minimum-jerk joint-space trajectories.

Counterpart of ``myosuite_mjx_tpu/utils/min_jerk.py``: the quintic 0 -> 1
profile with zero velocity and acceleration at both ends, scaled between a
start and a goal joint vector. The plan is one dict of stacked tensors
(time [N], position [N, D], velocity, acceleration) on the device asked
for, usable as a tracking reference; ``as_waypoint_list`` gives the
list-of-dicts form for host-side tooling.
"""
from __future__ import annotations

import torch


def min_jerk_spaces(n_steps: int, time_to_go: float,
                    dtype: torch.dtype = torch.float32, device="cuda"):
  """1-D min-jerk profile 0 -> 1 over ``n_steps`` in ``time_to_go`` s.

  Returns (p, pd, pdd), each [n_steps].
  """
  if n_steps <= 1:
    raise ValueError("Number of planning steps must be larger than 1.")
  t = torch.linspace(0.0, 1.0, n_steps, dtype=dtype, device=device)
  p = 10 * t**3 - 15 * t**4 + 6 * t**5
  pd = (30 * t**2 - 60 * t**3 + 30 * t**4) / time_to_go
  pdd = (60 * t - 180 * t**2 + 120 * t**3) / (time_to_go**2)
  return p, pd, pdd


def generate_joint_space_min_jerk(start, goal, time_to_go: float, dt: float,
                                  dtype: torch.dtype = torch.float32,
                                  device="cuda") -> dict:
  """Joint-space min-jerk plan as stacked tensors.

  Returns {"time_from_start": [N], "position": [N, D], "velocity": [N, D],
  "acceleration": [N, D]} with N = int(time_to_go / dt).
  """
  start = torch.as_tensor(start, dtype=dtype, device=device)
  goal = torch.as_tensor(goal, dtype=dtype, device=device)
  n_steps = int(time_to_go / dt)
  p, pd, pdd = min_jerk_spaces(n_steps, time_to_go, dtype, device)
  delta = goal - start
  return {
      "time_from_start": dt * torch.arange(n_steps, dtype=dtype,
                                           device=device),
      "position": start[None, :] + delta[None, :] * p[:, None],
      "velocity": delta[None, :] * pd[:, None],
      "acceleration": delta[None, :] * pdd[:, None],
  }


def as_waypoint_list(traj: dict) -> list:
  """The stacked plan as a list of per-step dicts."""
  return [{"time_from_start": float(traj["time_from_start"][i]),
           "position": traj["position"][i],
           "velocity": traj["velocity"][i],
           "acceleration": traj["acceleration"][i]}
          for i in range(traj["position"].shape[0])]
