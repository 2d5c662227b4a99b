"""Site-reaching tasks (ReachEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/reach.py``: tip sites reach
per-episode target positions drawn from per-site boxes; reward = weighted
{reach, bonus, penalty(, act_reg)} with near and far thresholds scaled by
the number of tips, and a grace period of two control steps before the
far-threshold termination applies.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform


class ReachEnv(MyoEnv):
  # obs and reward read no contact state: reset skips collision and Newton
  RESET_CONSTRAINT = False
  DEFAULT_OBS_KEYS = ["qpos", "qvel", "tip_pos", "reach_err"]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "reach": 1.0,
      "bonus": 4.0,
      "penalty": 50,
  }

  def _setup(self, target_reach_range: dict, far_th: float = 0.35, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.far_th = far_th
    self.tip_sids = np.asarray(
        [m.name2id("site", s) for s in target_reach_range])
    self.target_lo = np.asarray(
        [r[0] for r in target_reach_range.values()], np.float64)
    self.target_hi = np.asarray(
        [r[1] for r in target_reach_range.values()], np.float64)
    self.n_tips = len(self.tip_sids)

  def draw_target(self, batch: int, device, generator) -> torch.Tensor:
    """Targets [B, n_tips, 3], uniform in each tip's box (a parity test
    overrides this to hand in JAX's draws)."""
    lo = torch.as_tensor(self.target_lo, device=device).to(self.dtype)
    hi = torch.as_tensor(self.target_hi, device=device).to(self.dtype)
    u = uniform((batch,) + tuple(lo.shape), generator, device, self.dtype)
    return lo + (hi - lo) * u

  def reset_aux(self, batch, device, generator) -> dict:
    return {"target_pos": self.draw_target(batch, device, generator)}

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    B = data.qpos.shape[0]
    tip_pos = data.site_xpos[:, self.tip_sids]
    target_pos = aux["target_pos"]
    return {
        "time": data.time[:, None],
        "qpos": data.qpos,
        "qvel": data.qvel * self.dt,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
        "tip_pos": tip_pos.reshape(B, -1),
        "target_pos": target_pos.reshape(B, -1),
        "reach_err": (target_pos - tip_pos).reshape(B, -1),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    reach_dist = torch.linalg.vector_norm(obs_dict["reach_err"], dim=-1)
    # the far-threshold grace period: the first two control steps
    far_th = torch.where(data.time > 2 * self.dt,
                         torch.full_like(reach_dist, self.far_th * self.n_tips),
                         torch.full_like(reach_dist, torch.inf))
    near_th = self.n_tips * 0.0125
    f = lambda b: b.to(reach_dist.dtype)
    return {
        "reach": -1.0 * reach_dist,
        "bonus": f(reach_dist < 2 * near_th) + f(reach_dist < near_th),
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "penalty": -1.0 * f(reach_dist > far_th),
        "sparse": -1.0 * reach_dist,
        "solved": reach_dist < near_th,
        "done": reach_dist > far_th,
    }
