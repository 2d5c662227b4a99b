"""Object-hold tasks (ObjHoldEnv, ObjHoldRandomEnv) on a batch of
environments.

Counterpart of ``myosuite_mjx_tpu/envs/obj_hold.py``: the palm-up hand
holds a free ellipsoid (the last joint and the last geom) at a goal. The
Random variant draws the goal around the object's start per episode and
the ellipsoid's radii per env (a ``geom_size`` overlay).
"""
from __future__ import annotations

import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform


class ObjHoldEnv(MyoEnv):
  DEFAULT_OBS_KEYS = ["hand_qpos", "hand_qvel", "obj_pos", "obj_err"]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "goal_dist": 100.0,
      "bonus": 4.0,
      "penalty": 10,
  }

  randomize_goal = False

  def _setup(self, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.object_sid = m.name2id("site", "object")
    self.goal_sid = m.name2id("site", "goal")
    # palm-up open-hand init
    self.init_qpos[:-7] *= 0
    self.init_qpos[0] = -1.5
    # the object's world start (its site is on the free body at qpos0)
    self.object_init_pos = self.sites_at_qpos0()[self.object_sid]

  def draw_goal_offset(self, batch: int, device, generator) -> torch.Tensor:
    """The goal's offset [B, 3] from the object's start, U(-3 cm, 3 cm)
    (a parity test overrides this to hand in JAX's draws)."""
    return uniform((batch, 3), generator, device, self.dtype, -0.030, 0.030)

  def reset_aux(self, batch: int, device, generator) -> dict:
    if self.randomize_goal:
      start = torch.as_tensor(self.object_init_pos, device=device)
      return {"goal_pos": start.to(self.dtype)
                          + self.draw_goal_offset(batch, device, generator)}
    # the model's goal site
    return {"goal_pos": torch.zeros((batch, 0), dtype=self.dtype,
                                    device=device)}

  def _goal_pos(self, data: Data, aux: dict) -> torch.Tensor:
    if self.randomize_goal:
      return aux["goal_pos"]
    return data.site_xpos[:, self.goal_sid]

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    obj_pos = data.site_xpos[:, self.object_sid]
    return {
        "time": data.time[:, None],
        "hand_qpos": data.qpos[:, :-7],
        "hand_qvel": data.qvel[:, :-6] * self.dt,
        "obj_pos": obj_pos,
        "obj_err": self._goal_pos(data, aux) - obj_pos,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    goal_dist = torch.linalg.vector_norm(obs_dict["obj_err"], dim=-1).abs()
    f = lambda b: b.to(goal_dist.dtype)
    goal_th = 0.010
    drop = goal_dist > 0.300
    return {
        "goal_dist": -1.0 * goal_dist,
        "bonus": f(goal_dist < 2 * goal_th) + f(goal_dist < goal_th),
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "penalty": -1.0 * f(drop),
        "sparse": -goal_dist,
        "solved": goal_dist < goal_th,
        "done": drop,
    }


class ObjHoldRandomEnv(ObjHoldEnv):
  """The goal and the object's radii drawn per episode."""
  randomize_goal = True

  def draw_object_size(self, batch: int, device, generator) -> torch.Tensor:
    """The ellipsoid's radii [B, 3], U(2 cm, 3 cm) (a parity test
    overrides this to hand in JAX's draws)."""
    return uniform((batch, 3), generator, device, self.dtype, 0.020, 0.030)

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    sizes = self.device_model(device).geom_size.expand(batch, -1, -1).clone()
    sizes[:, -1] = self.draw_object_size(batch, device, generator)
    return {"geom_size": sizes}
