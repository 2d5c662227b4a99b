"""MyoChallenge die reorientation (ReorientEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/reorient.py``: a goal pose per
episode (position jitter and an orientation from Euler ranges) kept in
aux, the goal site's world pose composed from it, and a die-drop
termination. The die's size, mass and friction ranges are accepted and
not applied, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform
from myosuite_mjx_tpu_torch.ops import quat as qmath


class ReorientEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_qpos_noMD5", "hand_qvel", "obj_pos", "goal_pos", "pos_err",
      "obj_rot", "goal_rot", "rot_err",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pos_dist": 100.0,
      "rot_dist": 1.0,
      "act_reg": 5.0,
      "drop": 5.0,
      "bonus": 10.0,
  }

  def _setup(self, goal_pos=(0.0, 0.0), goal_rot=(0.785, 0.785),
             pos_th=0.025, rot_th=0.262, drop_th=0.200,
             obj_size_change=0, obj_mass_range=(0.108, 0.108),
             obj_friction_change=(0, 0, 0), **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.goal_pos_range = tuple(goal_pos)
    self.goal_rot_range = tuple(goal_rot)
    self.pos_th = pos_th
    self.rot_th = rot_th
    self.drop_th = drop_th
    self.object_sid = m.name2id("site", "object_o")
    self.goal_sid = m.name2id("site", "target_o")
    self.goal_bid = m.name2id("body", "target")
    self.goal_site_local_pos = np.asarray(m.site_pos[self.goal_sid])
    self.goal_site_local_quat = np.asarray(m.site_quat[self.goal_sid])
    self.init_qpos[:-7] *= 0
    self.init_qpos[0] = -1.5  # palm up
    sites = self.sites_at_qpos0()
    # the offset between the target and object sites at init
    self.goal_obj_offset = sites[self.goal_sid] - sites[self.object_sid]
    # the goal site's world position at init
    self.goal_init_pos = sites[self.goal_sid]

  def draw_goal(self, batch: int, device, generator):
    """The goal's position offset [B, 3], U(goal_pos), and Euler angles
    [B, 3], U(goal_rot) (a parity test overrides this to hand in JAX's
    draws)."""
    lo, hi = self.goal_pos_range
    rlo, rhi = self.goal_rot_range
    return (uniform((batch, 3), generator, device, self.dtype, lo, hi),
            uniform((batch, 3), generator, device, self.dtype, rlo, rhi))

  def reset_aux(self, batch: int, device, generator) -> dict:
    dpos, euler = self.draw_goal(batch, device, generator)
    start = torch.as_tensor(self.goal_init_pos, device=device).to(self.dtype)
    return {"goal_body_pos": start + dpos,
            "goal_body_quat": qmath.euler_to_quat(euler)}

  def _goal_site(self, aux: dict):
    t = lambda x: torch.as_tensor(x, device=aux["goal_body_pos"].device).to(
        self.dtype)
    quat = aux["goal_body_quat"]
    pos = aux["goal_body_pos"] + qmath.quat_rotate(
        quat, t(self.goal_site_local_pos))
    return pos, qmath.quat_to_euler(qmath.quat_mul(
        quat, t(self.goal_site_local_quat)))

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    goal_pos, goal_rot = self._goal_site(aux)
    obj_pos = data.site_xpos[:, self.object_sid]
    obj_rot = qmath.mat_to_euler(data.site_xmat[:, self.object_sid])
    offset = torch.as_tensor(self.goal_obj_offset,
                             device=obj_pos.device).to(self.dtype)
    return {
        "time": data.time[:, None],
        # qpos[:-7] keeps the reference's off-by-one (noMD5) key, which
        # shipped policies depend on
        "hand_qpos_noMD5": data.qpos[:, :-7],
        "hand_qpos": data.qpos[:, :-6],
        "hand_qvel": data.qvel[:, :-6] * self.dt,
        "obj_pos": obj_pos,
        "goal_pos": goal_pos,
        "pos_err": goal_pos - obj_pos - offset,
        "obj_rot": obj_rot,
        "goal_rot": goal_rot,
        "rot_err": goal_rot - obj_rot,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    pos_dist = norm(obs_dict["pos_err"]).abs()
    rot_dist = norm(obs_dict["rot_err"]).abs()
    f = lambda x: x.to(pos_dist.dtype)
    drop = pos_dist > self.drop_th
    return {
        "pos_dist": -1.0 * pos_dist,
        "rot_dist": -1.0 * rot_dist,
        "bonus": f(pos_dist < 2 * self.pos_th) + f(pos_dist < self.pos_th),
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "drop": -1.0 * f(drop),
        "penalty": -1.0 * f(drop),
        "sparse": -rot_dist - 10.0 * pos_dist,
        "solved": (pos_dist < self.pos_th) & (rot_dist < self.rot_th)
                  & ~drop,
        "done": drop,
    }
