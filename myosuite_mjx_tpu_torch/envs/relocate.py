"""MyoChallenge relocate (RelocateEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/relocate.py``: move an object to a
goal pose drawn per episode (a box of positions and a range of Euler
angles), kept in aux; with ``obj_xyz_range`` the object's start is drawn
too (and the scene's second keyframe is the init pose), with
``qpos_noise_range`` the arm's joints start jittered. The episode ends
when the palm is farther than ``drop_th`` from the object. The object's
geometry, mass and friction ranges are accepted and not applied, as in
the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform
from myosuite_mjx_tpu_torch.ops import quat as qmath


def _box(r: dict | None) -> dict | None:
  return None if r is None else {k: np.asarray(v, np.float64)
                                 for k, v in r.items()}


class RelocateEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_qpos", "hand_qvel", "obj_pos", "goal_pos", "pos_err",
      "obj_rot", "goal_rot", "rot_err",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pos_dist": 100.0,
      "rot_dist": 1.0,
  }

  def _setup(self, target_xyz_range, target_rxryrz_range,
             obj_xyz_range=None, qpos_noise_range=None,
             obj_geom_range=None, obj_mass_range=None,
             obj_friction_range=None,
             pos_th=0.025, rot_th=0.262, drop_th=0.50, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.target_xyz_range = _box(target_xyz_range)
    self.target_rxryrz_range = _box(target_rxryrz_range)
    self.obj_xyz_range = _box(obj_xyz_range)
    self.qpos_noise_range = qpos_noise_range
    self.pos_th = pos_th
    self.rot_th = rot_th
    self.drop_th = drop_th
    self.palm_sid = m.name2id("site", "S_grasp")
    self.object_sid = m.name2id("site", "object_o")
    self.goal_sid = m.name2id("site", "target_o")
    self.goal_bid = m.name2id("body", "target")
    self.goal_site_local_pos = np.asarray(m.site_pos[self.goal_sid])
    self.goal_site_local_quat = np.asarray(m.site_quat[self.goal_sid])
    key = 0 if self.obj_xyz_range is None else 1
    self.init_qpos[:] = m.key_qpos[key]

  # ---- draws (a parity test overrides these to hand in JAX's) -----------

  def _uniform_box(self, batch, device, generator, box):
    lo = torch.as_tensor(box["low"], device=device).to(self.dtype)
    hi = torch.as_tensor(box["high"], device=device).to(self.dtype)
    return lo + (hi - lo) * uniform((batch, 3), generator, device,
                                    self.dtype)

  def draw_goal(self, batch: int, device, generator):
    """The goal body's position and Euler angles [B, 3], U over the
    target ranges."""
    return (self._uniform_box(batch, device, generator,
                              self.target_xyz_range),
            self._uniform_box(batch, device, generator,
                              self.target_rxryrz_range))

  def draw_start(self, batch: int, device, generator):
    """The object's start [B, 3], U(obj_xyz_range), and the joints' noise
    [B, nq], U(-qpos_noise_range, qpos_noise_range); None for what the
    task does not draw."""
    spawn = (None if self.obj_xyz_range is None else
             self._uniform_box(batch, device, generator, self.obj_xyz_range))
    noise = (None if not self.qpos_noise_range else
             uniform((batch, self.model.nq), generator, device, self.dtype,
                     -self.qpos_noise_range, self.qpos_noise_range))
    return spawn, noise

  # ---- task -------------------------------------------------------------

  def reset_aux(self, batch: int, device, generator) -> dict:
    pos, euler = self.draw_goal(batch, device, generator)
    return {"goal_body_pos": pos,
            "goal_body_quat": qmath.euler_to_quat(euler)}

  def reset_qpos_qvel(self, batch: int, device, aux: dict, generator):
    qpos, qvel = super().reset_qpos_qvel(batch, device, aux, generator)
    spawn, noise = self.draw_start(batch, device, generator)
    if spawn is not None:
      # the free object's world position (qpos tail: 3 pos + 4 quat)
      qpos[:, -7:-4] = spawn
    if noise is not None:
      # joints only; the object's pose stays exact
      qpos[:, :-7] = qpos[:, :-7] + noise[:, :-7]
    return qpos, qvel

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
    palm_pos = data.site_xpos[:, self.palm_sid]
    obj_rot = qmath.mat_to_euler(data.site_xmat[:, self.object_sid])
    return {
        "time": data.time[:, None],
        "hand_qpos": data.qpos[:, :-7],
        "hand_qvel": data.qvel[:, :-6] * self.dt,
        "obj_pos": obj_pos,
        "goal_pos": goal_pos,
        "palm_pos": palm_pos,
        "pos_err": goal_pos - obj_pos,
        "reach_err": palm_pos - obj_pos,
        "obj_rot": obj_rot,
        "goal_rot": goal_rot,
        "rot_err": goal_rot - obj_rot,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1).abs()
    reach_dist = norm(obs_dict["reach_err"])
    pos_dist = norm(obs_dict["pos_err"])
    rot_dist = norm(obs_dict["rot_err"])
    drop = reach_dist > self.drop_th
    return {
        "pos_dist": -1.0 * pos_dist,
        "rot_dist": -1.0 * rot_dist,
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "sparse": -rot_dist - 10.0 * pos_dist,
        "solved": (pos_dist < self.pos_th) & (rot_dist < self.rot_th)
                  & ~drop,
        "done": drop,
    }
