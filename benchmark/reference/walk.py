"""Plain reference, frozen from the port's ``envs/walk.py`` (``WalkEnv``)
and importing nothing of it.

The walk task on a batch of environments: a gaussian reward on the centre
of mass's velocity, cyclic hip flexion against a phase variable, the
pelvis's rotation against a reference, a hip adduction/rotation
regularizer, and terminations on the centre of mass's height and the
pelvis's heading.

Counterpart of MyoSuite's ``WalkEnvV0`` (``myosuite/envs/myo/myobase/
walk_v0.py``) under myoLegWalk-v0's kwargs. The departures the port has,
kept here:

- the centre of mass's velocity is the mass-weighted body velocity (the
  port's default ``com_vel_type`` "physical", the only one here); MyoSuite
  reads its com-frame ``cvel``. The reference rotation is the init pose's,
  the port's default ``target_rot``;
- the random reset picks key 2 or 3 with one U(0, 1) draw per env and adds
  0.02 N(0, 1) noise to every qpos entry but the root's height and
  orientation (qpos[2:7]), which stay exact; the draws are made in that
  order, ``draw_reset_pose``;
- the flat walk moves the ``terrain`` geom (the hfield) to z = -10 on the
  host model, before any device model is built from it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import model as model_mod
from . import quat as qmath
from .base import MyoEnv
from .data import Data
from .randomize import normal, uniform

# myoLegWalk-v0's task kwargs (myosuite_mjx_tpu/envs/myobase.py), with the
# MyoEnv default frame_skip 10 and the registered horizon written out
LEG_WALK = dict(frame_skip=10, horizon=1000, normalize_act=True,
                min_height=0.8, max_rot=0.8, hip_period=100,
                reset_type="random", target_x_vel=0.0, target_y_vel=1.2)


class WalkEnv(MyoEnv):
  """Walk at a target velocity with cyclic hip motion."""

  DEFAULT_OBS_KEYS = [
      "qpos_without_xy", "qvel", "com_vel", "torso_angle", "feet_heights",
      "height", "feet_rel_positions", "phase_var", "muscle_length",
      "muscle_velocity", "muscle_force",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "vel_reward": 5.0,
      "done": -100,
      "cyclic_hip": -10,
      "ref_rot": 10.0,
      "joint_angle_rew": 5.0,
  }

  def _setup(self, min_height=0.8, max_rot=0.8, hip_period=100,
             reset_type="init", target_x_vel=0.0, target_y_vel=1.2,
             **kwargs):
    super()._setup(**kwargs)
    if "terrain" in self.model.names["geom"]:
      # on the host model, before any DeviceModel (and its collision
      # layout) is built from it
      gp = np.array(self.model.geom_pos)
      gp[self.model.name2id("geom", "terrain")] = [0, 0, -10]
      self.model = model_mod.Model(**{**self.model.__dict__, "geom_pos": gp})
    m = self.model
    self.min_height = min_height
    self.max_rot = max_rot
    self.hip_period = hip_period
    self.reset_type = reset_type
    self.target_x_vel = target_x_vel
    self.target_y_vel = target_y_vel
    self.init_qpos[:] = m.key_qpos[0]
    self.init_qvel[:] = 0.0
    self.target_rot = self.init_qpos[3:7].copy()
    self.talus_l = m.name2id("body", "talus_l")
    self.talus_r = m.name2id("body", "talus_r")
    self.pelvis_bid = m.name2id("body", "pelvis")
    self.torso_bid = m.name2id("body", "torso")
    self.hip_flex_adr = np.asarray([
        m.jnt_qposadr[m.name2id("joint", n)]
        for n in ("hip_flexion_l", "hip_flexion_r")])
    self.hip_reg_adr = np.asarray([
        m.jnt_qposadr[m.name2id("joint", n)]
        for n in ("hip_adduction_l", "hip_adduction_r",
                  "hip_rotation_l", "hip_rotation_r")])
    self._mass = np.asarray(m.body_mass)
    self._total_mass = float(self._mass.sum())

  def draw_reset_pose(self, batch: int, device, generator):
    """The random reset's key pick u [B] in U(0, 1) (key 2 below 0.5,
    else key 3) and standard normal noise [B, nq]."""
    return (uniform((batch,), generator, device, self.dtype),
            normal((batch, self.model.nq), generator, device, self.dtype))

  def reset_qpos_qvel(self, batch: int, device, aux: dict, generator):
    m = self.model
    key = lambda arr, i: torch.as_tensor(arr[i], device=device).to(
        self.dtype).expand(batch, -1)
    if self.reset_type == "random" and len(m.key_qpos) > 3:
      u, z = self.draw_reset_pose(batch, device, generator)
      pick = (u < 0.5)[:, None]
      qpos = torch.where(pick, key(m.key_qpos, 2), key(m.key_qpos, 3))
      qvel = torch.where(pick, key(m.key_qvel, 2), key(m.key_qvel, 3))
      noisy = qpos + 0.02 * z
      # the root's height and orientation stay exact
      noisy[:, 2:7] = qpos[:, 2:7]
      return noisy, qvel
    if self.reset_type == "init" and len(m.key_qpos) > 2:
      return key(m.key_qpos, 2).clone(), key(m.key_qvel, 2).clone()
    return (key(m.key_qpos, 0).clone(),
            torch.zeros((batch, m.nv), dtype=self.dtype, device=device))

  def _mass_t(self, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(self._mass, device=like.device).to(like.dtype)

  def _com(self, data: Data) -> torch.Tensor:
    mass = self._mass_t(data.xipos)
    return (mass[:, None] * data.xipos).sum(1) / self._total_mass

  def _com_vel_xy(self, data: Data) -> torch.Tensor:
    ang = data.cvel[..., :3]
    lin = data.cvel[..., 3:]
    mass = self._mass_t(data.xipos)[:, None]
    v = lin + torch.linalg.cross(ang, data.xipos, dim=-1)
    return (mass * v).sum(1)[:, :2] / self._total_mass

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    phase = (data.time / self.dt) / self.hip_period % 1.0
    pelvis = data.xpos[:, self.pelvis_bid]
    return {
        "time": data.time[:, None],
        "qpos_without_xy": data.qpos[:, 2:],
        "qvel": data.qvel * self.dt,
        "com_vel": self._com_vel_xy(data),
        "torso_angle": data.xquat[:, self.torso_bid],
        "feet_heights": torch.stack([data.xpos[:, self.talus_l, 2],
                                     data.xpos[:, self.talus_r, 2]], -1),
        "height": self._com(data)[:, 2:3],
        "feet_rel_positions": torch.cat([
            data.xpos[:, self.talus_l] - pelvis,
            data.xpos[:, self.talus_r] - pelvis], -1),
        "phase_var": phase[:, None],
        "muscle_length": data.actuator_length,
        "muscle_velocity": torch.clamp(data.actuator_velocity, -100, 100),
        "muscle_force": torch.clamp(data.actuator_force / 1000, -100, 100),
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def termination_margins(self, data: Data) -> dict:
    """Each termination's signed distance to its threshold [B], negative
    where it ends the episode: the centre of mass's height over
    ``min_height``, and ``max_rot`` over the pelvis's heading (the x
    component of its forward axis)."""
    fwd = qmath.quat_rotate(data.qpos[:, 3:7],
                            data.qpos.new_tensor([1.0, 0.0, 0.0]))
    return {"height": self._com(data)[:, 2] - self.min_height,
            "heading": self.max_rot - fwd[:, 0].abs()}

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    vel = obs_dict["com_vel"]
    vel_reward = (torch.exp(-torch.square(self.target_y_vel - vel[:, 1]))
                  + torch.exp(-torch.square(self.target_x_vel - vel[:, 0])))
    phase = obs_dict["phase_var"][:, 0]
    des = 0.8 * torch.stack([torch.cos(phase * 2 * math.pi + math.pi),
                             torch.cos(phase * 2 * math.pi)], -1)
    angles = data.qpos[:, self.hip_flex_adr]
    cyclic_hip = torch.linalg.vector_norm(des - angles, dim=-1)
    target_rot = torch.as_tensor(self.target_rot,
                                 device=vel.device).to(vel.dtype)
    ref_rot = torch.exp(-torch.linalg.vector_norm(
        5.0 * (data.qpos[:, 3:7] - target_rot), dim=-1))
    reg_angles = data.qpos[:, self.hip_reg_adr]
    joint_angle_rew = torch.exp(-5 * reg_angles.abs().mean(-1))
    margins = self.termination_margins(data)
    done = (margins["height"] < 0) | (margins["heading"] < 0)
    return {
        "vel_reward": vel_reward,
        "cyclic_hip": cyclic_hip,
        "ref_rot": ref_rot,
        "joint_angle_rew": joint_angle_rew,
        "act_mag": self.act_magnitude(obs_dict["act"]),
        "sparse": vel_reward,
        "solved": vel_reward >= 1.0,
        "done": done,
    }
