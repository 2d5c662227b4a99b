"""Leg tasks on a batch of environments: stand/reach, walk, terrain walk.

Counterpart of ``myosuite_mjx_tpu/envs/walk.py``:

- ``LegReachEnv``: keyframe init, uniform joint noise at reset (clipped to
  each joint's range), targets drawn around the tracked sites' reset
  positions, a velocity-penalized reach reward;
- ``WalkEnv``: a gaussian reward on the centre of mass's velocity, cyclic
  hip flexion against a phase variable, the pelvis's rotation against a
  reference, a hip adduction/rotation regularizer, and terminations on the
  centre of mass's height and the pelvis's heading. The centre of mass's
  velocity is the mass-weighted body velocity (``com_vel_type``
  "physical") or MuJoCo's negated com-frame form ("reference");
- ``TerrainWalkEnv``: the walk over rough, hilly or stair terrain, a
  per-episode ``hfield_data`` overlay.

Draws go through hooks that a parity test overrides to hand in JAX's:
``draw_joint_noise`` and ``draw_target_offset`` (reach), ``draw_reset_pose``
(the walk's random reset) and ``draw_terrain`` (terrain walk). The
reference draws the walk's random reset and its terrain from one key; here
they come one after the other from the generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import model as model_mod
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import normal, uniform
from myosuite_mjx_tpu_torch.ops import quat as qmath


class LegReachEnv(MyoEnv):
  DEFAULT_OBS_KEYS = ["qpos", "qvel", "tip_pos", "reach_err"]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "reach": 1.0,
      "bonus": 4.0,
      "penalty": 50,
      "act_reg": 1,
  }

  def _setup(self, target_reach_range: dict,
             joint_random_range: tuple = (0.0, 0.0),
             far_th: float = 0.35, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.far_th = far_th
    self.joint_random_range = tuple(joint_random_range)
    self.tip_sids = np.asarray(
        [m.name2id("site", s) for s in target_reach_range])
    self.target_lo = np.asarray(
        [r[0] for r in target_reach_range.values()], np.float64)
    self.target_hi = np.asarray(
        [r[1] for r in target_reach_range.values()], np.float64)
    self.n_tips = len(self.tip_sids)
    if len(m.key_qpos):
      self.init_qpos[:] = m.key_qpos[0]
      self.init_qvel[:] = m.key_qvel[0]

  def draw_joint_noise(self, batch: int, device, generator) -> torch.Tensor:
    """Per-joint offsets [B, njnt] in U(joint_random_range)."""
    lo, hi = self.joint_random_range
    return uniform((batch, self.model.njnt), generator, device, self.dtype,
                   lo, hi)

  def draw_target_offset(self, batch: int, device, generator) -> torch.Tensor:
    """Target offsets [B, n_tips, 3], uniform in each tip's box."""
    lo = torch.as_tensor(self.target_lo, device=device).to(self.dtype)
    hi = torch.as_tensor(self.target_hi, device=device).to(self.dtype)
    u = uniform((batch,) + tuple(lo.shape), generator, device, self.dtype)
    return lo + (hi - lo) * u

  def reset_qpos_qvel(self, batch: int, device, aux: dict, generator):
    qpos, qvel = super().reset_qpos_qvel(batch, device, aux, generator)
    lo, hi = self.joint_random_range
    if hi > lo:
      m = self.model
      jadr = torch.as_tensor(m.jnt_qposadr, device=device)
      rng = torch.as_tensor(m.jnt_range, device=device).to(self.dtype)
      new = qpos[:, jadr] + self.draw_joint_noise(batch, device, generator)
      qpos[:, jadr] = torch.minimum(torch.maximum(new, rng[:, 0]), rng[:, 1])
    return qpos, qvel

  def post_reset_aux(self, data: Data, aux: dict, generator) -> dict:
    off = self.draw_target_offset(data.qpos.shape[0], data.qpos.device,
                                  generator)
    return {**aux, "target_pos": data.site_xpos[:, self.tip_sids] + off}

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    B = data.qpos.shape[0]
    tip_pos = data.site_xpos[:, self.tip_sids]
    return {
        "time": data.time[:, None],
        "qpos": data.qpos,
        "qvel": data.qvel * self.dt,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
        "tip_pos": tip_pos.reshape(B, -1),
        "reach_err": (aux["target_pos"] - tip_pos).reshape(B, -1),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    reach_dist = torch.linalg.vector_norm(obs_dict["reach_err"], dim=-1)
    vel_dist = torch.linalg.vector_norm(obs_dict["qvel"], dim=-1)
    far_th = torch.where(data.time > 2 * self.dt,
                         torch.full_like(reach_dist, self.far_th * self.n_tips),
                         torch.full_like(reach_dist, torch.inf))
    near_th = self.n_tips * 0.050
    f = lambda b: b.to(reach_dist.dtype)
    return {
        "reach": 10.0 - 1.0 * reach_dist - 10.0 * vel_dist,
        "bonus": f(reach_dist < 2 * near_th) + f(reach_dist < near_th),
        "act_reg": -100.0 * self.act_magnitude(obs_dict["act"]),
        "penalty": -1.0 * f(reach_dist > far_th),
        "sparse": -1.0 * reach_dist,
        "solved": reach_dist < near_th,
        "done": reach_dist > far_th,
    }


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

  # the flat walk moves the terrain geom 10 m under the floor
  move_terrain_away = True

  def _setup(self, min_height=0.8, max_rot=0.8, hip_period=100,
             reset_type="init", target_x_vel=0.0, target_y_vel=1.2,
             target_rot=None, com_vel_type="physical", **kwargs):
    super()._setup(**kwargs)
    if self.move_terrain_away and "terrain" in self.model.names["geom"]:
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
    self.target_rot = (np.asarray(target_rot) if target_rot is not None
                       else self.init_qpos[3:7].copy())
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
    if com_vel_type not in ("physical", "reference"):
      raise ValueError(f"com_vel_type must be physical|reference, "
                       f"got {com_vel_type!r}")
    self.com_vel_type = com_vel_type
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
    if self.com_vel_type == "reference":
      # MuJoCo's negated com-frame cvel: the world-origin spatial velocity
      # re-anchored at the whole model's centre of mass
      com = self._com(data)[:, None]
      v = lin + torch.linalg.cross(ang, com.expand(ang.shape), dim=-1)
      return -(mass * v).sum(1)[:, :2] / self._total_mass
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
    height = obs_dict["height"][:, 0]
    fwd = qmath.quat_rotate(data.qpos[:, 3:7],
                            vel.new_tensor([1.0, 0.0, 0.0]))
    rot_bad = fwd[:, 0].abs() > self.max_rot
    done = (height < self.min_height) | rot_bad
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


def _hilly_base(nrow: int, ncol: int) -> np.ndarray:
  """The hilly recipe before its scale: a flat lead-in of 3000 cells at the
  top, then three half-waves down and up, normalized to [0, 1] and
  flipped along both axes, [nrow * ncol]."""
  n = nrow * ncol
  flat_len, freq = 3000, 3
  ramp = -2 + 0.5 * (np.sin(np.linspace(0, freq * np.pi, n - flat_len)
                            + np.pi / 2) - 1)
  comb = np.concatenate([-2 * np.ones(flat_len), ramp])
  norm = (comb - comb.min()) / (comb.max() - comb.min())
  return np.flip(norm.reshape(nrow, ncol), (0, 1)).ravel()


def _stairs_base(nrow: int, ncol: int) -> np.ndarray:
  """The stair recipe before its scale: about 5200 flat cells, then 12
  stairs of 0.1, normalized by the whole rise and flipped, [nrow * ncol];
  the rows are built with static sizes."""
  n = nrow * ncol
  num_stairs, stair_height = 12, 0.1
  flat_cells = int(5200 - (n - 5200) % num_stairs)
  stairs_width = (n - flat_cells) // num_stairs
  rows = [np.full((flat_cells // ncol, ncol), -2.0)]
  for j in range(num_stairs):
    rows.append(np.full((int(stairs_width // ncol), ncol),
                        -2.0 + stair_height * j))
  terr = np.concatenate(rows, axis=0)
  norm = (terr + 2) / (2 + stair_height * num_stairs)
  padded = np.zeros((nrow, ncol))
  padded[:norm.shape[0]] = norm[:nrow]
  return np.flip(padded, (0, 1)).ravel()


class TerrainWalkEnv(WalkEnv):
  """The walk over procedural terrain: "rough" (uniform rubble, scaled to
  [-0.02, 0.06] per env), "hilly" (a flat lead-in, then sinusoidal hills)
  or "stairs" (a flat lead-in, then 12 stairs), the last two scaled by a
  random factor per env, or a fixed one with ``variant="fixed"``; an
  ``hfield_data`` overlay drawn at every reset. The terrain stays where
  the scene puts it."""

  move_terrain_away = False

  def _setup(self, terrain="rough", variant=None, **kwargs):
    self.terrain = terrain
    self.variant = variant
    super()._setup(**kwargs)

  def draw_terrain(self, batch: int, device, generator) -> torch.Tensor:
    """The terrain's draws: rough U(-0.5, 0.5) [B, n], hilly's scale
    U(0.53, 0.73) [B] and the stairs' U(1.5, 3.5) [B]; an empty [B, 0]
    otherwise (a fixed variant, another terrain)."""
    n = len(self.model.hfield_data)
    if self.terrain == "rough":
      return uniform((batch, n), generator, device, self.dtype, -0.5, 0.5)
    if self.terrain in ("hilly", "stairs") and self.variant != "fixed":
      lo, hi = (0.53, 0.73) if self.terrain == "hilly" else (1.5, 3.5)
      return uniform((batch,), generator, device, self.dtype, lo, hi)
    return torch.zeros((batch, 0), dtype=self.dtype, device=device)

  def _base(self, device) -> torch.Tensor:
    def build(dm):
      h = self.model
      nrow, ncol = int(h.hfield_nrow[0]), int(h.hfield_ncol[0])
      fn = _hilly_base if self.terrain == "hilly" else _stairs_base
      return dm.tensor(fn(nrow, ncol))
    return self.device_model(device).spec(f"terrain_{self.terrain}", build)

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    n = len(self.model.hfield_data)
    if n == 0:
      return {}
    draws = self.draw_terrain(batch, device, generator)
    if self.terrain == "rough":
      lo = draws.amin(-1, keepdim=True)
      hi = draws.amax(-1, keepdim=True)
      data = (draws - lo) / (hi - lo) * 0.08 - 0.02
    elif self.terrain in ("hilly", "stairs"):
      fixed = 0.63 if self.terrain == "hilly" else 2.5
      scalar = (draws[:, None] if self.variant != "fixed"
                else torch.full((batch, 1), fixed, dtype=self.dtype,
                                device=device))
      data = self._base(device) * scalar
    else:
      data = torch.zeros((batch, n), dtype=self.dtype, device=device)
    return {"hfield_data": data}
