"""MyoChallenge baoding (BaodingEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/baoding.py``: two balls rotate in
the palm along target ellipses. Per episode: the direction (fixed
counter-clockwise, or drawn among hold, clockwise and counter-clockwise),
the start angle, the ellipse's radii and its period; the targets' world
positions are composed each step from the frame of the body that carries
``target1_site``. A ball below ``drop_th`` ends the episode. P2's ball
sizes, masses and frictions are per-env model overlays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform

# the direction sign by drawn task: hold, clockwise, counter-clockwise
_TASK_SIGNS = (0.0, -1.0, 1.0)


class BaodingEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_pos", "object1_pos", "object1_velp", "object2_pos",
      "object2_velp", "target1_pos", "target2_pos",
      "target1_err", "target2_err",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pos_dist_1": 5.0,
      "pos_dist_2": 5.0,
  }

  def _setup(self, drop_th=1.25, proximity_th=0.015,
             goal_time_period=(5, 5), goal_xrange=(0.025, 0.025),
             goal_yrange=(0.028, 0.028), task_choice="fixed",
             obj_size_range=None, obj_mass_range=None,
             obj_friction_change=None, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.obj_size_range = obj_size_range
    self.obj_mass_range = obj_mass_range
    self.obj_friction_change = obj_friction_change
    self.ball_bids = (m.name2id("body", "ball1"), m.name2id("body", "ball2"))
    self.ball_gids = (m.name2id("geom", "ball1"), m.name2id("geom", "ball2"))
    self.drop_th = drop_th
    self.proximity_th = proximity_th
    self.goal_time_period = tuple(goal_time_period)
    self.goal_xrange = tuple(goal_xrange)
    self.goal_yrange = tuple(goal_yrange)
    self.task_choice = task_choice
    self.center_pos = (-0.0125, -0.07)
    self.object1_sid = m.name2id("site", "ball1_site")
    self.object2_sid = m.name2id("site", "ball2_site")
    self.target1_sid = m.name2id("site", "target1_site")
    self.target2_sid = m.name2id("site", "target2_site")
    self.palm_bid = int(m.site_bodyid[self.target1_sid])
    self.target_z = (float(m.site_pos[self.target1_sid][2]),
                     float(m.site_pos[self.target2_sid][2]))

  # ---- draws (a parity test overrides these to hand in JAX's) -----------

  def draw_goal(self, batch: int, device, generator):
    """The episode's goal draws, each [B]: the task's index into
    (hold, clockwise, counter-clockwise) and the start angle U(0, 2 pi)
    (both read only under ``task_choice="random"``), then the x and y
    radii and the period, U over their ranges."""
    u = lambda lo, hi: uniform((batch,), generator, device, self.dtype, lo,
                               hi)
    choice = torch.floor(u(0.0, 3.0)).long().clamp(max=2)
    return (choice, u(0.0, 2 * math.pi), u(*self.goal_xrange),
            u(*self.goal_yrange), u(*self.goal_time_period))

  def draw_ball_overlay(self, batch: int, device, generator) -> dict:
    """The balls' per-env draws for the ranges that are set: radii
    ``size`` [B, 2], masses ``mass`` [B, 2] and friction offsets
    ``friction`` [B, 2, 3], U(-change, change)."""
    out = {}
    if self.obj_size_range:
      out["size"] = uniform((batch, 2), generator, device, self.dtype,
                            *self.obj_size_range)
    if self.obj_mass_range:
      out["mass"] = uniform((batch, 2), generator, device, self.dtype,
                            *self.obj_mass_range)
    if self.obj_friction_change:
      delta = torch.as_tensor(self.obj_friction_change, device=device).to(
          self.dtype)
      out["friction"] = (2 * uniform((batch, 2, 3), generator, device,
                                     self.dtype) - 1) * delta
    return out

  # ---- task -------------------------------------------------------------

  def reset_aux(self, batch: int, device, generator) -> dict:
    choice, angle1, xr, yr, period = self.draw_goal(batch, device, generator)
    choice = choice.long()
    if self.task_choice == "random":
      sign = torch.as_tensor(_TASK_SIGNS, device=device).to(
          self.dtype)[choice]
    else:
      sign = torch.full((batch,), _TASK_SIGNS[2], dtype=self.dtype,
                        device=device)
      angle1 = torch.full((batch,), np.pi / 4.0, dtype=self.dtype,
                          device=device)
    return {"sign": sign, "angle1": angle1, "x_radius": xr, "y_radius": yr,
            "time_period": period}

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    if not (self.obj_size_range or self.obj_mass_range
            or self.obj_friction_change):
      return {}
    draws = self.draw_ball_overlay(batch, device, generator)
    dm = self.device_model(device)
    gids = torch.as_tensor(self.ball_gids, device=device)
    out = {}
    if "size" in draws:
      sizes = dm.geom_size.expand(batch, -1, -1).clone()
      sizes[:, gids, 0] = draws["size"]
      out["geom_size"] = sizes
    if "mass" in draws:
      masses = dm.body_mass.expand(batch, -1).clone()
      masses[:, torch.as_tensor(self.ball_bids, device=device)] = draws["mass"]
      out["body_mass"] = masses
    if "friction" in draws:
      fric = dm.geom_friction.expand(batch, -1, -1).clone()
      fric[:, gids] = dm.geom_friction[gids] + draws["friction"]
      out["geom_friction"] = fric
    return out

  def _target_world(self, data: Data, aux: dict):
    """Both targets' world positions [B, 3] at the data's time."""
    base = aux["sign"] * 2 * np.pi * (data.time / aux["time_period"])
    a1 = base + aux["angle1"]
    a2 = base + aux["angle1"] - np.pi
    cx, cy = self.center_pos
    bpos = data.xpos[:, self.palm_bid]
    bmat = data.xmat[:, self.palm_bid]
    out = []
    for a, z in ((a1, self.target_z[0]), (a2, self.target_z[1])):
      local = torch.stack([aux["x_radius"] * torch.cos(a) + cx,
                           aux["y_radius"] * torch.sin(a) + cy,
                           torch.full_like(a, z)], -1)
      out.append(bpos + (bmat @ local[..., None])[..., 0])
    return out

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    t1, t2 = self._target_world(data, aux)
    o1 = data.site_xpos[:, self.object1_sid]
    o2 = data.site_xpos[:, self.object2_sid]
    return {
        "time": data.time[:, None],
        "hand_pos": data.qpos[:, :-14],
        "object1_pos": o1,
        "object2_pos": o2,
        "object1_velp": data.qvel[:, -12:-9] * self.dt,
        "object2_velp": data.qvel[:, -6:-3] * self.dt,
        "target1_pos": t1,
        "target2_pos": t2,
        "target1_err": t1 - o1,
        "target2_err": t2 - o2,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    d1 = torch.linalg.vector_norm(obs_dict["target1_err"], dim=-1)
    d2 = torch.linalg.vector_norm(obs_dict["target2_err"], dim=-1)
    is_fall = ((obs_dict["object1_pos"][:, 2] < self.drop_th)
               | (obs_dict["object2_pos"][:, 2] < self.drop_th))
    return {
        "pos_dist_1": -1.0 * d1,
        "pos_dist_2": -1.0 * d2,
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "sparse": -(d1 + d2),
        "solved": ((d1 < self.proximity_th) & (d2 < self.proximity_th)
                   & ~is_fall),
        "done": is_fall,
    }
