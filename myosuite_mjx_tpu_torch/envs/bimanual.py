"""MyoChallenge bimanual (BimanualEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/bimanual.py``: the arm passes an
object to a prosthetic hand, which sets it on a goal pillar. The reward
stack (reach, finger opening and distance, lift, elbow, pass, goal), the
start and goal jitter per episode, the contact classes of the object
(touching the arm, the prosthesis, the start or the goal pillar, or
anything else), counted by body-id ranges over the culled contact slots,
and the goal-touch count that the solve condition needs, carried in aux
from step to step.

Per-env overlays: the object's mass, and one friction draw that the
reference adds to **every** geom's friction (its object geom id is
``None``: its ``Model`` has no ``body_geomadr``, and ``.at[None]``
updates the whole table); the port matches it. Upstream perturbs the
object's friction alone.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import EnvState, MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform

MAX_TIME = 10.0
GOAL_CONTACT = 5


class BimanualEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "time", "myohand_qpos", "myohand_qvel", "pros_hand_qpos",
      "pros_hand_qvel", "object_qpos", "object_qvel", "touching_body",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "reach_dist": -0.1,
      "act": 0,
      "fin_dis": -0.5,
      "pass_err": -1,
  }

  def _setup(self, start_center=(-0.4, -0.25, 1.05),
             goal_center=(0.4, -0.25, 1.05),
             start_shifts=(0.055, 0.055, 0), goal_shifts=(0.098, 0.098, 0),
             proximity_th=0.17, max_force=1500,
             obj_scale_change=None, obj_mass_change=None,
             obj_friction_change=None, task_choice="fixed",
             start_pos=None, goal_pos=None, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.proximity_th = proximity_th
    self.start_center = np.asarray(start_center, np.float64)
    self.goal_center = np.asarray(goal_center, np.float64)
    self.start_shifts = np.asarray(start_shifts, np.float64)
    self.goal_shifts = np.asarray(goal_shifts, np.float64)
    self.PILLAR_HEIGHT = 1.09
    self.obj_scale_change = obj_scale_change
    self.obj_mass_change = obj_mass_change
    self.obj_friction_change = obj_friction_change

    names = m.names["body"]
    self.obj_bid = m.name2id("body", "manip_object")
    self.start_bid = m.name2id("body", "start")
    self.goal_bid = m.name2id("body", "goal")
    myo = [i for n, i in names.items()
           if not n.startswith("prosthesis")
           and n not in ("start", "goal", "manip_object", "world")]
    pro = [i for n, i in names.items() if n.startswith("prosthesis/")]
    self.myo_body_range = (min(myo), max(myo))
    self.prosth_body_range = (min(pro), max(pro))

    def joint_sel(pred, adr):
      return np.asarray(sorted(
          int(adr[i]) for n, i in m.names["joint"].items() if pred(n)))

    is_myo = lambda n: (not n.startswith("prosthesis")
                        and n != "manip_object/freejoint")
    is_pro = lambda n: n.startswith("prosthesis")
    self.myo_qadr = joint_sel(is_myo, m.jnt_qposadr)
    self.myo_dadr = joint_sel(is_myo, m.jnt_dofadr)
    self.pro_qadr = joint_sel(is_pro, m.jnt_qposadr)
    self.pro_dadr = joint_sel(is_pro, m.jnt_dofadr)
    obj_jnt = m.name2id("joint", "manip_object/freejoint")
    obj_q, obj_d = int(m.jnt_qposadr[obj_jnt]), int(m.jnt_dofadr[obj_jnt])
    self.obj_qadr = np.arange(obj_q, obj_q + 7)
    self.obj_dadr = np.arange(obj_d, obj_d + 6)

    self.obj_sid = m.name2id("site", "touch_site")
    self.palm_sid = m.name2id("site", "S_grasp")
    self.fins = [m.name2id("site", s)
                 for s in ("THtip", "IFtip", "MFtip", "RFtip", "LFtip")]
    self.rpalm1_sid = m.name2id("site", "prosthesis/palm_thumb")
    self.rpalm2_sid = m.name2id("site", "prosthesis/palm_pinky")
    self.elbow_qadr = int(m.jnt_qposadr[m.name2id("joint", "elbow_flexion")])
    # the z references at qpos0 (float64 kinematics on the CPU)
    sites = self.sites_at_qpos0()
    self.init_obj_z = float(sites[self.obj_sid][2])
    self.init_palm_z = float(sites[self.palm_sid][2])
    self.target_z = 0.2

  # ---- draws (a parity test overrides these to hand in JAX's) -----------

  def draw_start_goal(self, batch: int, device, generator):
    """U(0, 1) draws [B, 3] for the start's and the goal's jitter."""
    return (uniform((batch, 3), generator, device, self.dtype),
            uniform((batch, 3), generator, device, self.dtype))

  def draw_object_overlay(self, batch: int, device, generator):
    """The object's mass change [B], U(obj_mass_change), and the friction
    offset [B, 3], U(-obj_friction_change, obj_friction_change); None for
    a range that is not set."""
    mass = (None if not self.obj_mass_change else
            uniform((batch,), generator, device, self.dtype,
                    *self.obj_mass_change))
    fric = None
    if self.obj_friction_change:
      delta = torch.as_tensor(self.obj_friction_change, device=device).to(
          self.dtype)
      fric = -delta + 2 * delta * uniform((batch, 3), generator, device,
                                          self.dtype)
    return mass, fric

  # ---- task -------------------------------------------------------------

  def reset_aux(self, batch: int, device, generator) -> dict:
    u1, u2 = self.draw_start_goal(batch, device, generator)
    t = lambda x: torch.as_tensor(x, device=device).to(self.dtype)
    start = t(self.start_center) + t(self.start_shifts) * (2 * u1 - 1)
    goal = t(self.goal_center) + t(self.goal_shifts) * (2 * u2 - 1)
    return {"start_pos": start, "goal_pos": goal,
            "goal_touch": torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
            "max_force": torch.zeros((batch,), dtype=self.dtype,
                                     device=device)}

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    dm = self.device_model(device)
    mass, fric = self.draw_object_overlay(batch, device, generator)
    out = {}
    if mass is not None:
      masses = dm.body_mass.expand(batch, -1).clone()
      masses[:, self.obj_bid] = float(self.model.body_mass[self.obj_bid]) + mass
      out["body_mass"] = masses
    if fric is not None:
      # the reference's trap, kept for parity: one draw on every geom
      out["geom_friction"] = dm.geom_friction + fric[:, None, :]
    return out

  def _touching_vec(self, data: Data) -> torch.Tensor:
    """[B, 5] contact classes of the object: the arm, the prosthesis, the
    start pillar, the goal pillar, anything else."""
    gb = self.device_model(data.qpos.device).geom_bodyid
    c = data.contact
    g1b, g2b = gb[c.geom1.long()], gb[c.geom2.long()]
    active = c.dist < c.includemargin
    sel = active & ((g1b == self.obj_bid) | (g2b == self.obj_bid))
    other = torch.where(g1b == self.obj_bid, g2b, g1b)
    in_range = lambda lo, hi: (other >= lo) & (other <= hi)
    myo = in_range(*self.myo_body_range)
    pro = in_range(*self.prosth_body_range)
    start = other == self.start_bid
    goal = other == self.goal_bid
    env = ~(myo | pro | start | goal)
    return torch.stack([(sel & k).any(-1) for k in (myo, pro, start, goal,
                                                      env)],
                       -1).to(self.dtype)

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    palm = data.site_xpos[:, self.palm_sid]
    obj = data.site_xpos[:, self.obj_sid]
    rpalm = 0.5 * (data.site_xpos[:, self.rpalm1_sid]
                   + data.site_xpos[:, self.rpalm2_sid])
    obs = {
        "time": data.time[:, None],
        "myohand_qpos": data.qpos[:, self.myo_qadr],
        "myohand_qvel": data.qvel[:, self.myo_dadr],
        "pros_hand_qpos": data.qpos[:, self.pro_qadr],
        "pros_hand_qvel": data.qvel[:, self.pro_dadr],
        "object_qpos": data.qpos[:, self.obj_qadr],
        "object_qvel": data.qvel[:, self.obj_dadr],
        "touching_body": self._touching_vec(data),
        "start_pos": aux["start_pos"],
        "goal_pos": aux["goal_pos"],
        "elbow_fle": data.qpos[:, self.elbow_qadr:self.elbow_qadr + 1],
        "palm_pos": palm,
        "Rpalm_pos": rpalm,
        "obj_pos": obj,
        "reach_err": palm - obj,
        "pass_err": rpalm - obj,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }
    for i, s in enumerate(self.fins):
      obs[f"fin{i}"] = data.site_xpos[:, s]
    return obs

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    reach_dist = norm(obs_dict["reach_err"]).abs()
    pass_dist = norm(obs_dict["pass_err"]).abs()
    obj = obs_dict["obj_pos"]
    palm = obs_dict["palm_pos"]
    goal = torch.cat([obs_dict["goal_pos"][:, :2],
                      torch.full_like(obj[:, :1], self.PILLAR_HEIGHT)], -1)
    lift = norm(torch.stack([obj[:, 2], palm[:, 2]], -1)
                - obj.new_tensor([self.init_obj_z, self.init_palm_z]))
    lift_height = 5 * torch.exp(-10 * (lift - self.target_z) ** 2) - 5
    fin_open = sum(norm(obs_dict[f"fin{i}"] - palm) for i in range(5))
    fin_dis = sum(norm(obs_dict[f"fin{i}"] - obj) for i in range(5))
    elbow_err = 5 * torch.exp(
        -10 * (obs_dict["elbow_fle"][:, 0] - 1.0) ** 2) - 5
    goal_dis = norm(obj - goal).abs()
    goal_touch = aux["goal_touch"] + (
        obs_dict["touching_body"][:, 3] > 0).to(torch.int32)
    solved = (goal_dis < self.proximity_th) & (goal_touch >= GOAL_CONTACT)
    done = (data.time > MAX_TIME) | (obj[:, 2] < 0.3) | solved
    return {
        "reach_dist": reach_dist + torch.log(reach_dist + 1e-6),
        "act": self.act_magnitude(obs_dict["act"]),
        "fin_open": torch.exp(-5 * fin_open),
        "fin_dis": fin_dis + torch.log(fin_dis + 1e-6),
        "lift_bonus": elbow_err,
        "lift_height": lift_height,
        "pass_err": pass_dist + torch.log(pass_dist + 1e-3),
        "sparse": torch.zeros_like(reach_dist),
        "goal_dist": goal_dis,
        "solved": solved,
        "done": done,
    }

  def _mk_state(self, data: Data, aux: dict, steps,
                generator: torch.Generator | None = None) -> EnvState:
    state = super()._mk_state(data, aux, steps, generator)
    # carry the goal-touch count into aux for the next step
    inc = (self._touching_vec(data)[:, 3] > 0).to(torch.int32)
    return state.replace(aux={**aux, "goal_touch": aux["goal_touch"] + inc})
