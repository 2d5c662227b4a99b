"""Joint-pose matching tasks (PoseEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/pose.py``: fixed or drawn target
joint poses, reset to the init pose or a uniform joint state, reward =
weighted {pose, bonus, act_reg, penalty} with the far-threshold
termination.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv

# myoHandPoseFixed-v0's task kwargs (myosuite_mjx_tpu/envs/myobase.py), with
# the MyoEnv defaults frame_skip 10 and horizon 100 written out; the target
# is in MyoHand's joint order, which the hand23 fixture keeps
HAND_POSE_FIXED = dict(
    frame_skip=10, horizon=100, normalize_act=True, pose_thd=0.7,
    reset_type="init", target_type="fixed",
    target_jnt_value=[
        0, 0, 0, -0.0904, 0.0824475, -0.681555, -0.514888, 0,
        -0.013964, -0.0458132, 0, 0.67553, -0.020944, 0.76979,
        0.65982, 0, 0, 0, 0, 0.479155, -0.099484, 0.95831, 0,
    ])


def _uniform(lo: torch.Tensor, hi: torch.Tensor, batch: int, generator):
  u = torch.rand((batch,) + tuple(lo.shape), generator=generator,
                 device=lo.device, dtype=lo.dtype)
  return lo + (hi - lo) * u


class PoseEnv(MyoEnv):
  # obs and reward read no contact state: reset skips collision and Newton
  RESET_CONSTRAINT = False
  DEFAULT_OBS_KEYS = ["qpos", "qvel", "pose_err"]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pose": 1.0,
      "bonus": 4.0,
      "act_reg": 1.0,
      "penalty": 50,
  }

  def _setup(self, target_jnt_range: dict | None = None,
             target_jnt_value: list | None = None,
             reset_type: str = "init", target_type: str = "generate",
             pose_thd: float = 0.35, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.reset_type = reset_type
    self.target_type = target_type
    self.pose_thd = pose_thd
    self.far_th = 4 * np.pi / 2
    if target_jnt_range is not None:
      ids = [m.name2id("joint", name) for name in target_jnt_range]
      self.target_jnt_qposadr = m.jnt_qposadr[np.asarray(ids)]
      self.target_jnt_range = np.asarray(list(target_jnt_range.values()),
                                         dtype=np.float64)
      default_target = np.array(m.qpos0, np.float64)
      default_target[self.target_jnt_qposadr] = self.target_jnt_range.mean(1)
    else:
      default_target = np.asarray(target_jnt_value, np.float64)
    self.default_target = default_target

  def reset_aux(self, batch, device, generator) -> dict:
    target = torch.as_tensor(self.default_target, device=device).to(
        self.dtype).expand(batch, -1).clone()
    if self.target_type == "generate":
      rng = torch.as_tensor(self.target_jnt_range, device=device).to(
          self.dtype)
      qadr = torch.as_tensor(self.target_jnt_qposadr, device=device)
      target[:, qadr] = _uniform(rng[:, 0], rng[:, 1], batch, generator)
    return {"target_jnt_value": target}

  def reset_qpos_qvel(self, batch, device, aux, generator):
    if self.reset_type == "random":
      m = self.model
      rng = torch.as_tensor(m.jnt_range, device=device).to(self.dtype)
      qpos, qvel = super().reset_qpos_qvel(batch, device, aux, generator)
      qpos[:, torch.as_tensor(m.jnt_qposadr, device=device)] = _uniform(
          rng[:, 0], rng[:, 1], batch, generator)
      return qpos, qvel
    return super().reset_qpos_qvel(batch, device, aux, generator)

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    return {
        "time": data.time[:, None],
        "qpos": data.qpos,
        "qvel": data.qvel * self.dt,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
        "pose_err": aux["target_jnt_value"] - data.qpos,
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    pose_dist = torch.linalg.vector_norm(obs_dict["pose_err"], dim=-1)
    act_mag = torch.linalg.vector_norm(obs_dict["act"], dim=-1)
    if self.model.na:
      act_mag = act_mag / self.model.na
    f = lambda b: b.to(pose_dist.dtype)
    return {
        "pose": -1.0 * pose_dist,
        "bonus": f(pose_dist < self.pose_thd)
                 + f(pose_dist < 1.5 * self.pose_thd),
        "penalty": -1.0 * f(pose_dist > self.far_th),
        "act_reg": -1.0 * act_mag,
        "sparse": -1.0 * pose_dist,
        "solved": pose_dist < self.pose_thd,
        "done": pose_dist > self.far_th,
    }
