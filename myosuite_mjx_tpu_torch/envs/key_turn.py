"""Key-turn task (KeyTurnEnv) on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/key_turn.py``: the index finger and
the thumb turn a key on a hinge, the last dof; approach terms keep both
tips at the key's head. The Random variant draws the key's start angle.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform


class KeyTurnEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_qpos", "hand_qvel", "key_qpos", "key_qvel",
      "IFtip_approach", "THtip_approach",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "key_turn": 1.0,
      "IFtip_approach": 10.0,
      "THtip_approach": 10.0,
      "act_reg": 1.0,
      "bonus": 4.0,
      "penalty": 25.0,
  }

  def _setup(self, goal_th: float = np.pi, key_init_range=(0.0, 0.0),
             **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.goal_th = goal_th
    self.key_init_range = tuple(key_init_range)
    self.keyhead_sid = m.name2id("site", "keyhead")
    self.IF_sid = m.name2id("site", "IFtip")
    self.TH_sid = m.name2id("site", "THtip")
    self.init_qpos[:-1] *= 0  # fully open hand

  def draw_key_angle(self, batch: int, device, generator) -> torch.Tensor:
    """The key's start angle [B], U(key_init_range) (a parity test
    overrides this to hand in JAX's draws)."""
    lo, hi = self.key_init_range
    return uniform((batch,), generator, device, self.dtype, lo, hi)

  def reset_qpos_qvel(self, batch: int, device, aux: dict, generator):
    qpos, qvel = super().reset_qpos_qvel(batch, device, aux, generator)
    qpos[:, -1] = self.draw_key_angle(batch, device, generator)
    return qpos, qvel

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    keyhead = data.site_xpos[:, self.keyhead_sid]
    return {
        "time": data.time[:, None],
        "hand_qpos": data.qpos[:, :-1],
        "hand_qvel": data.qvel[:, :-1] * self.dt,
        "key_qpos": data.qpos[:, -1:],
        "key_qvel": data.qvel[:, -1:] * self.dt,
        "IFtip_approach": keyhead - data.site_xpos[:, self.IF_sid],
        "THtip_approach": keyhead - data.site_xpos[:, self.TH_sid],
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    IF_approach = (norm(obs_dict["IFtip_approach"]) - 0.030).abs()
    TH_approach = (norm(obs_dict["THtip_approach"]) - 0.030).abs()
    key_pos = obs_dict["key_qpos"][:, 0]
    f = lambda b: b.to(key_pos.dtype)
    far_th = 0.1
    return {
        "key_turn": key_pos,
        "IFtip_approach": -1.0 * IF_approach,
        "THtip_approach": -1.0 * TH_approach,
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "bonus": f(key_pos > np.pi / 2) + f(key_pos > np.pi),
        "penalty": (-1.0 * f(IF_approach > far_th / 2)
                    - f(TH_approach > far_th / 2)),
        "sparse": key_pos,
        "solved": key_pos > self.goal_th,
        "done": (IF_approach > far_th) | (TH_approach > far_th),
    }
