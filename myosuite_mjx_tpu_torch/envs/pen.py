"""Pen-twirl tasks (PenTwirlFixedEnv, PenTwirlRandomEnv) on a batch of
environments.

Counterpart of ``myosuite_mjx_tpu/envs/pen.py``: the palm-up hand turns a
pen (six scalar joints, the last dofs) to a target orientation while
keeping it near the desired position. The Random variant draws the target
orientation per episode, as the reference does: the target sites' local
axis rotated by a drawn roll and pitch.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform
from myosuite_mjx_tpu_torch.ops import quat as qmath


class PenTwirlFixedEnv(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_jnt", "obj_pos", "obj_vel", "obj_rot", "obj_des_rot",
      "obj_err_pos", "obj_err_rot",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pos_align": 1.0,
      "rot_align": 1.0,
      "act_reg": 5.0,
      "drop": 5.0,
      "bonus": 10.0,
  }

  randomize_target = False

  def _setup(self, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.obj_bid = m.name2id("body", "Object")
    self.target_bid = m.name2id("body", "target")
    self.eps_ball_sid = m.name2id("site", "eps_ball")
    self.obj_t_sid = m.name2id("site", "object_top")
    self.obj_b_sid = m.name2id("site", "object_bottom")
    self.tar_t_sid = m.name2id("site", "target_top")
    self.tar_b_sid = m.name2id("site", "target_bottom")
    self.pen_length = float(np.linalg.norm(
        m.site_pos[self.obj_t_sid] - m.site_pos[self.obj_b_sid]))
    self.tar_length = float(np.linalg.norm(
        m.site_pos[self.tar_t_sid] - m.site_pos[self.tar_b_sid]))
    # the target sites' axis in the target body's frame
    self.tar_axis_local = np.asarray(
        m.site_pos[self.tar_t_sid] - m.site_pos[self.tar_b_sid])
    self.init_qpos[:-6] *= 0
    self.init_qpos[0] = -1.5  # palm up

  def draw_target_euler(self, batch: int, device, generator) -> torch.Tensor:
    """The target's roll and pitch [B, 2], U(-1, 1) (a parity test
    overrides this to hand in JAX's draws)."""
    return uniform((batch, 2), generator, device, self.dtype, -1.0, 1.0)

  def reset_aux(self, batch: int, device, generator) -> dict:
    if not self.randomize_target:
      return {"des_rot": torch.zeros((batch, 0), dtype=self.dtype,
                                     device=device)}
    rp = self.draw_target_euler(batch, device, generator)
    q = qmath.euler_to_quat(torch.cat([rp, torch.zeros_like(rp[:, :1])], -1))
    axis = qmath.quat_rotate(q, torch.as_tensor(
        self.tar_axis_local, device=device).to(self.dtype))
    return {"des_rot": axis / self.tar_length}

  def _des_rot(self, data: Data, aux: dict) -> torch.Tensor:
    if self.randomize_target:
      return aux["des_rot"]
    return (data.site_xpos[:, self.tar_t_sid]
            - data.site_xpos[:, self.tar_b_sid]) / self.tar_length

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    obj_pos = data.xpos[:, self.obj_bid]
    des_pos = data.site_xpos[:, self.eps_ball_sid]
    obj_rot = (data.site_xpos[:, self.obj_t_sid]
               - data.site_xpos[:, self.obj_b_sid]) / self.pen_length
    des_rot = self._des_rot(data, aux)
    return {
        "time": data.time[:, None],
        "hand_jnt": data.qpos[:, :-6],
        "obj_pos": obj_pos,
        "obj_des_pos": des_pos,
        "obj_vel": data.qvel[:, -6:] * self.dt,
        "obj_rot": obj_rot,
        "obj_des_rot": des_rot,
        "obj_err_pos": obj_pos - des_pos,
        "obj_err_rot": obj_rot - des_rot,
        "act": data.act if self.model.na else torch.zeros_like(data.qpos),
    }

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    pos_align = norm(obs_dict["obj_err_pos"])
    a, b = obs_dict["obj_rot"], obs_dict["obj_des_rot"]
    # per env: the norms are over the last axis, never the batch
    rot_align = (a * b).sum(-1) / torch.clamp(norm(a) * norm(b), min=1e-12)
    dropped = pos_align > 0.075
    f = lambda x: x.to(pos_align.dtype)
    return {
        "pos_align": -1.0 * pos_align,
        "rot_align": rot_align,
        "act_reg": -1.0 * self.act_magnitude(obs_dict["act"]),
        "drop": -1.0 * f(dropped),
        "bonus": (1.0 * f(rot_align > 0.9) * f(pos_align < 0.075)
                  + 5.0 * f(rot_align > 0.95) * f(pos_align < 0.075)),
        "sparse": -1.0 * pos_align + rot_align,
        "solved": (rot_align > 0.95) & ~dropped,
        "done": dropped,
    }


class PenTwirlRandomEnv(PenTwirlFixedEnv):
  randomize_target = True
