"""The SAR reorientation family on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/reorient_sar.py``: in-hand
reorientation of an object whose type (capsule, ellipsoid, cylinder, box)
and size are drawn per episode from a task's geometry table. The scene
carries one geom of each type on the ``Object`` body; the episode's
overlay gives the drawn one its size, shrinks the other three to a point
inside it and sets the object's mass to 1.2 kg. The orientation vectors
are the object's z axis scaled by the marker spacing over 0.07 (the
reference's frozen pen length), so they are not unit vectors.

The tables (``G8``, ``G100``, ``ID``, ``OOD``, one array per type) are
read from ``assets/sar_geometries.npz``, exported from the JAX package's
``envs/sar_geometries.py`` by ``python tests/torch_parity.py --export``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.envs.base import MyoEnv
from myosuite_mjx_tpu_torch.envs.randomize import uniform
from myosuite_mjx_tpu_torch.envs.registry import asset
from myosuite_mjx_tpu_torch.ops import quat as qmath

TYPE_NAMES = ("caps", "ellips", "cyl", "box")
# the pristine marker spacing (top and bottom markers at -+0.035)
_PEN_LENGTH = 0.07


@functools.lru_cache(maxsize=None)
def geometry_table(name: str) -> tuple[np.ndarray, ...]:
  """A task's size table: one [n, 3] array per type of ``TYPE_NAMES``."""
  with np.load(asset("sar_geometries.npz")) as z:
    return tuple(np.array(z[f"{name}_{t.upper()}"]) for t in TYPE_NAMES)


class SAREnvBase(MyoEnv):
  DEFAULT_OBS_KEYS = [
      "hand_jnt", "obj_pos", "obj_vel", "obj_rot", "obj_des_rot",
      "obj_err_pos", "obj_err_rot", "mlen", "mvel", "mforce",
  ]
  DEFAULT_RWD_KEYS_AND_WEIGHTS = {
      "pos_align": 1.0,
      "rot_align": 1.0,
      "act_reg": 5.0,
      "drop": 5.0,
      "bonus": 10.0,
  }

  TABLE = ""  # the task's table in sar_geometries.npz

  def _setup(self, **kwargs):
    super()._setup(**kwargs)
    m = self.model
    self.obj_bid = m.name2id("body", "Object")
    self.eps_ball_sid = m.name2id("site", "eps_ball")
    self.obj_gids = [m.name2id("geom", n) for n in
                     ("obj_caps", "obj_ellip", "obj_cyl", "obj_box")]
    # the open palm-up init; qpos[:-6] holds the object's x as well, which
    # the reference zeroes with the hand
    self.init_qpos[:-6] *= 0
    self.init_qpos[0] = -1.5
    tables = geometry_table(self.TABLE)
    n = max(len(t) for t in tables)
    self._sizes = np.zeros((4, n, 3), np.float64)
    for i, t in enumerate(tables):
      self._sizes[i, :len(t)] = t
    self._counts = np.array([len(t) for t in tables], np.int64)

  @staticmethod
  def _marker_off(type_idx, size):
    """The markers' offset along the object's z by type: 1.3 x the
    capsule's half length, the ellipsoid's z radius, the cylinder's half
    height, the box's z half size."""
    return torch.where(
        type_idx == 0, 1.3 * size[:, 1],
        torch.where(type_idx == 1, size[:, 2],
                    torch.where(type_idx == 2, size[:, 1], size[:, 2])))

  def draw_object(self, batch: int, device, generator):
    """The episode's object draws: its type [B] (uniform over the four),
    its row in that type's table [B] and the desired roll and pitch [B, 2]
    (U(-1, 1), U(-0.8, 1.2)) (a parity test overrides this to hand in
    JAX's draws)."""
    u = lambda lo, hi, shape=(batch,): uniform(shape, generator, device,
                                               torch.float64, lo, hi)
    type_idx = torch.floor(u(0.0, 4.0)).long().clamp(max=3)
    count = torch.as_tensor(self._counts, device=device)[type_idx]
    idx = torch.minimum(torch.floor(u(0.0, 1.0) * count).long(), count - 1)
    euler = torch.stack([u(-1.0, 1.0), u(-0.8, 1.2)], -1).to(self.dtype)
    return type_idx, idx, euler

  def reset_aux(self, batch: int, device, generator) -> dict:
    type_idx, idx, rp = self.draw_object(batch, device, generator)
    type_idx, idx = type_idx.long(), idx.long()
    size = torch.as_tensor(self._sizes, device=device).to(self.dtype)[
        type_idx, idx]
    off = self._marker_off(type_idx, size)
    q_des = qmath.euler_to_quat(torch.cat([rp, torch.zeros_like(rp[:, :1])],
                                          -1))
    axis = qmath.quat_rotate(q_des, torch.as_tensor(
        [0.0, 0.0, 1.0], device=device).to(self.dtype))
    scale = 2.0 * off / _PEN_LENGTH
    return {"type_idx": type_idx.to(torch.int32), "size": size,
            "scale": scale, "des_rot": axis * scale[:, None]}

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    dm = self.device_model(device)
    sizes = dm.geom_size.expand(batch, -1, -1).clone()
    eps = torch.full((batch, 3), 1e-5, dtype=self.dtype, device=device)
    for i, gid in enumerate(self.obj_gids):
      sizes[:, gid] = torch.where((aux["type_idx"] == i)[:, None],
                                  aux["size"], eps)
    mass = dm.body_mass.expand(batch, -1).clone()
    mass[:, self.obj_bid] = 1.2
    return {"geom_size": sizes, "body_mass": mass}

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    obj_pos = data.xpos[:, self.obj_bid]
    des_pos = data.site_xpos[:, self.eps_ball_sid]
    obj_rot = data.xmat[:, self.obj_bid, :, 2] * aux["scale"][:, None]
    return {
        "time": data.time[:, None],
        "hand_jnt": data.qpos[:, :-6],
        "obj_pos": obj_pos,
        "obj_des_pos": des_pos,
        "obj_vel": data.qvel[:, -6:] * self.dt,
        "obj_rot": obj_rot,
        "obj_des_rot": aux["des_rot"],
        "obj_err_pos": obj_pos - des_pos,
        "obj_err_rot": obj_rot - aux["des_rot"],
        "act": data.act,
        "mlen": data.actuator_length,
        "mvel": data.actuator_velocity,
        "mforce": data.actuator_force,
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
        "act_reg": -1.0 * norm(obs_dict["act"]) / self.model.na,
        "drop": -1.0 * f(dropped),
        "bonus": (1.0 * f(rot_align > 0.9) * f(pos_align < 0.075)
                  + 5.0 * f(rot_align > 0.95) * f(pos_align < 0.075)),
        "sparse": -1.0 * pos_align + rot_align,
        "solved": (rot_align > 0.95) & ~dropped,
        "done": dropped,
    }


class Geometries8Env(SAREnvBase):
  TABLE = "G8"


class Geometries100Env(SAREnvBase):
  TABLE = "G100"


class InDistributionEnv(SAREnvBase):
  TABLE = "ID"


class OutOfDistributionEnv(SAREnvBase):
  TABLE = "OOD"
