"""Sensors the Myo suite reads, on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/engine/sensors.py``. A touch sensor sums
the normal forces of the active contacts on its site's body (the
reference's stand-in for MuJoCo's site-volume test, made for foot-sized
zones); a force sensor is the interaction force between the site's body
subtree and its parent, in the site frame; joint and actuator sensors read
the state. Every function returns one value per env, ``[B, ...]``.
"""
from __future__ import annotations

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import (DSBL_GRAVITY, DeviceModel,
                                                 SensorType)


def _active(d: Data) -> torch.Tensor:
  """[B, ncon] contacts within their margin."""
  return d.contact.dist < d.contact.includemargin


def touch_sensor(m: DeviceModel, d: Data, site_id: int) -> torch.Tensor:
  """Total contact normal force [B] on the site's body."""
  body = int(m.host.site_bodyid[site_id])
  gb = m.geom_bodyid
  on_body = ((gb[d.contact.geom1.long()] == body)
             | (gb[d.contact.geom2.long()] == body))
  force = torch.clamp(d.contact_force, min=0.0)
  return torch.where(on_body & _active(d), force,
                     torch.zeros_like(force)).sum(-1)


def _subtree_mask(m, body: int) -> np.ndarray:
  """[nbody] 0/1: the bodies in the subtree rooted at ``body`` (``m`` a
  host Model or a DeviceModel)."""
  h = getattr(m, "host", m)
  mask = np.zeros(h.nbody)
  parent = np.asarray(h.body_parentid)
  for b in range(h.nbody):
    c = b
    while True:
      if c == body:
        mask[b] = 1.0
        break
      if c == 0:
        break
      c = int(parent[c])
  return mask


def force_sensor(m: DeviceModel, d: Data, site_id: int) -> torch.Tensor:
  """Site ``<force>`` sensor [B, 3]: the force between the site's body
  subtree and its parent, in the site frame.

  With world-origin spatial accelerations (gravity folded into the base)
  the subtree's force balance gives the linear part of

    F_int(b) = sum_{c in subtree(b)} (I_c cacc_c + cvel_c x* I_c cvel_c
                                      - F_ext_c),

  F_ext being the contact forces and ``xfrc_applied``. The linear part of
  a world-origin wrench does not depend on where it acts, so no torque is
  propagated.
  """
  h = m.host
  body = int(h.site_bodyid[site_id])
  gravity = (np.zeros(3) if m.opt.disableflags & DSBL_GRAVITY
             else np.asarray(m.opt.gravity, np.float64))
  base = m.tensor(np.concatenate([np.zeros(3), -gravity]))

  # each body's acceleration: the base (0, -g) plus its ancestor chain's
  # cdof qacc + cdof_dot qvel
  contrib = d.cdof * d.qacc[..., None] + d.cdof_dot * d.qvel[..., None]
  cacc = smooth.body_dof_mask(m) @ contrib + base            # [B, nbody, 6]
  mom = smooth.inert_mul(d.cinert, d.cvel)
  cfrc = smooth.inert_mul(d.cinert, cacc) + smooth.force_cross(d.cvel, mom)

  # external forces: a contact pushes body2 by +F and body1 by -F
  fvec = torch.where(_active(d)[..., None], d.contact_force_vec,
                     torch.zeros_like(d.contact_force_vec))
  gb = m.geom_bodyid
  idx = lambda g: gb[g.long()][..., None].expand(fvec.shape)
  ext = torch.zeros_like(cfrc[..., 3:])
  ext = ext.scatter_add(1, idx(d.contact.geom2), fvec)
  ext = ext.scatter_add(1, idx(d.contact.geom1), -fvec)
  ext = ext + d.xfrc_applied[..., :3]

  sub = m.tensor(_subtree_mask(h, body))
  f_int = (sub[:, None] * (cfrc[..., 3:] - ext)).sum(-2)     # [B, 3]
  # in the site frame; the force applied to the child subtree
  return (d.site_xmat[:, site_id] * f_int[..., :, None]).sum(-2)


def sensor_by_name(m: DeviceModel, d: Data, name: str) -> torch.Tensor:
  """One named sensor [B, dim] (touch, force, joint and actuator
  position, velocity and force)."""
  h = m.host
  sid = h.name2id("sensor", name)
  stype = int(h.sensor_type[sid])
  objid = int(h.sensor_objid[sid])
  if stype == SensorType.TOUCH:
    return touch_sensor(m, d, objid)[:, None]
  if stype == SensorType.JOINTPOS:
    return d.qpos[:, int(h.jnt_qposadr[objid])][:, None]
  if stype == SensorType.JOINTVEL:
    return d.qvel[:, int(h.jnt_dofadr[objid])][:, None]
  if stype == SensorType.ACTUATORPOS:
    return d.actuator_length[:, objid][:, None]
  if stype == SensorType.ACTUATORVEL:
    return d.actuator_velocity[:, objid][:, None]
  if stype == SensorType.ACTUATORFRC:
    return d.actuator_force[:, objid][:, None]
  if stype == SensorType.FORCE:
    return force_sensor(m, d, objid)
  raise NotImplementedError(f"sensor type {stype}")
