"""Smooth dynamics: forward kinematics, composite inertia, CRB, RNE.

Counterpart of ``myosuite_mjx_tpu/engine/smooth.py`` on batch-first
tensors. Spatial vectors are [angular; linear] in one world-origin frame.
The kinematic tree runs level by level (bodies grouped by depth); the
level and joint-slot index tensors are built once per ``DeviceModel``.
Hinge and slide joints are ported; ``DeviceModel`` rejects other types.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.model import (
    DSBL_GRAVITY, DeviceModel, JointType)
from myosuite_mjx_tpu_torch.ops import quat as qmath


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def motion_cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors: u x_m v."""
  ang = _cross(u[..., :3], v[..., :3])
  lin = _cross(u[..., :3], v[..., 3:]) + _cross(u[..., 3:], v[..., :3])
  return torch.cat([ang, lin], dim=-1)


def force_cross(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial cross product applied to a force vector: u x_f f."""
  ang = _cross(u[..., :3], f[..., :3]) + _cross(u[..., 3:], f[..., 3:])
  lin = _cross(u[..., :3], f[..., 3:])
  return torch.cat([ang, lin], dim=-1)


def spatial_inertia(mass, inertia_diag, com, imat) -> torch.Tensor:
  """Compact world-origin spatial inertia (Ixx, Iyy, Izz, Ixy, Ixz, Iyz,
  hx, hy, hz, m): I = R D R^T + m (|c|^2 E - c c^T), h = m c."""
  R, D, c = imat, inertia_diag, com

  def ic(a, b):
    return (R[..., a, 0] * D[..., 0] * R[..., b, 0]
            + R[..., a, 1] * D[..., 1] * R[..., b, 1]
            + R[..., a, 2] * D[..., 2] * R[..., b, 2])

  c2 = c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1] + c[..., 2] * c[..., 2]
  comp = [
      ic(0, 0) + mass * (c2 - c[..., 0] * c[..., 0]),
      ic(1, 1) + mass * (c2 - c[..., 1] * c[..., 1]),
      ic(2, 2) + mass * (c2 - c[..., 2] * c[..., 2]),
      ic(0, 1) - mass * c[..., 0] * c[..., 1],
      ic(0, 2) - mass * c[..., 0] * c[..., 2],
      ic(1, 2) - mass * c[..., 1] * c[..., 2],
      mass * c[..., 0],
      mass * c[..., 1],
      mass * c[..., 2],
      mass * torch.ones_like(c2),
  ]
  return torch.stack(torch.broadcast_tensors(*comp), dim=-1)


def inert_mul(c10: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """f = I v for compact inertia c10 [..., 10], motion v = [w; u] [..., 6]."""
  Ixx, Iyy, Izz = c10[..., 0], c10[..., 1], c10[..., 2]
  Ixy, Ixz, Iyz = c10[..., 3], c10[..., 4], c10[..., 5]
  h = c10[..., 6:9]
  mass = c10[..., 9]
  w, u = v[..., :3], v[..., 3:]
  iw = torch.stack([
      Ixx * w[..., 0] + Ixy * w[..., 1] + Ixz * w[..., 2],
      Ixy * w[..., 0] + Iyy * w[..., 1] + Iyz * w[..., 2],
      Ixz * w[..., 0] + Iyz * w[..., 1] + Izz * w[..., 2],
  ], dim=-1)
  ang = iw + _cross(h, u)
  lin = mass[..., None] * u - _cross(h, w)
  return torch.cat([ang, lin], dim=-1)


# ---------------------------------------------------------------------------
# static tree layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _JointGroup:
  """Joints of one type in one slot position of their bodies."""
  jtype: int
  bids: torch.Tensor      # [G] body of each joint
  jids: torch.Tensor      # [G]
  vadr: torch.Tensor      # [G] dof address
  qadr: torch.Tensor      # [G] qpos address
  jpos: torch.Tensor      # [G, 3]
  jaxis: torch.Tensor     # [G, 3]
  qpos0: torch.Tensor     # [G]


@dataclasses.dataclass(frozen=True)
class _Level:
  """Bodies at one tree depth, their parents and their own joint groups."""
  ids: torch.Tensor
  parents: torch.Tensor
  keep_ids: torch.Tensor      # bodies whose parent is not the world
  keep_parents: torch.Tensor
  joints: tuple               # ((jtype, bids, vadr), ...) in slot order


class _TreeSpec:
  """Bodies grouped by depth and joints grouped by slot and type, as index
  tensors (the reference's ``_TreeSpec``)."""

  def __init__(self, m: DeviceModel):
    h = m.host
    nb = h.nbody
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
    depth = np.zeros(nb, np.int64)
    for i in range(1, nb):
      depth[i] = depth[int(h.body_parentid[i])] + 1
    maxslots = int(h.body_jntnum.max()) if h.njnt else 0
    self.groups: list[_JointGroup] = []
    slot_groups = []
    for k in range(maxslots):
      has = np.where(h.body_jntnum > k)[0]
      jids = h.body_jntadr[has] + k
      for jt in np.unique(h.jnt_type[jids]):
        sel = h.jnt_type[jids] == jt
        b, j = has[sel], jids[sel]
        slot_groups.append((int(jt), b, h.jnt_dofadr[j]))
        self.groups.append(_JointGroup(
            jtype=int(jt), bids=t(b), jids=t(j), vadr=t(h.jnt_dofadr[j]),
            qadr=t(h.jnt_qposadr[j]), jpos=m.tensor(h.jnt_pos[j]),
            jaxis=m.tensor(h.jnt_axis[j]),
            qpos0=m.tensor(h.qpos0[h.jnt_qposadr[j]])))
    self.levels: list[_Level] = []
    for dlv in range(1, int(depth.max()) + 1 if nb > 1 else 1):
      ids = np.where(depth == dlv)[0]
      if not len(ids):
        continue
      parents = h.body_parentid[ids]
      keep = parents > 0
      joints = []
      for jt, b, vadr in slot_groups:
        sel = np.isin(b, ids)
        if sel.any():
          joints.append((jt, t(b[sel]), t(vadr[sel])))
      self.levels.append(_Level(t(ids), t(parents), t(ids[keep]),
                                t(parents[keep]), tuple(joints)))
    self.jnt_parentbid = t(h.body_parentid[h.jnt_bodyid])
    self.moving_bodies = t(np.arange(1, nb))
    self.hinge = [g for g in self.groups if g.jtype == JointType.HINGE]
    self.slide = [g for g in self.groups if g.jtype == JointType.SLIDE]
    self.ancestor_mask = m.tensor(_ancestor_mask(h))
    self.body_dof_mask = m.tensor(_build_body_dof_mask(h))


def tree_spec(m: DeviceModel) -> _TreeSpec:
  return m.spec("tree", _TreeSpec)


def _ancestor_mask(h) -> np.ndarray:
  """mask[i, j] = 1 where dof j is dof i or an ancestor of dof i."""
  mask = np.zeros((h.nv, h.nv), dtype=np.float64)
  for i in range(h.nv):
    j = i
    while j >= 0:
      mask[i, j] = 1.0
      j = int(h.dof_parentid[j])
  return mask


def _build_body_dof_mask(h) -> np.ndarray:
  mask = np.zeros((h.nbody, h.nv))
  for b in range(h.nbody):
    i = b
    while i > 0:
      da, dn = int(h.body_dofadr[i]), int(h.body_dofnum[i])
      mask[b, da:da + dn] = 1.0
      i = int(h.body_parentid[i])
  return mask


def body_dof_mask(m: DeviceModel) -> torch.Tensor:
  """[nbody, nv] mask: dofs on the ancestor chain of each body."""
  return tree_spec(m).body_dof_mask


# ---------------------------------------------------------------------------
# forward kinematics
# ---------------------------------------------------------------------------


def kinematics(m: DeviceModel, qpos: torch.Tensor, full_data: bool = True):
  """Body, joint, site and geom world poses for qpos [B, nq].

  ``full_data=False`` leaves out ``xmat`` and ``site_xmat``, which nothing
  in a physics step reads (the frame-skip loop asks for them on its last
  substep only).
  """
  B = qpos.shape[0]
  dtype = qpos.dtype
  spec = tree_spec(m)
  nb = m.nbody
  t_loc = m.body_pos.expand(B, nb, 3).clone()
  q_loc = m.body_quat.expand(B, nb, 4).clone()
  anchor_rel = qpos.new_zeros((B, max(m.njnt, 1), 3))
  axis_rel = qpos.new_zeros((B, max(m.njnt, 1), 3))

  # fold each body's joints into its local transform, one slot at a time
  for g in spec.groups:
    t = t_loc[:, g.bids]
    q = q_loc[:, g.bids]
    anch = t + qmath.quat_rotate(q, g.jpos)
    axr = qmath.quat_rotate(q, g.jaxis)
    anchor_rel[:, g.jids] = anch
    axis_rel[:, g.jids] = axr
    if g.jtype == JointType.HINGE:
      ang = qpos[:, g.qadr] - g.qpos0
      qn = qmath.quat_mul(q, qmath.axis_angle_to_quat(g.jaxis, ang))
      tn = anch - qmath.quat_rotate(qn, g.jpos)
    else:  # SLIDE
      disp = qpos[:, g.qadr] - g.qpos0
      tn = t + axr * disp[..., None]
      qn = q
    t_loc[:, g.bids] = tn
    q_loc[:, g.bids] = qn

  # level-wise composition down the tree
  xpos = qpos.new_zeros((B, nb, 3))
  xquat = qmath.quat_identity((B, nb), dtype=dtype, device=qpos.device)
  for lv in spec.levels:
    xqp = xquat[:, lv.parents]
    xpos[:, lv.ids] = xpos[:, lv.parents] + qmath.quat_rotate(
        xqp, t_loc[:, lv.ids])
    xquat[:, lv.ids] = qmath.quat_mul(xqp, q_loc[:, lv.ids])
  xquat = qmath.normalize(xquat)

  if m.njnt:
    pb = spec.jnt_parentbid
    xanchor = xpos[:, pb] + qmath.quat_rotate(xquat[:, pb],
                                              anchor_rel[:, :m.njnt])
    xaxis = qmath.quat_rotate(xquat[:, pb], axis_rel[:, :m.njnt])
  else:
    xanchor = qpos.new_zeros((B, 0, 3))
    xaxis = qpos.new_zeros((B, 0, 3))

  xipos = xpos + qmath.quat_rotate(xquat, m.body_ipos)
  ximat = qmath.quat_to_mat(qmath.quat_mul(xquat, m.body_iquat))
  xq_site = xquat[:, m.site_bodyid]
  site_xpos = xpos[:, m.site_bodyid] + qmath.quat_rotate(xq_site, m.site_pos)
  xq_geom = xquat[:, m.geom_bodyid]
  geom_xpos = xpos[:, m.geom_bodyid] + qmath.quat_rotate(xq_geom, m.geom_pos)
  geom_xmat = qmath.quat_to_mat(qmath.quat_mul(xq_geom, m.geom_quat))
  kin = dict(xpos=xpos, xquat=xquat, xipos=xipos, ximat=ximat,
             xanchor=xanchor, xaxis=xaxis, site_xpos=site_xpos,
             geom_xpos=geom_xpos, geom_xmat=geom_xmat)
  if full_data:
    kin["xmat"] = qmath.quat_to_mat(xquat)
    kin["site_xmat"] = qmath.quat_to_mat(qmath.quat_mul(xq_site, m.site_quat))
  return kin


# ---------------------------------------------------------------------------
# com-level quantities
# ---------------------------------------------------------------------------


def com_pos(m: DeviceModel, kin: dict):
  """subtree_com [B, nbody, 3], cinert [B, nbody, 10], cdof [B, nv, 6]."""
  xipos, ximat = kin["xipos"], kin["ximat"]
  B = xipos.shape[0]
  spec = tree_spec(m)
  mass = m.body_mass
  wsum = mass[:, None] * xipos
  msum = mass.expand(B, -1).clone()
  for lv in reversed(spec.levels):
    wsum.index_add_(1, lv.parents, wsum[:, lv.ids])
    msum.index_add_(1, lv.parents, msum[:, lv.ids])
  subtree_com = wsum / torch.clamp(msum, min=1e-12)[..., None]

  cinert = spatial_inertia(mass, m.body_inertia, xipos, ximat)

  cdof = xipos.new_zeros((B, m.nv, 6))
  xanchor, xaxis = kin["xanchor"], kin["xaxis"]
  for g in spec.hinge:
    ax = xaxis[:, g.jids]
    cdof[:, g.vadr] = torch.cat([ax, _cross(xanchor[:, g.jids], ax)], dim=-1)
  for g in spec.slide:
    ax = xaxis[:, g.jids]
    cdof[:, g.vadr] = torch.cat([torch.zeros_like(ax), ax], dim=-1)
  return subtree_com, cinert, cdof


def crb(m: DeviceModel, cinert: torch.Tensor, cdof: torch.Tensor):
  """Dense joint-space mass matrix [B, nv, nv] by composite rigid bodies."""
  spec = tree_spec(m)
  csub = cinert.clone()
  for lv in reversed(spec.levels):
    csub.index_add_(1, lv.parents, csub[:, lv.ids])
  F = inert_mul(csub[:, m.dof_bodyid], cdof)                  # [B, nv, 6]
  lower = (F @ cdof.transpose(-1, -2)) * spec.ancestor_mask
  qM = lower + lower.transpose(-1, -2) - torch.diag_embed(
      torch.diagonal(lower, dim1=-2, dim2=-1))
  return qM + torch.diag(m.dof_armature)


# ---------------------------------------------------------------------------
# velocity products
# ---------------------------------------------------------------------------


def com_vel(m: DeviceModel, cdof: torch.Tensor, qvel: torch.Tensor):
  """Body spatial velocities [B, nbody, 6] and cdof_dot [B, nv, 6]."""
  B = qvel.shape[0]
  spec = tree_spec(m)
  contrib = cdof * qvel[..., None]
  cvel = cdof.new_zeros((B, m.nbody, 6))
  cdof_dot = cdof.new_zeros((B, m.nv, 6))
  for lv in spec.levels:
    cvel[:, lv.ids] = cvel[:, lv.parents]
    for _, b, vadr in lv.joints:   # hinge and slide: axis fixed in own motion
      cdof_dot[:, vadr] = motion_cross(cvel[:, b], cdof[:, vadr])
      cvel.index_add_(1, b, contrib[:, vadr])
  return cvel, cdof_dot


def rne(m: DeviceModel, cinert, cdof, cdof_dot, cvel, qvel) -> torch.Tensor:
  """Bias force C(q, qvel) [B, nv] by recursive Newton-Euler (qacc = 0)."""
  B = qvel.shape[0]
  spec = tree_spec(m)
  gravity = m.tensor(m.opt.gravity)
  if m.opt.disableflags & DSBL_GRAVITY:
    gravity = torch.zeros_like(gravity)
  dotsum = cdof.new_zeros((B, m.nbody, 6))
  dotsum.index_add_(1, m.dof_bodyid, cdof_dot * qvel[..., None])

  cacc = cdof.new_zeros((B, m.nbody, 6))
  cacc[:, 0, 3:] = -gravity
  for lv in spec.levels:
    cacc[:, lv.ids] = cacc[:, lv.parents] + dotsum[:, lv.ids]

  mom = inert_mul(cinert, cvel)
  cfrc = inert_mul(cinert, cacc) + force_cross(cvel, mom)
  cfrc[:, 0] = 0.0
  for lv in reversed(spec.levels):
    if lv.keep_ids.numel():
      cfrc.index_add_(1, lv.keep_parents, cfrc[:, lv.keep_ids])
  return (cdof * cfrc[:, m.dof_bodyid]).sum(-1)


# ---------------------------------------------------------------------------
# jacobians
# ---------------------------------------------------------------------------


def point_jac_dir(m: DeviceModel, cdof: torch.Tensor, points: torch.Tensor,
                  bodyids: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
  """Directional point jacobian rows jacp(p_i, b_i)^T d_i, [B, S, nv].

  points, dirs [B, S, 3]; bodyids [S] or [B, S]. Uses the triple product
  (ang x p) . d = ang . (p x d), two [S, 3] x [3, nv] products per env.
  """
  mask = body_dof_mask(m)[bodyids]
  pc = _cross(points, dirs)
  proj = (dirs @ cdof[..., 3:].transpose(-1, -2)
          + pc @ cdof[..., :3].transpose(-1, -2))
  return proj * mask
