"""Smooth dynamics: forward kinematics, composite inertia, CRB, RNE.

Counterpart of ``myosuite_mjx_tpu/engine/smooth.py`` on batch-first
tensors. Spatial vectors are [angular; linear] in one world-origin frame.
The kinematic tree runs level by level (bodies grouped by depth); the
level and joint-slot index tensors are built once per ``DeviceModel``.
Every joint type is ported: hinge and slide, ball (a normalized
quaternion composed into the body's local frame) and free (the body's
absolute world pose, set in the level pass). Mocap bodies take
``Data.mocap_pos`` / ``mocap_quat`` as their local pose.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.model import (
    DSBL_GRAVITY, DeviceModel, JointType)
from myosuite_mjx_tpu_torch.ops import quat as qmath
from myosuite_mjx_tpu_torch.ops.vec import cross as _cross


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
  qidx: torch.Tensor | None   # [G, 4] a ball joint's quaternion in qpos
  rdofs: torch.Tensor     # [G, k] see _dofs
  tdofs: torch.Tensor | None  # [G, 3] see _dofs


@dataclasses.dataclass(frozen=True)
class _LevelJoints:
  """The joints of one slot and type whose bodies are at one level."""
  jtype: int
  bids: torch.Tensor      # [G]
  vadr: torch.Tensor      # [G] first dof
  rdofs: torch.Tensor     # [G, k] see _dofs
  tdofs: torch.Tensor | None  # [G, 3] see _dofs


def _dofs(jtype: int, vadr: np.ndarray):
  """A joint group's dofs: the rotational ones [G, k] (hinge and slide: its
  one dof; ball: its 3; free: its last 3) and a free joint's translational
  ones [G, 3] (None for the other types)."""
  three = np.arange(3)
  if jtype == JointType.FREE:
    return vadr[:, None] + 3 + three, vadr[:, None] + three
  if jtype == JointType.BALL:
    return vadr[:, None] + three, None
  return vadr[:, None], None


@dataclasses.dataclass(frozen=True)
class _Level:
  """Bodies at one tree depth, their parents and their own joint groups."""
  ids: torch.Tensor
  parents: torch.Tensor
  keep_ids: torch.Tensor      # bodies whose parent is not the world
  keep_parents: torch.Tensor
  joints: tuple               # _LevelJoints in slot order
  free_bids: torch.Tensor     # free-joint bodies at this level
  free_rows: torch.Tensor     # their rows in the tree's free-joint list


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
        qadr, vadr = h.jnt_qposadr[j], h.jnt_dofadr[j]
        rdofs, tdofs = _dofs(jt, vadr)
        slot_groups.append((int(jt), b, vadr))
        self.groups.append(_JointGroup(
            jtype=int(jt), bids=t(b), jids=t(j), vadr=t(vadr),
            qadr=t(qadr), jpos=m.tensor(h.jnt_pos[j]),
            jaxis=m.tensor(h.jnt_axis[j]), qpos0=m.tensor(h.qpos0[qadr]),
            qidx=(t(qadr[:, None] + np.arange(4)) if jt == JointType.BALL
                  else None),
            rdofs=t(rdofs), tdofs=None if tdofs is None else t(tdofs)))
    free = np.where(h.jnt_type == JointType.FREE)[0]
    self.free_jids = t(free)
    self.free_bids = t(h.jnt_bodyid[free])
    fq = h.jnt_qposadr[free]
    self.free_pos_idx = t(fq[:, None] + np.arange(3))
    self.free_quat_idx = t(fq[:, None] + 3 + np.arange(4))
    self.free_axis = m.tensor(h.jnt_axis[free])
    self.mocap_bids = t(np.where(h.body_mocapid >= 0)[0])
    self.mocap_ids = t(h.body_mocapid[h.body_mocapid >= 0])
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
        if not sel.any():
          continue
        rdofs, tdofs = _dofs(jt, vadr[sel])
        joints.append(_LevelJoints(jt, t(b[sel]), t(vadr[sel]), t(rdofs),
                                   None if tdofs is None else t(tdofs)))
      at_level = np.isin(h.jnt_bodyid[free], ids)
      self.levels.append(_Level(
          t(ids), t(parents), t(ids[keep]), t(parents[keep]), tuple(joints),
          t(h.jnt_bodyid[free][at_level]), t(np.where(at_level)[0])))
    self.jnt_parentbid = t(h.body_parentid[h.jnt_bodyid])
    self.moving_bodies = t(np.arange(1, nb))
    by_type = lambda jt: [g for g in self.groups if g.jtype == jt]
    self.hinge = by_type(JointType.HINGE)
    self.slide = by_type(JointType.SLIDE)
    self.ball = by_type(JointType.BALL)
    self.free = by_type(JointType.FREE)
    self.ancestor_mask = m.tensor(_ancestor_mask(h))
    self.body_dof_mask = m.tensor(_build_body_dof_mask(h))
    # [nbody, nv]: 1 where the dof is the body's own
    own = np.zeros((h.nbody, h.nv))
    own[np.asarray(h.dof_bodyid), np.arange(h.nv)] = 1.0
    self.body_own_dofs = m.tensor(own)


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


def kinematics(m: DeviceModel, qpos: torch.Tensor, full_data: bool = True,
               overlay: dict | None = None,
               mocap_pos: torch.Tensor | None = None,
               mocap_quat: torch.Tensor | None = None):
  """Body, joint, site and geom world poses for qpos [B, nq].

  ``full_data=False`` leaves out ``xmat`` and ``site_xmat``, which nothing
  in a physics step reads (the frame-skip loop asks for them on its last
  substep only). ``overlay["body_pos"]`` [B, nbody, 3] replaces the local
  body offsets per env. Mocap bodies take ``mocap_pos`` [B, nmocap, 3] and
  ``mocap_quat`` [B, nmocap, 4] as their local pose (required when the
  model has mocap bodies).
  """
  B = qpos.shape[0]
  dtype = qpos.dtype
  spec = tree_spec(m)
  nb = m.nbody
  if overlay and "body_pos" in overlay:
    t_loc = overlay["body_pos"].clone()
  else:
    t_loc = m.body_pos.expand(B, nb, 3).clone()
  q_loc = m.body_quat.expand(B, nb, 4).clone()
  if spec.mocap_bids.numel():
    if mocap_pos is None or mocap_quat is None:
      raise ValueError("the model has mocap bodies: pass mocap_pos and "
                       "mocap_quat")
    t_loc[:, spec.mocap_bids] = mocap_pos[:, spec.mocap_ids]
    q_loc[:, spec.mocap_bids] = mocap_quat[:, spec.mocap_ids]
  anchor_rel = qpos.new_zeros((B, max(m.njnt, 1), 3))
  axis_rel = qpos.new_zeros((B, max(m.njnt, 1), 3))

  # fold each body's joints into its local transform, one slot at a time;
  # a free joint's absolute pose is applied in the level pass
  for g in spec.groups:
    if g.jtype == JointType.FREE:
      continue
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
    elif g.jtype == JointType.SLIDE:
      disp = qpos[:, g.qadr] - g.qpos0
      tn = t + axr * disp[..., None]
      qn = q
    else:  # BALL
      qn = qmath.quat_mul(q, qmath.normalize(qpos[:, g.qidx]))
      tn = anch - qmath.quat_rotate(qn, g.jpos)
    t_loc[:, g.bids] = tn
    q_loc[:, g.bids] = qn

  if spec.free_jids.numel():
    fpos = qpos[:, spec.free_pos_idx]
    fquat = qmath.normalize(qpos[:, spec.free_quat_idx])

  # level-wise composition down the tree
  xpos = qpos.new_zeros((B, nb, 3))
  xquat = qmath.quat_identity((B, nb), dtype=dtype, device=qpos.device)
  for lv in spec.levels:
    xqp = xquat[:, lv.parents]
    xpos[:, lv.ids] = xpos[:, lv.parents] + qmath.quat_rotate(
        xqp, t_loc[:, lv.ids])
    xquat[:, lv.ids] = qmath.quat_mul(xqp, q_loc[:, lv.ids])
    if lv.free_bids.numel():
      xpos[:, lv.free_bids] = fpos[:, lv.free_rows]
      xquat[:, lv.free_bids] = fquat[:, lv.free_rows]
  xquat = qmath.normalize(xquat)

  if m.njnt:
    pb = spec.jnt_parentbid
    xanchor = xpos[:, pb] + qmath.quat_rotate(xquat[:, pb],
                                              anchor_rel[:, :m.njnt])
    xaxis = qmath.quat_rotate(xquat[:, pb], axis_rel[:, :m.njnt])
    if spec.free_jids.numel():
      xanchor[:, spec.free_jids] = xpos[:, spec.free_bids]
      xaxis[:, spec.free_jids] = spec.free_axis
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


def com_pos(m: DeviceModel, kin: dict, overlay: dict | None = None):
  """subtree_com [B, nbody, 3], cinert [B, nbody, 10], cdof [B, nv, 6].

  ``overlay["body_mass"]`` [B, nbody] replaces the masses per env; the
  inertia tensors stay nominal, as in the reference.
  """
  xipos, ximat = kin["xipos"], kin["ximat"]
  B = xipos.shape[0]
  spec = tree_spec(m)
  mass = (overlay["body_mass"] if overlay and "body_mass" in overlay
          else m.body_mass)
  wsum = mass[..., None] * xipos
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
  # ball and a free joint's rotations: the body's own axes (the columns of
  # its xmat, made here from xquat so that full_data=False needs no xmat)
  # about the anchor; a free joint's translations are the world axes
  for g in spec.ball + spec.free:
    w = qmath.quat_to_mat(kin["xquat"][:, g.bids]).transpose(-1, -2)
    rows = torch.cat([w, _cross(xanchor[:, g.jids, None, :], w)], dim=-1)
    cdof[:, g.rdofs.reshape(-1)] = rows.reshape(B, -1, 6)
    if g.tdofs is not None:
      eye = torch.eye(3, dtype=w.dtype, device=w.device)
      tr = torch.cat([torch.zeros_like(eye), eye], dim=-1)
      cdof[:, g.tdofs.reshape(-1)] = tr.repeat(g.tdofs.shape[0], 1)
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
    for j in lv.joints:
      if j.jtype in (JointType.HINGE, JointType.SLIDE):
        # the axis is fixed under its own motion: against the velocity
        # before the joint
        cdof_dot[:, j.vadr] = motion_cross(cvel[:, j.bids], cdof[:, j.vadr])
        cvel.index_add_(1, j.bids, contrib[:, j.vadr])
        continue
      # ball and free: the rotation axes move with the body, so against
      # the velocity after the joint (a free joint's translations: zero)
      vnew = cvel[:, j.bids]
      if j.tdofs is not None:
        vnew = vnew + contrib[:, j.tdofs].sum(2)
      vnew = vnew + contrib[:, j.rdofs].sum(2)
      cdof_dot[:, j.rdofs.reshape(-1)] = motion_cross(
          vnew[:, :, None, :], cdof[:, j.rdofs]).reshape(B, -1, 6)
      cvel[:, j.bids] = vnew
  return cvel, cdof_dot


def _gravity(m: DeviceModel) -> torch.Tensor:
  g = m.tensor(m.opt.gravity)
  return torch.zeros_like(g) if m.opt.disableflags & DSBL_GRAVITY else g


def rne(m: DeviceModel, cinert, cdof, cdof_dot, cvel, qvel) -> torch.Tensor:
  """Bias force C(q, qvel) [B, nv] by recursive Newton-Euler (qacc = 0)."""
  B = qvel.shape[0]
  spec = tree_spec(m)
  gravity = m.spec("gravity", _gravity)
  # each body's dof terms summed by a product with the map of dofs to
  # bodies, in one fixed order, so a step repeats bit for bit: on the card
  # an index_add_ over more than 16 indices adds by atomics, in any order,
  # and three or more terms of one body (a free joint's six) then differ
  dotsum = torch.matmul(spec.body_own_dofs, cdof_dot * qvel[..., None])

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


def point_jacobian(m: DeviceModel, cdof: torch.Tensor, point: torch.Tensor,
                   bodyid: int) -> tuple[torch.Tensor, torch.Tensor]:
  """(jacp, jacr) [B, 3, nv]: the translational and rotational Jacobians
  of world points ``point`` [B, 3] fixed to body ``bodyid``, from cdof
  [B, nv, 6]: the dofs on the body's ancestor chain, v = lin + ang x p."""
  mask = body_dof_mask(m)[int(bodyid)][:, None]                # [nv, 1]
  ang = cdof[..., :3] * mask                                   # [B, nv, 3]
  lin0 = cdof[..., 3:] * mask
  jacp = (lin0 + _cross(ang, point[:, None, :])).transpose(-1, -2)
  return jacp, ang.transpose(-1, -2)
