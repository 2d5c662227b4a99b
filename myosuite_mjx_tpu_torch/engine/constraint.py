"""Constraint rows (the efc system) for the Newton solver.

Counterpart of ``myosuite_mjx_tpu/engine/constraint.py``: joint and
tendon equalities, joint limits, tendon limits and contacts as dense blocks
J [B, R, nv] with reference acceleration ``aref`` and inverse regularizer
``D`` from MuJoCo's solref/solimp impedance. Every limit row exists for
every env and is masked by activity, so all envs share one shape; an
equality row is always active (``is_eq``: D = 1/r whatever its sign).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import (
    DSBL_CONSTRAINT, DSBL_CONTACT, DSBL_EQUALITY, DSBL_LIMIT, DeviceModel,
    EqType)
from myosuite_mjx_tpu_torch.ops.consts import const

_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999


def kbi(m: DeviceModel, solref, solimp, pos):
  """Stiffness k, damping b and impedance imp from solref/solimp and the
  violation ``pos`` (standard and direct solref; timeconst >= 2 dt)."""
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  dmin = torch.clamp(solimp[..., 0], _MINIMP, _MAXIMP)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  width = torch.clamp(solimp[..., 2], min=_MINVAL)
  mid = torch.clamp(solimp[..., 3], _MINIMP, _MAXIMP)
  power = torch.clamp(solimp[..., 4], min=1.0)

  tc = torch.clamp(timeconst, min=2.0 * m.opt.timestep)
  k_std = 1.0 / torch.clamp(dmax * dmax * tc * tc * dampratio * dampratio,
                            min=_MINVAL)
  b_std = 2.0 / torch.clamp(dmax * tc, min=_MINVAL)
  direct = (solref[..., 0] <= 0) | (solref[..., 1] <= 0)
  k = torch.where(direct, -solref[..., 0] / torch.clamp(dmax * dmax,
                                                        min=_MINVAL), k_std)
  b = torch.where(direct, -solref[..., 1] / torch.clamp(dmax, min=_MINVAL),
                  b_std)

  x = pos.abs() / width
  ya = torch.pow(x / torch.clamp(mid, min=_MINVAL), power) * mid
  yb = 1.0 - torch.pow((1.0 - x) / torch.clamp(1.0 - mid, min=_MINVAL),
                       power) * (1.0 - mid)
  y = torch.where(x < mid, ya, yb)
  imp = dmin + y * (dmax - dmin)
  imp = torch.minimum(torch.maximum(imp, dmin), dmax)
  imp = torch.where(x > 1.0, dmax, imp)
  return k, b, imp


@dataclasses.dataclass(frozen=True)
class _LimitSpec:
  """Static layout of limit rows."""
  jl_qadr: torch.Tensor     # [LJ] qpos address of limited joints
  jl_dadr: torch.Tensor     # [LJ]
  jl_rows: torch.Tensor     # [LJ] arange, for the J scatter
  jl_lo: torch.Tensor
  jl_hi: torch.Tensor
  jl_margin: torch.Tensor
  jl_invw: torch.Tensor
  jl_solref: torch.Tensor   # [LJ, 2]
  jl_solimp: torch.Tensor   # [LJ, 5]
  tl_idx: torch.Tensor      # [LT] limited tendon ids


def _build_limit_spec(m: DeviceModel) -> _LimitSpec:
  h = m.host
  # hinge and slide only: DeviceModel refuses limits on ball joints
  jl = np.asarray([j for j in range(h.njnt) if bool(h.jnt_limited[j])],
                  np.int64)
  t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
  dadr = h.jnt_dofadr[jl]
  return _LimitSpec(
      jl_qadr=t(h.jnt_qposadr[jl]), jl_dadr=t(dadr), jl_rows=t(
          np.arange(len(jl))),
      jl_lo=m.tensor(h.jnt_range[jl, 0]), jl_hi=m.tensor(h.jnt_range[jl, 1]),
      jl_margin=m.tensor(h.jnt_margin[jl]),
      jl_invw=m.tensor(h.dof_invweight0[dadr]),
      jl_solref=m.tensor(h.jnt_solref[jl].reshape(-1, 2)),
      jl_solimp=m.tensor(h.jnt_solimp[jl].reshape(-1, 5)),
      tl_idx=t([i for i in range(h.ntendon) if bool(h.tendon_limited[i])]))


def limit_spec(m: DeviceModel) -> _LimitSpec:
  return m.spec("limit", _build_limit_spec)


@dataclasses.dataclass(frozen=True)
class _EqBlock:
  """The active equalities of one type (joint or tendon): their object
  ids, the polynomial's coefficients, the reference values and the rows
  they take in model order."""
  obj1: torch.Tensor     # [E'] qpos address (joint) or tendon id
  obj2: torch.Tensor     # [E'] the same for obj2; obj1's for a one-sided row
  dof1: torch.Tensor     # [E'] dof address (joint rows)
  dof2: torch.Tensor
  ref1: torch.Tensor     # [E'] qpos0 or tendon_length0 of obj1
  ref2: torch.Tensor
  coef: torch.Tensor     # [E', 5]; c1..c4 zero on a one-sided row
  rows: torch.Tensor     # [E'] row index among the E equality rows


@dataclasses.dataclass(frozen=True)
class _EqSpec:
  joint: _EqBlock | None
  tendon: _EqBlock | None
  order: torch.Tensor | None  # [E] joint rows then tendon rows -> model order
  invw: torch.Tensor          # [E] in model order
  solref: torch.Tensor        # [E, 2]
  solimp: torch.Tensor        # [E, 5]
  n: int


def _build_eq_spec(m: DeviceModel) -> _EqSpec | None:
  h = m.host
  active = [e for e in range(h.neq) if bool(h.eq_active0[e])]
  if not active:
    return None
  t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
  blocks, invw = {}, []
  for kind in (EqType.JOINT, EqType.TENDON):
    rows = [r for r, e in enumerate(active) if int(h.eq_type[e]) == kind]
    if not rows:
      blocks[kind] = None
      continue
    o1, o2, d1, d2, r1, r2, coef = [], [], [], [], [], [], []
    for r in rows:
      e = active[r]
      i1, i2 = int(h.eq_obj1id[e]), int(h.eq_obj2id[e])
      c = np.array(h.eq_data[e][:5], np.float64)
      if i2 < 0:   # one-sided: obj1 against the constant c0
        i2 = i1
        c[1:] = 0.0
      if kind == EqType.JOINT:
        o1.append(int(h.jnt_qposadr[i1]))
        o2.append(int(h.jnt_qposadr[i2]))
        d1.append(int(h.jnt_dofadr[i1]))
        d2.append(int(h.jnt_dofadr[i2]))
        r1.append(h.qpos0[o1[-1]])
        r2.append(h.qpos0[o2[-1]])
        iw = h.dof_invweight0[d1[-1]]
        if int(h.eq_obj2id[e]) >= 0:
          iw = iw + h.dof_invweight0[d2[-1]]
      else:
        o1.append(i1)
        o2.append(i2)
        r1.append(h.tendon_length0[i1])
        r2.append(h.tendon_length0[i2])
        iw = h.tendon_invweight0[i1]
        if int(h.eq_obj2id[e]) >= 0:
          iw = iw + h.tendon_invweight0[i2]
      invw.append((r, float(iw)))
      coef.append(c)
    blocks[kind] = _EqBlock(
        obj1=t(o1), obj2=t(o2), dof1=t(d1), dof2=t(d2), ref1=m.tensor(r1),
        ref2=m.tensor(r2), coef=m.tensor(np.asarray(coef)), rows=t(rows))
  stacked = [b.rows for b in blocks.values() if b is not None]
  order = None
  if len(stacked) > 1:
    order = torch.argsort(torch.cat(stacked))
  return _EqSpec(
      joint=blocks[EqType.JOINT], tendon=blocks[EqType.TENDON], order=order,
      invw=m.tensor([w for _, w in sorted(invw)]),
      solref=m.tensor(h.eq_solref[active]),
      solimp=m.tensor(h.eq_solimp[active]), n=len(active))


def eq_spec(m: DeviceModel) -> _EqSpec | None:
  return m.spec("equality", _build_eq_spec)


def _poly(coef, dif):
  """The coupling polynomial and its derivative at ``dif`` [B, E']."""
  c0, c1, c2, c3, c4 = coef.unbind(-1)
  poly = c0 + c1 * dif + c2 * dif**2 + c3 * dif**3 + c4 * dif**4
  dpoly = c1 + 2 * c2 * dif + 3 * c3 * dif**2 + 4 * c4 * dif**3
  return poly, dpoly


def equality_rows(m: DeviceModel, d: Data, spec: _EqSpec):
  """Joint and tendon coupling rows, J [B, E, nv] and pos [B, E], in
  model order: obj1 - ref1 = poly(obj2 - ref2) for a joint (qpos) or a
  tendon (length against ``tendon_length0``); a one-sided row holds obj1
  at ref1 + c0."""
  B = d.qpos.shape[0]
  Js, poss = [], []
  if spec.joint is not None:
    b = spec.joint
    poly, dpoly = _poly(b.coef, d.qpos[:, b.obj2] - b.ref2)
    poss.append(d.qpos[:, b.obj1] - b.ref1 - poly)
    rows = torch.arange(b.obj1.numel(), device=d.qpos.device)
    J = d.qpos.new_zeros((B, rows.numel(), m.nv))
    J[:, rows, b.dof1] = const(1.0, J)
    J = J.index_put((torch.arange(B, device=J.device)[:, None], rows,
                     b.dof2), -dpoly, accumulate=True)
    Js.append(J)
  if spec.tendon is not None:
    b = spec.tendon
    poly, dpoly = _poly(b.coef, d.ten_length[:, b.obj2] - b.ref2)
    poss.append(d.ten_length[:, b.obj1] - b.ref1 - poly)
    Js.append(d.ten_J[:, b.obj1] - dpoly[..., None] * d.ten_J[:, b.obj2])
  J, pos = torch.cat(Js, dim=1), torch.cat(poss, dim=1)
  if spec.order is not None:
    J, pos = J[:, spec.order], pos[:, spec.order]
  return J, pos


def make_efc(m: DeviceModel, d: Data, contact_blocks: dict | None):
  """Assemble the dense constraint system.

  Returns (J, aref, D, is_eq, pos, meta) or None when no rows can exist.
  Row order: equalities, joint limits, tendon limits, contacts. meta holds
  the joint limit block: {"jl_offset", "jl_dadr", "jl_sign" [B, LJ]}.
  """
  dsbl = m.opt.disableflags
  if dsbl & DSBL_CONSTRAINT:
    return None
  B = d.qpos.shape[0]
  spec = limit_spec(m)
  LJ = spec.jl_qadr.numel()
  meta = {"jl_offset": 0, "jl_dadr": spec.jl_dadr,
          "jl_sign": d.qpos.new_zeros((B, LJ))}
  Js, poss, invws, srs, sis = [], [], [], [], []

  eq = eq_spec(m)
  n_eq = 0
  if eq is not None and not (dsbl & DSBL_EQUALITY):
    J, pos = equality_rows(m, d, eq)
    Js.append(J)
    poss.append(pos)
    invws.append(eq.invw.expand(B, eq.n))
    srs.append(eq.solref.expand(B, eq.n, 2))
    sis.append(eq.solimp.expand(B, eq.n, 5))
    n_eq = eq.n
    meta["jl_offset"] = n_eq

  if not (dsbl & DSBL_LIMIT):
    if LJ:
      q = d.qpos[:, spec.jl_qadr]
      dist_lo = q - spec.jl_lo
      dist_hi = spec.jl_hi - q
      one = torch.ones_like(q)
      sign = torch.where(dist_lo < dist_hi, one, -one)
      meta["jl_sign"] = sign
      J = d.qpos.new_zeros((B, LJ, m.nv))
      J[:, spec.jl_rows, spec.jl_dadr] = sign
      Js.append(J)
      poss.append(torch.minimum(dist_lo, dist_hi) - spec.jl_margin)
      invws.append(spec.jl_invw.expand(B, LJ))
      srs.append(spec.jl_solref.expand(B, LJ, 2))
      sis.append(spec.jl_solimp.expand(B, LJ, 5))
    LT = spec.tl_idx.numel()
    if LT:
      tl = spec.tl_idx
      L = d.ten_length[:, tl]
      dist_lo = L - m.tendon_range[tl, 0]
      dist_hi = m.tendon_range[tl, 1] - L
      one = torch.ones_like(L)
      sign = torch.where(dist_lo < dist_hi, one, -one)
      Js.append(sign[..., None] * d.ten_J[:, tl])
      poss.append(torch.minimum(dist_lo, dist_hi) - m.tendon_margin[tl])
      invws.append(m.tendon_invweight0[tl].expand(B, LT))
      srs.append(m.tendon_solref_lim[tl].expand(B, LT, 2))
      sis.append(m.tendon_solimp_lim[tl].expand(B, LT, 5))

  if contact_blocks is not None and not (dsbl & DSBL_CONTACT):
    Js.append(contact_blocks["J"])
    poss.append(contact_blocks["pos"])
    invws.append(contact_blocks["invweight"])
    srs.append(contact_blocks["solref"])
    sis.append(contact_blocks["solimp"])

  if not Js:
    return None
  J = torch.cat(Js, dim=1)
  pos = torch.cat(poss, dim=1)
  invweight = torch.cat(invws, dim=1)
  solref = torch.cat(srs, dim=1)
  solimp = torch.cat(sis, dim=1)
  is_eq = torch.arange(J.shape[1], device=J.device) < n_eq

  k, b, imp = kbi(m, solref, solimp, pos)
  vel = (J @ d.qvel[..., None])[..., 0]
  aref = -b * vel - k * imp * pos
  r = torch.clamp(invweight * (1.0 - imp) / torch.clamp(imp, min=_MINVAL),
                  min=_MINVAL)
  D = torch.where(is_eq | (pos < 0), 1.0 / r, torch.zeros_like(r))
  return J, aref, D, is_eq, pos, meta
