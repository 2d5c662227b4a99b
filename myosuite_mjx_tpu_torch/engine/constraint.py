"""Constraint rows (the efc system) for the Newton solver.

Counterpart of ``myosuite_mjx_tpu/engine/constraint.py``: joint limits,
tendon limits and contacts as dense blocks J [B, R, nv] with reference
acceleration ``aref`` and inverse regularizer ``D`` from MuJoCo's
solref/solimp impedance. Every limit row exists for every env and is masked
by activity, so all envs share one shape. Equality rows are not ported
(``DeviceModel`` rejects models with equality constraints).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import (
    DSBL_CONSTRAINT, DSBL_CONTACT, DSBL_LIMIT, DeviceModel, JointType)

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
  jl = [j for j in range(h.njnt) if bool(h.jnt_limited[j])]
  for j in jl:
    if int(h.jnt_type[j]) not in (JointType.HINGE, JointType.SLIDE):
      raise NotImplementedError("ball joint limits")
  jl = np.asarray(jl, np.int64)
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


def make_efc(m: DeviceModel, d: Data, contact_blocks: dict | None):
  """Assemble the dense constraint system.

  Returns (J, aref, D, is_eq, pos, meta) or None when no rows can exist.
  Row order: joint limits, tendon limits, contacts. meta holds the joint
  limit block: {"jl_offset", "jl_dadr", "jl_sign" [B, LJ]}.
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
  is_eq = torch.zeros(J.shape[1], dtype=torch.bool, device=J.device)

  k, b, imp = kbi(m, solref, solimp, pos)
  vel = (J @ d.qvel[..., None])[..., 0]
  aref = -b * vel - k * imp * pos
  r = torch.clamp(invweight * (1.0 - imp) / torch.clamp(imp, min=_MINVAL),
                  min=_MINVAL)
  D = torch.where(is_eq | (pos < 0), 1.0 / r, torch.zeros_like(r))
  return J, aref, D, is_eq, pos, meta
