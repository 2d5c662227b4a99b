"""Tendon kinematics: lengths and moment arms with sphere and cylinder wraps.

Counterpart of ``myosuite_mjx_tpu/engine/tendon.py`` on batch-first
tensors. Wrap decisions are computed for both branches and selected with
``torch.where``, so every env runs the same ops. Moment arms come from the
straight segments alone, with wrap tangent points attached to the wrap
geom's body. The static layout (``_TendonSpec``: straight segments and wrap
elements grouped by geom type, inside flag and side site) is built once per
``DeviceModel``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.engine.model import DeviceModel, GeomType, WrapType

_EPS = 1e-12


def _norm(v: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(v, dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return (a * b).sum(-1)


# ---------------------------------------------------------------------------
# 2D circle wrap (shared by sphere and cylinder wraps)
# ---------------------------------------------------------------------------


def _perp(p: torch.Tensor) -> torch.Tensor:
  return torch.stack([-p[..., 1], p[..., 0]], dim=-1)


def _tangent_point(p, r, sign):
  """Tangent point on the circle of radius r seen from outside point p."""
  d2 = torch.clamp(_dot(p, p), min=_EPS)
  l = torch.sqrt(torch.clamp(d2 - r * r, min=_EPS))
  return (r / d2)[..., None] * (r[..., None] * p
                                + sign[..., None] * l[..., None] * _perp(p))


def _arc_angle(t0, t1, sign):
  """Angle from t0 to t1, counter-clockwise if sign = +1."""
  a0 = torch.atan2(t0[..., 1], t0[..., 0])
  a1 = torch.atan2(t1[..., 1], t1[..., 0])
  return torch.remainder((a1 - a0) * sign, 2.0 * np.pi)


def _candidate(p0, p1, r, sign):
  t0 = _tangent_point(p0, r, sign)
  t1 = _tangent_point(p1, r, -sign)
  return t0, t1, _arc_angle(t0, t1, sign)


def _closest_to_center(p0, p1):
  seg = p1 - p0
  a = torch.clamp(_dot(seg, seg), min=_EPS)
  t = torch.clamp(-_dot(p0, seg) / a, 0.0, 1.0)
  return p0 + t[..., None] * seg


def wrap_circle(p0, p1, sd, r):
  """2D circle wrap; returns (wrapped, t0, t1, arclen).

  Both directions are evaluated and the shorter path wins, or with a side
  site ``sd`` the side the site lies on.
  """
  closest = _closest_to_center(p0, p1)
  dmin = _norm(closest)
  endpoints_outside = (_norm(p0) > r) & (_norm(p1) > r)
  intersects = dmin < r
  if sd is None:
    must_wrap = intersects
  else:
    must_wrap = intersects | (_dot(closest, sd) < 0)
  wrapped = endpoints_outside & must_wrap

  one = torch.ones_like(r)
  t0p, t1p, angp = _candidate(p0, p1, r, one)
  t0m, t1m, angm = _candidate(p0, p1, r, -one)
  if sd is None:
    lenp = _norm(p0 - t0p) + r * angp + _norm(p1 - t1p)
    lenm = _norm(p0 - t0m) + r * angm + _norm(p1 - t1m)
    pick_p = lenp <= lenm
  else:
    def midpt(t0, ang, sign):
      a0 = torch.atan2(t0[..., 1], t0[..., 0]) + sign * 0.5 * ang
      return torch.stack([torch.cos(a0), torch.sin(a0)], dim=-1)
    mp = midpt(t0p, angp, 1.0)
    mm = midpt(t0m, angm, -1.0)
    sdn = sd / torch.clamp(_norm(sd)[..., None], min=_EPS)
    pick_p = _dot(mp, sdn) >= _dot(mm, sdn)

  t0 = torch.where(pick_p[..., None], t0p, t0m)
  t1 = torch.where(pick_p[..., None], t1p, t1m)
  arclen = r * torch.where(pick_p, angp, angm)
  return wrapped, t0, t1, arclen


def wrap_inside_circle(p0, p1, r, iters: int = 10):
  """Inside wrap (side site inside the geom): when the straight segment
  misses the circle, the path catches on the point T of the circle that
  minimises |p0 - T| + |T - p1|, found by Newton on the angle."""
  closest = _closest_to_center(p0, p1)
  dmin = _norm(closest)
  wrapped = (dmin >= r) & (_norm(p0) > r) & (_norm(p1) > r)
  theta = torch.atan2(closest[..., 1], closest[..., 0])
  one = torch.ones_like(r)
  for _ in range(iters):
    c = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    tv = r[..., None] * torch.stack([-torch.sin(theta), torch.cos(theta)], -1)
    v0 = p0 - c
    v1 = p1 - c
    n0 = torch.clamp(_norm(v0), min=_EPS)
    n1 = torch.clamp(_norm(v1), min=_EPS)
    u0 = v0 / n0[..., None]
    u1 = v1 / n1[..., None]
    grad = -_dot(tv, u0 + u1)

    def curv(u, n):
      tu = _dot(tv, u)
      return (_dot(tv, tv) - tu * tu) / n

    hess = _dot(c, u0 + u1) + curv(u0, n0) + curv(u1, n1)
    theta = theta - grad / torch.clamp(hess.abs(), min=_EPS) * torch.sign(
        torch.where(hess == 0, one, hess))
  T = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
  return wrapped, T, T, torch.zeros_like(r)


# ---------------------------------------------------------------------------
# 3D wrap over sphere / cylinder geoms
# ---------------------------------------------------------------------------


def _mat_t_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return (mat * v[..., :, None]).sum(-2)


def _mat_vec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  return (mat * v[..., None, :]).sum(-1)


def wrap_geom(x0, x1, gpos, gmat, radius, geom_type: int, side,
              inside: bool = False):
  """Wrap the straight paths x0 -> x1 [..., 3] over spheres or cylinders.

  Returns (wrapped, w0, w1, arclen); unwrapped paths get w0 = w1 = the
  segment midpoint and arclen = 0.
  """
  p0 = _mat_t_vec(gmat, x0 - gpos)
  p1 = _mat_t_vec(gmat, x1 - gpos)
  ps = _mat_t_vec(gmat, side - gpos) if side is not None else None

  if geom_type == GeomType.SPHERE:
    e0 = p0 / torch.clamp(_norm(p0)[..., None], min=_EPS)
    p1_perp = p1 - _dot(p1, e0)[..., None] * e0
    nrm = _norm(p1_perp)
    ex = p0.new_tensor([1.0, 0.0, 0.0])
    ey = p0.new_tensor([0.0, 1.0, 0.0])
    alt = torch.where((e0[..., 0].abs() < 0.9)[..., None], ex, ey)
    alt_perp = alt - _dot(alt, e0)[..., None] * e0
    e1 = torch.where(
        (nrm > 1e-9)[..., None],
        p1_perp / torch.clamp(nrm, min=_EPS)[..., None],
        alt_perp / torch.clamp(_norm(alt_perp), min=_EPS)[..., None])
    q0 = torch.stack([_dot(p0, e0), _dot(p0, e1)], dim=-1)
    q1 = torch.stack([_dot(p1, e0), _dot(p1, e1)], dim=-1)
    qs = (torch.stack([_dot(ps, e0), _dot(ps, e1)], dim=-1)
          if ps is not None else None)
    if inside:
      wrapped, t0, t1, arclen = wrap_inside_circle(q0, q1, radius)
    else:
      wrapped, t0, t1, arclen = wrap_circle(q0, q1, qs, radius)
    w0_local = t0[..., :1] * e0 + t0[..., 1:] * e1
    w1_local = t1[..., :1] * e0 + t1[..., 1:] * e1
  elif geom_type == GeomType.CYLINDER:
    q0, q1 = p0[..., :2], p1[..., :2]
    qs = ps[..., :2] if ps is not None else None
    if inside:
      wrapped, t0, t1, arc2d = wrap_inside_circle(q0, q1, radius)
    else:
      wrapped, t0, t1, arc2d = wrap_circle(q0, q1, qs, radius)
    # spread the axial travel along the 2D path length (helical wrap)
    l0 = _norm(t0 - q0)
    l1 = _norm(q1 - t1)
    total2d = torch.clamp(l0 + arc2d + l1, min=_EPS)
    dz = p1[..., 2] - p0[..., 2]
    z0 = p0[..., 2] + dz * l0 / total2d
    z1 = p0[..., 2] + dz * (l0 + arc2d) / total2d
    w0_local = torch.cat([t0, z0[..., None]], dim=-1)
    w1_local = torch.cat([t1, z1[..., None]], dim=-1)
    arclen = torch.sqrt(arc2d * arc2d + (z1 - z0) * (z1 - z0))
  else:
    raise NotImplementedError(f"wrap geom type {geom_type}")

  w0 = gpos + _mat_vec(gmat, w0_local)
  w1 = gpos + _mat_vec(gmat, w1_local)
  mid = 0.5 * (x0 + x1)
  w0 = torch.where(wrapped[..., None], w0, mid)
  w1 = torch.where(wrapped[..., None], w1, mid)
  arclen = torch.where(wrapped, arclen, torch.zeros_like(arclen))
  return wrapped, w0, w1, arclen


# ---------------------------------------------------------------------------
# static tendon layout
# ---------------------------------------------------------------------------


def _side_inside_geom(h, geomid: int, sideid: int) -> bool:
  """Side site inside the wrap geom (site and geom on one body)."""
  if sideid < 0 or int(h.site_bodyid[sideid]) != int(h.geom_bodyid[geomid]):
    return False
  w, x, y, z = np.asarray(h.geom_quat[geomid])
  rot = np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])
  rel = rot.T @ np.asarray(h.site_pos[sideid] - h.geom_pos[geomid])
  r = float(h.geom_size[geomid, 0])
  if int(h.geom_type[geomid]) == GeomType.CYLINDER:
    half = float(h.geom_size[geomid, 1])
    return bool(np.linalg.norm(rel[:2]) < r and abs(rel[2]) < half)
  return bool(np.linalg.norm(rel) < r)


def _compile_spatial(h, t: int) -> list:
  """A spatial tendon's path as ('straight', s0, s1, div) and
  ('wrap', s0, geom, side, s1, div, inside) elements."""
  adr, num = int(h.tendon_adr[t]), int(h.tendon_num[t])
  elems = []
  divisor = 1.0
  prev_site = None
  i, end = adr, adr + num
  while i < end:
    wt = int(h.wrap_type[i])
    if wt == WrapType.PULLEY:
      divisor = float(h.wrap_prm[i])
      prev_site = None
      i += 1
    elif wt == WrapType.SITE:
      sid = int(h.wrap_objid[i])
      if prev_site is not None:
        elems.append(("straight", prev_site, sid, divisor))
      prev_site = sid
      i += 1
    elif wt in (WrapType.SPHERE, WrapType.CYLINDER):
      if (prev_site is None or i + 1 >= end
          or int(h.wrap_type[i + 1]) != WrapType.SITE):
        raise ValueError(f"tendon {t}: a wrap geom needs a site on each side")
      nxt = int(h.wrap_objid[i + 1])
      sideid = int(round(float(h.wrap_prm[i])))
      gid = int(h.wrap_objid[i])
      elems.append(("wrap", prev_site, gid, sideid, nxt, divisor,
                    _side_inside_geom(h, gid, sideid)))
      prev_site = nxt
      i += 2
    else:
      raise NotImplementedError(f"wrap type {wt} in spatial tendon")
  return elems


@dataclasses.dataclass(frozen=True)
class _WrapGroup:
  geom_type: int
  inside: bool
  has_side: bool
  site0: torch.Tensor
  geom: torch.Tensor
  side: torch.Tensor
  site1: torch.Tensor
  radius: torch.Tensor
  arc_sel: torch.Tensor   # [ntendon, G]: 1/div at (tendon, element)


class _TendonSpec:
  """Index tensors for all straight segments and wrap groups, and the
  segment -> tendon selection matrices (1/div folded in)."""

  def __init__(self, m: DeviceModel):
    h = m.host
    t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
    s0, s1, sdiv, stidx = [], [], [], []
    groups: dict[tuple, dict[str, list]] = {}
    for ti in range(h.ntendon):
      if int(h.wrap_type[int(h.tendon_adr[ti])]) == WrapType.JOINT:
        continue
      for e in _compile_spatial(h, ti):
        if e[0] == "straight":
          s0.append(e[1])
          s1.append(e[2])
          sdiv.append(e[3])
          stidx.append(ti)
        else:
          _, site0, gid, sideid, site1, div, inside = e
          key = (int(h.geom_type[gid]), inside, sideid >= 0)
          g = groups.setdefault(key, dict(site0=[], geom=[], side=[],
                                          site1=[], div=[], tidx=[]))
          g["site0"].append(site0)
          g["geom"].append(gid)
          g["side"].append(max(sideid, 0))
          g["site1"].append(site1)
          g["div"].append(div)
          g["tidx"].append(ti)

    # segment order: straight segments, then per wrap group the
    # (site0 -> w0) and (w1 -> site1) legs
    divs, tidxs = [sdiv], [stidx]
    self.wrap_groups: list[_WrapGroup] = []
    for (gt, inside, has_side), g in sorted(groups.items()):
      arc_sel = np.zeros((h.ntendon, len(g["tidx"])))
      arc_sel[g["tidx"], np.arange(len(g["tidx"]))] = 1.0 / np.asarray(
          g["div"])
      self.wrap_groups.append(_WrapGroup(
          geom_type=gt, inside=inside, has_side=has_side,
          site0=t(g["site0"]), geom=t(g["geom"]), side=t(g["side"]),
          site1=t(g["site1"]), radius=m.tensor(h.geom_size[g["geom"], 0]),
          arc_sel=m.tensor(arc_sel)))
      divs.append(g["div"] + g["div"])
      tidxs.append(g["tidx"] + g["tidx"])
    self.straight_s0 = t(s0)
    self.straight_s1 = t(s1)

    # bodies of segment ends: sites for straight legs, the wrap geom's
    # body for the tangent-point ends of wrap legs
    b_start = [h.site_bodyid[s0]]
    b_end = [h.site_bodyid[s1]]
    for (gt, inside, has_side), g in sorted(groups.items()):
      gb = h.geom_bodyid[g["geom"]]
      b_start += [h.site_bodyid[g["site0"]], gb]
      b_end += [gb, h.site_bodyid[g["site1"]]]
    bs = np.concatenate(b_start).astype(np.int64)
    be = np.concatenate(b_end).astype(np.int64)
    div_np = np.concatenate([np.asarray(v, np.float64) for v in divs])
    tidx = np.concatenate([np.asarray(v, np.int64) for v in tidxs])
    S = len(tidx)
    self.nseg = S
    sel = np.zeros((h.ntendon, S))
    sel[tidx, np.arange(S)] = 1.0 / div_np
    self.sel = m.tensor(sel)
    self.sel2 = m.tensor(np.concatenate([sel, -sel], axis=1))
    self.jac_bodies = t(np.concatenate([be, bs]))

    # fixed (joint-coefficient) tendons: length = coef @ qpos, rows = coef_v
    coef_q = np.zeros((h.ntendon, h.nq))
    coef_v = np.zeros((h.ntendon, h.nv))
    self.has_fixed = False
    for ti in range(h.ntendon):
      adr, num = int(h.tendon_adr[ti]), int(h.tendon_num[ti])
      if int(h.wrap_type[adr]) != WrapType.JOINT:
        continue
      self.has_fixed = True
      for i in range(adr, adr + num):
        j = int(h.wrap_objid[i])
        coef_q[ti, int(h.jnt_qposadr[j])] += float(h.wrap_prm[i])
        coef_v[ti, int(h.jnt_dofadr[j])] += float(h.wrap_prm[i])
    self.coef_q = m.tensor(coef_q)
    self.coef_v = m.tensor(coef_v)


def tendon_spec(m: DeviceModel) -> _TendonSpec:
  return m.spec("tendon", _TendonSpec)


def tendon(m: DeviceModel, kin: dict, cdof: torch.Tensor):
  """ten_length [B, ntendon] and ten_J [B, ntendon, nv]."""
  B = cdof.shape[0]
  if m.ntendon == 0:
    return cdof.new_zeros((B, 0)), cdof.new_zeros((B, 0, m.nv))
  site_xpos = kin["site_xpos"]
  geom_xpos = kin["geom_xpos"]
  geom_xmat = kin["geom_xmat"]
  spec = tendon_spec(m)

  ten_length = cdof.new_zeros((B, m.ntendon))
  p_start = [site_xpos[:, spec.straight_s0]]
  p_end = [site_xpos[:, spec.straight_s1]]
  for g in spec.wrap_groups:
    x0 = site_xpos[:, g.site0]
    x1 = site_xpos[:, g.site1]
    side = site_xpos[:, g.side] if g.has_side else None
    _, w0, w1, arclen = wrap_geom(
        x0, x1, geom_xpos[:, g.geom], geom_xmat[:, g.geom], g.radius,
        g.geom_type, side, inside=g.inside)
    ten_length = ten_length + arclen @ g.arc_sel.T
    p_start += [x0, w1]
    p_end += [w0, x1]

  if spec.nseg:
    ps = torch.cat(p_start, dim=1)
    pe = torch.cat(p_end, dim=1)
    d = pe - ps
    ln = _norm(d)
    u = d / torch.clamp(ln, min=_EPS)[..., None]
    ten_length = ten_length + ln @ spec.sel.T
    rows = smooth.point_jac_dir(m, cdof, torch.cat([pe, ps], dim=1),
                                spec.jac_bodies, torch.cat([u, u], dim=1))
    ten_J = spec.sel2 @ rows
  else:
    ten_J = cdof.new_zeros((B, m.ntendon, m.nv))
  if spec.has_fixed:
    ten_J = ten_J + spec.coef_v
  return ten_length, ten_J


def fixed_tendon_length(m: DeviceModel, qpos: torch.Tensor) -> torch.Tensor:
  """Length of fixed (joint-coefficient) tendons; zero for spatial ones."""
  return qpos @ tendon_spec(m).coef_q.T
