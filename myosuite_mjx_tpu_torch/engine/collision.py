"""Collision detection: static pair enumeration and primitive narrowphase.

Counterpart of ``myosuite_mjx_tpu/engine/collision.py``. The candidate
pairs and their per-slot parameters are static host data (same filters and
combination rules as the reference); every candidate contributes fixed
contact slots, of which the ``max_contacts`` deepest are kept per env.

The narrowphase ported so far covers the pairs MyoHand-like scenes
instantiate: capsule-capsule and plane-capsule. Building the collision
layout of a model with any other colliding pair raises
``NotImplementedError`` naming the pair; no pair is ever skipped.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.engine.data import Contact, Data
from myosuite_mjx_tpu_torch.engine.model import DeviceModel, GeomType, Model

_MINVAL = 1e-15

# contact slots kept after the top-k cull (the reference's default)
DEFAULT_MAX_CONTACTS = int(os.environ.get("MYOSUITE_TPU_MAX_CONTACTS", 24))


# ---------------------------------------------------------------------------
# static pair enumeration (host numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CandidatePair:
  g1: int
  g2: int
  condim: int
  friction: tuple          # (5,)
  solref: tuple            # (2,)
  solreffriction: tuple    # (2,)
  solimp: tuple            # (5,)
  margin: float
  gap: float


# the reference's supported (ordered) type pairs; they decide pair order
# and which pairs are candidates at all
_SUPPORTED = {
    (GeomType.PLANE, GeomType.SPHERE), (GeomType.PLANE, GeomType.CAPSULE),
    (GeomType.PLANE, GeomType.ELLIPSOID), (GeomType.PLANE, GeomType.BOX),
    (GeomType.PLANE, GeomType.CYLINDER), (GeomType.SPHERE, GeomType.SPHERE),
    (GeomType.SPHERE, GeomType.CAPSULE), (GeomType.SPHERE, GeomType.ELLIPSOID),
    (GeomType.SPHERE, GeomType.BOX), (GeomType.CAPSULE, GeomType.CAPSULE),
    (GeomType.SPHERE, GeomType.CYLINDER), (GeomType.CAPSULE, GeomType.CYLINDER),
    (GeomType.CAPSULE, GeomType.ELLIPSOID), (GeomType.CAPSULE, GeomType.BOX),
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID),
    (GeomType.ELLIPSOID, GeomType.CYLINDER), (GeomType.ELLIPSOID, GeomType.BOX),
    (GeomType.CYLINDER, GeomType.CYLINDER), (GeomType.CYLINDER, GeomType.BOX),
    (GeomType.BOX, GeomType.BOX), (GeomType.HFIELD, GeomType.SPHERE),
    (GeomType.HFIELD, GeomType.CAPSULE), (GeomType.PLANE, GeomType.MESH),
    (GeomType.SPHERE, GeomType.MESH), (GeomType.CAPSULE, GeomType.MESH),
    (GeomType.ELLIPSOID, GeomType.MESH),
}

# type pairs whose narrowphase is ported
PORTED = {(GeomType.PLANE, GeomType.CAPSULE),
          (GeomType.CAPSULE, GeomType.CAPSULE)}


def _ordered(m: Model, g1: int, g2: int) -> tuple[int, int] | None:
  """Order a geom pair by type (plane first, etc.); None if unsupported."""
  t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
  if (t1, t2) in _SUPPORTED:
    return g1, g2
  if (t2, t1) in _SUPPORTED:
    return g2, g1
  return None


def _combine(m: Model, g1: int, g2: int) -> CandidatePair:
  p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
  if p1 != p2:
    src = g1 if p1 > p2 else g2
    condim = int(m.geom_condim[src])
    fr = m.geom_friction[src]
    solref = m.geom_solref[src]
    solimp = m.geom_solimp[src]
  else:
    condim = max(int(m.geom_condim[g1]), int(m.geom_condim[g2]))
    fr = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
    s1, s2 = float(m.geom_solmix[g1]), float(m.geom_solmix[g2])
    w1 = s1 / max(s1 + s2, _MINVAL) if (s1 + s2) > _MINVAL else 0.5
    w2 = 1.0 - w1
    if (m.geom_solref[g1] <= 0).any() or (m.geom_solref[g2] <= 0).any():
      solref = np.minimum(m.geom_solref[g1], m.geom_solref[g2])
    else:
      solref = w1 * m.geom_solref[g1] + w2 * m.geom_solref[g2]
    solimp = w1 * m.geom_solimp[g1] + w2 * m.geom_solimp[g2]
  friction5 = (float(fr[0]), float(fr[0]), float(fr[1]),
               float(fr[2]), float(fr[2]))
  return CandidatePair(
      g1=g1, g2=g2, condim=condim, friction=friction5,
      solref=tuple(float(x) for x in solref), solreffriction=(0.0, 0.0),
      solimp=tuple(float(x) for x in solimp),
      margin=float(m.geom_margin[g1]) + float(m.geom_margin[g2]),
      gap=float(m.geom_gap[g1]) + float(m.geom_gap[g2]))


def candidate_pairs(m: Model) -> list[CandidatePair]:
  """Static collision candidates after all model-level filters."""
  pairs: list[CandidatePair] = []
  for p in range(m.npair):   # explicit <pair> entries use their own params
    og = _ordered(m, int(m.pair_geom1[p]), int(m.pair_geom2[p]))
    if og is None:
      continue
    pairs.append(CandidatePair(
        g1=og[0], g2=og[1], condim=int(m.pair_dim[p]),
        friction=tuple(float(x) for x in m.pair_friction[p][:5]),
        solref=tuple(float(x) for x in m.pair_solref[p]),
        solreffriction=tuple(float(x) for x in m.pair_solreffriction[p]),
        solimp=tuple(float(x) for x in m.pair_solimp[p]),
        margin=float(m.pair_margin[p]), gap=float(m.pair_gap[p])))

  excluded = set(int(s) for s in m.exclude_signature)
  for g1 in range(m.ngeom):
    for g2 in range(g1 + 1, m.ngeom):
      b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
      w1, w2 = int(m.body_weldid[b1]), int(m.body_weldid[b2])
      if w1 == w2:
        continue
      wp1 = int(m.body_weldid[int(m.body_parentid[w1])])
      wp2 = int(m.body_weldid[int(m.body_parentid[w2])])
      if (wp1 == w2 and w2 != 0) or (wp2 == w1 and w1 != 0):
        continue
      if ((b1 << 16) + b2) in excluded or ((b2 << 16) + b1) in excluded:
        continue
      ct1, ca1 = int(m.geom_contype[g1]), int(m.geom_conaffinity[g1])
      ct2, ca2 = int(m.geom_contype[g2]), int(m.geom_conaffinity[g2])
      if not ((ct1 & ca2) or (ct2 & ca1)):
        continue
      og = _ordered(m, g1, g2)
      if og is not None:
        pairs.append(_combine(m, og[0], og[1]))
  return pairs


def _npoints(m: Model, pair: CandidatePair) -> int:
  """Static number of contact slots a pair contributes."""
  t1, t2 = int(m.geom_type[pair.g1]), int(m.geom_type[pair.g2])
  T = GeomType
  return {(T.PLANE, T.CAPSULE): 2, (T.PLANE, T.BOX): 8,
          (T.PLANE, T.CYLINDER): 4, (T.CAPSULE, T.BOX): 3,
          (T.PLANE, T.MESH): 4, (T.HFIELD, T.CAPSULE): 3}.get((t1, t2), 1)


def contact_slot_count(m: Model) -> int:
  """Number of Contact entries Data carries (post-culling)."""
  total = sum(_npoints(m, p) for p in candidate_pairs(m))
  return min(total, DEFAULT_MAX_CONTACTS)


@dataclasses.dataclass(frozen=True)
class _Group:
  types: tuple
  g1: torch.Tensor
  g2: torch.Tensor
  size1: torch.Tensor    # [G, 3]
  size2: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _CollisionSpec:
  """Pair groups by type, and per-slot static tables in slot order."""
  groups: tuple
  ftab: torch.Tensor     # [C, 15] friction 0:5, solref 5:7, solimp 7:12,
  #                        invweight 12, pyramid invweight 13, margin 14
  itab: torch.Tensor     # [C, 5] body1, body2, geom1, geom2, condim
  includemargin: torch.Tensor  # [C]
  condim: int
  nslot: int


def _build_collision_spec(m: DeviceModel) -> _CollisionSpec | None:
  h = m.host
  pairs = candidate_pairs(h)
  if not pairs:
    return None
  by_type: dict[tuple, list[CandidatePair]] = {}
  for p in pairs:
    key = (int(h.geom_type[p.g1]), int(h.geom_type[p.g2]))
    if key not in PORTED:
      names = {int(v): k for k, v in GeomType.__members__.items()}
      raise NotImplementedError(
          f"collision pair {names[key[0]]}-{names[key[1]]} (geoms {p.g1}, "
          f"{p.g2}) has no narrowphase in the port yet")
    by_type.setdefault(key, []).append(p)
  condims = {p.condim for p in pairs}
  if condims - {1, 3, 4, 6}:
    raise NotImplementedError(f"contact condim {condims}")

  t = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=m.device)
  groups = []
  ftab, itab = [], []
  for key in sorted(by_type):
    plist = by_type[key]
    g1 = [p.g1 for p in plist]
    g2 = [p.g2 for p in plist]
    groups.append(_Group(key, t(g1), t(g2), m.tensor(h.geom_size[g1]),
                         m.tensor(h.geom_size[g2])))
    # slots are point-major then pair-major: [point0 of all pairs, ...]
    for _ in range(_npoints(h, plist[0])):
      for p in plist:
        bb1 = int(h.geom_bodyid[p.g1])
        bb2 = int(h.geom_bodyid[p.g2])
        w = float(h.body_invweight0[bb1, 0] + h.body_invweight0[bb2, 0])
        mu0 = p.friction[0]
        iwp = w * 2.0 * mu0 * mu0 * (1.0 + mu0 * mu0) / h.opt.impratio
        ftab.append(list(p.friction) + list(p.solref) + list(p.solimp)
                    + [w, iwp, max(p.margin - p.gap, 0.0)])
        itab.append([bb1, bb2, p.g1, p.g2, p.condim])
  ftab = np.asarray(ftab, np.float64)
  return _CollisionSpec(groups=tuple(groups), ftab=m.tensor(ftab),
                        itab=t(itab), includemargin=m.tensor(ftab[:, 14]),
                        condim=max(condims), nslot=len(ftab))


def collision_spec(m: DeviceModel) -> _CollisionSpec | None:
  return m.spec("collision", _build_collision_spec)


# ---------------------------------------------------------------------------
# contact frame and narrowphase primitives (batched over [..., 3])
# ---------------------------------------------------------------------------


def _dot(a, b):
  return (a * b).sum(-1)


def _cross(a, b):
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def make_frame(n: torch.Tensor) -> torch.Tensor:
  """[..., 3, 3] rows (n, t1, t2), MuJoCo's frame construction."""
  y = n.new_tensor([0.0, 1.0, 0.0])
  z = n.new_tensor([0.0, 0.0, 1.0])
  seed = torch.where((n[..., 1].abs() < 0.5)[..., None], y, z)
  t1 = _cross(seed, n)
  t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                        min=_MINVAL)
  t2 = _cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


def _sphere_sphere(c1, r1, c2, r2):
  d = c2 - c1
  ln = torch.linalg.vector_norm(d, dim=-1)
  n = d / torch.clamp(ln, min=_MINVAL)[..., None]
  dist = ln - (r1 + r2)
  pos = c1 + n * (r1 + 0.5 * dist)[..., None]
  return [(dist, pos, n)]


def _plane_sphere(ppos, pmat, c, r):
  n = pmat[..., :, 2]
  dist = _dot(c - ppos, n) - r
  pos = c - n * (r + 0.5 * dist)[..., None]
  return [(dist, pos, n)]


def _capsule_ends(gpos, gmat, half):
  axis = gmat[..., :, 2]
  return gpos - half[..., None] * axis, gpos + half[..., None] * axis


def _plane_capsule(ppos, pmat, gpos, gmat, r, half):
  a, b = _capsule_ends(gpos, gmat, half)
  return _plane_sphere(ppos, pmat, a, r) + _plane_sphere(ppos, pmat, b, r)


def _closest_on_seg(a, b, p):
  d = b - a
  t = torch.clamp(_dot(p - a, d) / torch.clamp(_dot(d, d), min=_MINVAL),
                  0.0, 1.0)
  return a + t[..., None] * d


def _seg_seg_closest(a0, a1, b0, b1):
  """Closest points between two segments (clamped)."""
  d1 = a1 - a0
  d2 = b1 - b0
  r = a0 - b0
  a = _dot(d1, d1)
  e = _dot(d2, d2)
  f = _dot(d2, r)
  c = _dot(d1, r)
  b = _dot(d1, d2)
  denom = torch.clamp(a * e - b * b, min=_MINVAL)
  s = torch.clamp((b * f - c * e) / denom, 0.0, 1.0)
  t = (b * s + f) / torch.clamp(e, min=_MINVAL)
  t_cl = torch.clamp(t, 0.0, 1.0)
  s2 = torch.clamp((b * t_cl - c) / torch.clamp(a, min=_MINVAL), 0.0, 1.0)
  return a0 + s2[..., None] * d1, b0 + t_cl[..., None] * d2


def _capsule_capsule(g1pos, g1mat, r1, h1, g2pos, g2mat, r2, h2):
  a0, a1 = _capsule_ends(g1pos, g1mat, h1)
  b0, b1 = _capsule_ends(g2pos, g2mat, h2)
  p1, p2 = _seg_seg_closest(a0, a1, b0, b1)
  return _sphere_sphere(p1, r1, p2, r2)


def _narrow(types, p1, m1, s1, p2, m2, s2):
  if types == (GeomType.PLANE, GeomType.CAPSULE):
    return _plane_capsule(p1, m1, p2, m2, s2[..., 0], s2[..., 1])
  if types == (GeomType.CAPSULE, GeomType.CAPSULE):
    return _capsule_capsule(p1, m1, s1[..., 0], s1[..., 1],
                            p2, m2, s2[..., 0], s2[..., 1])
  raise NotImplementedError(f"narrowphase for {types}")


def narrowphase_all(m: DeviceModel, d: Data, spec: _CollisionSpec):
  """All candidate contact points in slot order: dist [B, C], pos and n
  [B, C, 3]. ``overlay["geom_size"]`` [B, ngeom, 3] replaces the sizes per
  env."""
  sizes = d.overlay.get("geom_size")
  dists, poss, ns = [], [], []
  for g in spec.groups:
    if sizes is None:
      s1, s2 = g.size1, g.size2                                # [G, 3]
    else:
      s1, s2 = sizes[:, g.g1], sizes[:, g.g2]                  # [B, G, 3]
    pts = _narrow(g.types, d.geom_xpos[:, g.g1], d.geom_xmat[:, g.g1],
                  s1, d.geom_xpos[:, g.g2], d.geom_xmat[:, g.g2], s2)
    for di, po, nn in pts:
      dists.append(di)
      poss.append(po)
      ns.append(nn)
  return (torch.cat(dists, dim=1), torch.cat(poss, dim=1),
          torch.cat(ns, dim=1))


def contacts(m: DeviceModel, d: Data, max_contacts: int | None = None):
  """Top-k cull and contact constraint blocks.

  Returns (blocks, Contact) or (None, None) without candidates. blocks has
  J [B, R, nv], pos [B, R], invweight [B, R], solref [B, R, 2], solimp
  [B, R, 5] for the k deepest candidates of each env (R = k rows-per-slot)
  and ``dropped`` [B], the in-margin candidates the cull discarded.
  ``torch.topk`` may order equal scores differently from ``lax.top_k``.
  """
  spec = collision_spec(m)
  if spec is None:
    return None, None
  B = d.qpos.shape[0]
  dist, pos, n = narrowphase_all(m, d, spec)
  C = spec.nslot
  score = dist - spec.includemargin
  k = max_contacts if max_contacts is not None else min(C,
                                                        DEFAULT_MAX_CONTACTS)
  k = min(k, C)
  if k < C:
    idx = torch.topk(-score, k, dim=1).indices
    dropped = ((score < 0).sum(1)
               - (torch.gather(score, 1, idx) < 0).sum(1)).to(torch.int32)
  else:
    idx = torch.arange(C, device=dist.device).expand(B, C)
    dropped = torch.zeros((B,), dtype=torch.int32, device=dist.device)

  dyn = torch.cat([dist[..., None], pos, n], dim=-1)
  dyn_k = torch.gather(dyn, 1, idx[..., None].expand(B, k, 7))
  dist_k, pos_k, n_k = dyn_k[..., 0], dyn_k[..., 1:4], dyn_k[..., 4:7]
  ftab = spec.ftab[idx]                                       # [B, k, 15]
  fric = ftab[..., 0:5]
  solref = ftab[..., 5:7]
  solimp = ftab[..., 7:12]
  iw = ftab[..., 12]
  iwp = ftab[..., 13]
  im_k = ftab[..., 14]
  viol = dist_k - im_k
  itab = spec.itab[idx]                                       # [B, k, 5]
  if "geom_friction" in d.overlay:
    # per-env geom frictions [B, ngeom, 3], recombined per contact by the
    # plain max of the two geoms, as the reference's overlay path does: it
    # ignores geom_priority and explicit <pair> frictions, which the static
    # table (_combine) honours
    gf = d.overlay["geom_friction"]
    rows = torch.arange(B, device=gf.device)[:, None]
    f3 = torch.maximum(gf[rows, itab[..., 2]], gf[rows, itab[..., 3]])
    fric = torch.stack([f3[..., 0], f3[..., 0], f3[..., 1], f3[..., 2],
                        f3[..., 2]], dim=-1)
  frame = make_frame(n_k)                                     # [B, k, 3, 3]

  # directional point-jacobian rows for the three frame axes at once:
  # jacp(p, b2)^T d - jacp(p, b1)^T d = proj(d) * (mask2 - mask1)
  bdm = smooth.body_dof_mask(m)
  dmask = bdm[itab[..., 1]] - bdm[itab[..., 0]]               # [B, k, nv]
  ang = d.cdof[..., :3].transpose(-1, -2)[:, None]            # [B, 1, 3, nv]
  lin = d.cdof[..., 3:].transpose(-1, -2)[:, None]
  pc3 = _cross(pos_k[..., None, :], frame)                    # [B, k, 3, 3]
  rows3 = (frame @ lin + pc3 @ ang) * dmask[..., None, :]     # [B, k, 3, nv]
  jn = rows3[..., 0, :]
  if spec.condim == 1:
    rows_per = 1
    J = jn[..., None, :]
    iw_rows = iw[..., None]
    pos_rows = viol[..., None]
  else:
    # pyramid rows f1+, f1-, f2+, f2-, ...; smaller-condim slots mask their
    # extra rows inactive (pos > 0 => D = 0)
    fd = 2 if spec.condim < 4 else (3 if spec.condim < 6 else 5)
    if spec.condim >= 4:
      rot3 = (frame @ ang) * dmask[..., None, :]
      jf = torch.cat([rows3[..., 1:3, :], rot3[..., :fd - 2, :]], dim=-2)
    else:
      jf = rows3[..., 1:3, :]                                 # [B, k, fd, nv]
    mu = fric[..., :fd]
    signs = d.qpos.new_tensor([1.0, -1.0])
    rows_per = 2 * fd
    J = (jn[..., None, None, :] + signs[:, None] * mu[..., None, None]
         * jf[..., None, :]).reshape(B, k, rows_per, m.nv)
    fdix = torch.arange(fd, device=dist.device)
    rowmask = torch.repeat_interleave(itab[..., 4:5] > fdix + 1, 2, dim=-1)
    iw_rows = iwp[..., None].expand(B, k, rows_per)
    pos_rows = torch.where(rowmask, viol[..., None],
                           torch.ones_like(viol)[..., None])

  R = k * rows_per
  blocks = dict(
      J=J.reshape(B, R, m.nv),
      pos=pos_rows.reshape(B, R),
      invweight=iw_rows.reshape(B, R),
      solref=solref[..., None, :].expand(B, k, rows_per, 2).reshape(B, R, 2),
      solimp=solimp[..., None, :].expand(B, k, rows_per, 5).reshape(B, R, 5),
      dropped=dropped)
  info = Contact(dist=dist_k, pos=pos_k, frame=frame, friction=fric,
                 solref=solref, solimp=solimp,
                 geom1=itab[..., 2].to(torch.int32),
                 geom2=itab[..., 3].to(torch.int32), includemargin=im_k)
  return blocks, info
