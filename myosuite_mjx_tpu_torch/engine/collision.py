"""Collision detection: static pair enumeration and primitive narrowphase.

Counterpart of ``myosuite_mjx_tpu/engine/collision.py``. The candidate
pairs and their per-slot parameters are static host data (same filters and
combination rules as the reference); every candidate contributes fixed
contact slots, of which the ``max_contacts`` deepest are kept per env.

The narrowphase covers every primitive pair of the reference: the
analytic plane, sphere, capsule, ellipsoid, cylinder and box pairs, and
the generic convex path (MPR penetration and alternating closest points)
for the ellipsoid, cylinder and box cross pairs, with the reference's
fixed trip counts, and the heightfield pairs (a sphere, or a capsule as
three probe spheres, against the bilinear surface; per-env heights from
``Data.overlay["hfield_data"]``), and the mesh pairs: a plane, sphere,
capsule or ellipsoid against a mesh's convex hull (its triangles and face
equations, precomputed on the host), grouped by mesh. Every pair type the
reference supports is ported; no pair is ever skipped.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.engine.data import Contact, Data
from myosuite_mjx_tpu_torch.engine.model import DeviceModel, GeomType, Model
from myosuite_mjx_tpu_torch.ops.consts import const
from myosuite_mjx_tpu_torch.ops.vec import (
    cross as _cross, dot as _dot, norm as _norm)
from myosuite_mjx_tpu_torch.utils import spans

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

# type pairs whose narrowphase is ported: every supported pair.
# ``_narrow_fn`` holds the primitive ones, ``_hfield_fn`` the heightfield
# ones and ``_mesh_fn`` the mesh ones
PORTED = set(_SUPPORTED)
PRIMITIVE = {p for p in PORTED
             if GeomType.HFIELD not in p and GeomType.MESH not in p}
MESH = {p for p in PORTED if GeomType.MESH in p}


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
  hfield: "_HField | None" = None  # geom1's field, for the hfield pairs
  hull: "_Hull | None" = None      # geom2's hull, for the mesh pairs
  span: str = ""                   # its span, contacts.<TYPE1>-<TYPE2>


@dataclasses.dataclass(frozen=True)
class _HField:
  """One heightfield: its slice of ``hfield_data``, grid and size."""
  adr: int
  nrow: int
  ncol: int
  size: tuple            # (x, y, z) half-extents and height scale
  heights: torch.Tensor  # [nrow * ncol] the model's (a view of its buffer)


@dataclasses.dataclass(frozen=True)
class _Hull:
  """One mesh's convex hull in the mesh's frame: outward-wound triangles
  [F, 3, 3], face equations [F, 4] (outward normal and offset: a point x
  is inside where n . x + offset <= 0 for every face) and vertices [V, 3]."""
  tris: torch.Tensor
  eqs: torch.Tensor
  verts: torch.Tensor


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
    # the reference groups mesh pairs by geom2's mesh and hfield pairs by
    # geom1's field: the sort key (t1, t2, dataid) sets the slot order
    if key[1] == GeomType.MESH:
      dataid = int(h.geom_dataid[p.g2])
    elif key[0] == GeomType.HFIELD:
      dataid = int(h.geom_dataid[p.g1])
    else:
      dataid = -1
    by_type.setdefault(key + (dataid,), []).append(p)
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
    mesh = key[1] == GeomType.MESH
    groups.append(_Group(
        key[:2], t(g1), t(g2), m.tensor(h.geom_size[g1]),
        m.tensor(h.geom_size[g2]),
        hfield=_hfield(m, key[2]) if key[0] == GeomType.HFIELD else None,
        hull=_hull(m, key[2]) if mesh else None,
        span=spans.GROUP + "-".join(GeomType(t).name for t in key[:2])))
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


def mesh_slots(m: DeviceModel) -> tuple[torch.Tensor, int]:
  """(which geoms are meshes [ngeom] bool, on the model's device; the
  narrowphase's slots of the pairs with a mesh). Pairs are ordered by
  type, so a kept contact is a mesh slot's where its geom2 is a mesh."""
  return m.spec("mesh_slots", _build_mesh_slots)


def _build_mesh_slots(m: DeviceModel) -> tuple[torch.Tensor, int]:
  h = m.host
  mesh = np.asarray(h.geom_type) == GeomType.MESH
  n = sum(_npoints(h, p) for p in candidate_pairs(h) if mesh[p.g2])
  return torch.as_tensor(mesh, device=m.device), n


def _hfield(m: DeviceModel, dataid: int) -> _HField:
  h = m.host
  adr, nrow, ncol = (int(h.hfield_adr[dataid]), int(h.hfield_nrow[dataid]),
                     int(h.hfield_ncol[dataid]))
  return _HField(adr=adr, nrow=nrow, ncol=ncol,
                 size=tuple(float(x) for x in h.hfield_size[dataid, :3]),
                 heights=m.hfield_data[adr:adr + nrow * ncol])


def hull_geometry(m: Model, dataid: int) -> tuple[np.ndarray, np.ndarray]:
  """A mesh's hull triangles [F, 3, 3] wound outward about the centroid of
  its hull vertices, and their face equations [F, 4] (float64 numpy), as
  the reference computes them."""
  tris = np.array(m.mesh_hull_tris[dataid], np.float64)
  verts = np.array(m.mesh_hull_verts[dataid], np.float64)
  centroid = verts.mean(axis=0)
  a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
  n = np.cross(b - a, c - a)
  n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-15)
  flip = np.sum(n * (a - centroid), axis=-1) < 0
  n[flip] = -n[flip]
  tris[flip] = tris[flip][:, ::-1]
  eqs = np.concatenate([n, -np.sum(n * a, axis=-1, keepdims=True)], axis=-1)
  return tris, eqs


def _hull(m: DeviceModel, dataid: int) -> _Hull:
  tris, eqs = hull_geometry(m.host, dataid)
  return _Hull(tris=m.tensor(tris), eqs=m.tensor(eqs),
               verts=m.tensor(np.asarray(m.host.mesh_hull_verts[dataid])))


# ---------------------------------------------------------------------------
# contact frame and narrowphase primitives
#
# Every function takes a batch over leading dims: points and directions
# [..., 3], rotation matrices [..., 3, 3], sizes [..., 3] and radii [...].
# The single-point helpers return (dist [...], pos [..., 3], n [..., 3]);
# the pair functions of ``_narrow_fn`` return the same with a point axis,
# (dist [..., P], pos [..., P, 3], n [..., P or 1, 3]). The normal points from
# geom1 into geom2 and pos is the mid-penetration point, as the reference's.
# Iterative routines run the reference's fixed trip counts as masked
# updates over the whole batch: no early exit and no host sync.
# ---------------------------------------------------------------------------


def _unit(x):
  return x / torch.clamp(_norm(x), min=_MINVAL)[..., None]


def _mv(mat, v):
  """mat @ v over leading dims."""
  return (mat * v[..., None, :]).sum(-1)


def _mtv(mat, v):
  """mat^T @ v over leading dims."""
  return (mat * v[..., :, None]).sum(-2)


def _where3(c, a, b):
  """where over [..., 3] with a condition [...]."""
  return torch.where(c[..., None], a, b)


def make_frame(n: torch.Tensor) -> torch.Tensor:
  """[..., 3, 3] rows (n, t1, t2), MuJoCo's frame construction."""
  y = const((0.0, 1.0, 0.0), n)
  z = const((0.0, 0.0, 1.0), n)
  seed = torch.where((n[..., 1].abs() < 0.5)[..., None], y, z)
  t1 = _cross(seed, n)
  t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True),
                        min=_MINVAL)
  t2 = _cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


def _sphere_sphere(c1, r1, c2, r2):
  d = c2 - c1
  ln = _norm(d)
  n = d / torch.clamp(ln, min=_MINVAL)[..., None]
  dist = ln - (r1 + r2)
  pos = c1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _plane_sphere(ppos, pmat, c, r):
  n = pmat[..., :, 2]
  dist = _dot(c - ppos, n) - r
  pos = c - n * (r + 0.5 * dist)[..., None]
  return dist, pos, n


def _capsule_ends(gpos, gmat, half):
  axis = gmat[..., :, 2]
  return gpos - half[..., None] * axis, gpos + half[..., None] * axis


def _plane_capsule(ppos, pmat, gpos, gmat, r, half):
  a, b = _capsule_ends(gpos, gmat, half)
  ends = torch.stack([a, b], dim=-2)                       # [..., 2, 3]
  return _plane_sphere(ppos[..., None, :], pmat[..., None, :, :], ends,
                       r[..., None])


def _plane_ellipsoid(ppos, pmat, gpos, gmat, radii):
  n = pmat[..., :, 2]
  # support point in -n direction: x = c - E s / |s|, s = diag(r) E^T n
  s = radii * _mtv(gmat, n)
  sn = _norm(s)
  sup = gpos - _mv(gmat, radii * s) / torch.clamp(sn, min=_MINVAL)[..., None]
  dist = _dot(sup - ppos, n)
  pos = sup - 0.5 * dist[..., None] * n
  return dist, pos, n


# the corner signs of _plane_box, in the reference's loop order (x, y, z)
_BOX_CORNERS = tuple((sx, sy, sz) for sx in (-1.0, 1.0)
                     for sy in (-1.0, 1.0) for sz in (-1.0, 1.0))


def _plane_box(ppos, pmat, gpos, gmat, size):
  """All 8 corners (the solver keeps the active ones)."""
  n = pmat[..., None, :, 2]                                  # [..., 1, 3]
  local = size[..., None, :] * const(_BOX_CORNERS, size)  # [..., 8, 3]
  corner = gpos[..., None, :] + _mv(gmat[..., None, :, :], local)
  dist = _dot(corner - ppos[..., None, :], n)
  pos = corner - 0.5 * dist[..., None] * n
  return dist, pos, n


def _plane_cylinder(ppos, pmat, gpos, gmat, r, half):
  """The rim point deepest along -n at both ends, then two more rim
  points half a radius across (stability when lying flat)."""
  n = pmat[..., :, 2]
  axis = gmat[..., :, 2]
  # rim direction: project -n onto the disc plane
  pr = -n + axis * _dot(axis, n)[..., None]
  prn = _norm(pr)
  rim = _where3(prn > 1e-9, pr / torch.clamp(prn, min=_MINVAL)[..., None],
                gmat[..., :, 0])
  perp = _cross(axis, rim)
  send = const((-1.0, 1.0), n)[:, None]                       # [2, 1]
  center = (gpos[..., None, :]
            + send * half[..., None, None] * axis[..., None, :])
  p = torch.cat([center + (rim * r[..., None])[..., None, :],
                 center + 0.5 * r[..., None, None] * perp[..., None, :]
                 * send], dim=-2)                             # [..., 4, 3]
  dist = _dot(p - ppos[..., None, :], n[..., None, :])
  pos = p - 0.5 * dist[..., None] * n[..., None, :]
  return dist, pos, n[..., None, :]


def _closest_on_seg(a, b, p):
  d = b - a
  t = torch.clamp(_dot(p - a, d) / torch.clamp(_dot(d, d), min=_MINVAL),
                  0.0, 1.0)
  return a + t[..., None] * d


def _sphere_capsule(c1, r1, gpos, gmat, r2, half):
  a, b = _capsule_ends(gpos, gmat, half)
  return _sphere_sphere(c1, r1, _closest_on_seg(a, b, c1), r2)


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


def _ellipsoid_proj(p, radii, mu_ws=None, iters: int = 16):
  """Closest point on an axis-aligned ellipsoid to the local point p.

  Newton on g(mu) = sum a_i^2 p_i^2 / (a_i^2 + mu)^2 - 1 (the KKT
  multiplier), ``iters`` masked steps from a certified start or a warm
  start ``mu_ws``; lanes that did not converge fall back to the radial
  projection (see the reference for the analysis). Returns (surface
  point, outward unit normal, signed distance, mu).
  """
  a2 = radii * radii
  amin2 = a2.amin(-1)
  den_floor = (amin2 * 1e-7)[..., None]
  num = a2 * p * p

  def g_and_dg(mu):
    den = torch.maximum(a2 + mu[..., None], den_floor)
    t = num / (den * den)
    return t.sum(-1) - 1.0, (-2.0 * t / den).sum(-1)

  lo = -amin2 * (1.0 - 1e-12)
  q = p / radii
  rad2 = (q * q).sum(-1)
  inside0 = rad2 < 1.0
  # certified left-of-root start: per-axis bound mu >= a_i |p_i| - a_i^2
  cert = torch.maximum((radii * p.abs() - a2).amax(-1), lo)
  if mu_ws is None:
    mu = cert
  else:
    mu = torch.maximum(mu_ws, cert)
    mu = torch.where(inside0,
                     torch.minimum(torch.maximum(mu, lo), torch.zeros_like(mu)),
                     mu)
  gtol = 32.0 * torch.finfo(p.dtype).eps
  for _ in range(iters):
    gv, dg = g_and_dg(mu)
    mu_n = torch.maximum(mu - gv / torch.clamp(dg, max=-_MINVAL), lo)
    mu = torch.where(gv.abs() > gtol, mu_n, mu)
  x = a2 * p / torch.maximum(a2 + mu[..., None], den_floor)
  # unconverged rescue: the radial projection (NaN-safe predicate)
  gv_f, _ = g_and_dg(mu)
  xr = p / torch.sqrt(torch.clamp(rad2, min=1e-12))[..., None]
  x = _where3(~(gv_f.abs() <= 1e-3), xr, x)
  n = _unit(x / a2)
  sign = torch.where(inside0, -1.0, 1.0).to(p.dtype)
  dist = _norm(p - x) * sign
  return x, n, dist, mu


def _ellipsoid_surface_point(p, radii):
  x, n, dist, _ = _ellipsoid_proj(p, radii)
  return x, n, dist


def _sphere_ellipsoid(c1, r1, gpos, gmat, radii):
  local = _mtv(gmat, c1 - gpos)
  x, n_local, dist_c = _ellipsoid_surface_point(local, radii)
  dist = dist_c - r1
  n = -_mv(gmat, n_local)          # from the sphere (g1) into the ellipsoid
  surf_ell = gpos + _mv(gmat, x)
  surf_sph = c1 + n * r1[..., None]
  return dist, 0.5 * (surf_ell + surf_sph), n


def _seg_surface_argmin(a_l, b_l, surf_fn, ws0, iters: int = 12):
  """t in [0, 1] minimizing the signed distance of a_l + t (b_l - a_l) to
  a convex surface: a safeguarded secant on f'(t) = n(p(t)) . (b_l - a_l)
  (bisection on even steps). ``surf_fn(p, ws) -> (x, n, dist, ws)``
  carries a warm start ``ws`` from one evaluation to the next. Returns
  (t, ws)."""
  seg = b_l - a_l

  def fp(t, ws):
    _, n, _, ws = surf_fn(a_l + t[..., None] * seg, ws)
    return _dot(n, seg), ws

  zero = torch.zeros(a_l.shape[:-1], dtype=a_l.dtype, device=a_l.device)
  one = torch.ones_like(zero)
  f0, ws = fp(zero, ws0)
  f1, ws = fp(one, ws)
  lo, flo, hi, fhi = zero, f0, one, f1
  for i in range(iters):
    mid = 0.5 * (lo + hi)
    if i % 2 == 1:
      denom = fhi - flo
      sec = hi - fhi * (hi - lo) / torch.where(denom.abs() < _MINVAL,
                                               torch.inf, denom)
      s = torch.where((sec > lo) & (sec < hi), sec, mid)
    else:
      s = mid
    fs, ws = fp(s, ws)
    neg = fs < 0
    lo, flo, hi, fhi = (torch.where(neg, s, lo), torch.where(neg, fs, flo),
                        torch.where(neg, hi, s), torch.where(neg, fhi, fs))
  t_root = torch.where(flo.abs() < fhi.abs(), lo, hi)
  return torch.where(f0 >= 0, zero, torch.where(f1 <= 0, one, t_root)), ws


def _capsule_ellipsoid(gpos1, gmat1, r1, h1, gpos2, gmat2, radii):
  """1D convex minimization over the capsule axis of the point-ellipsoid
  signed distance; the KKT multiplier warm-starts the projections (a
  12-step cold start, 6 steps per search evaluation, 16 at the end)."""
  a, b = _capsule_ends(gpos1, gmat1, h1)
  a_l = _mtv(gmat2, a - gpos2)
  b_l = _mtv(gmat2, b - gpos2)

  def surf(p, mu):
    return _ellipsoid_proj(p, radii, mu_ws=mu, iters=6)

  _, _, _, mu0 = _ellipsoid_proj(a_l, radii, iters=12)
  t, mu = _seg_surface_argmin(a_l, b_l, surf, mu0, iters=11)
  p = a + t[..., None] * (b - a)
  local = _mtv(gmat2, p - gpos2)
  x, n_local, dist_c, _ = _ellipsoid_proj(local, radii, mu_ws=mu, iters=16)
  dist = dist_c - r1
  n = -_mv(gmat2, n_local)       # from the capsule (g1) into the ellipsoid
  surf_ell = gpos2 + _mv(gmat2, x)
  surf_sph = p + n * r1[..., None]
  return dist, 0.5 * (surf_ell + surf_sph), n


def _cylinder_surface_point(p, r, half):
  """Closest surface point, outward normal and signed distance of the
  local point p to a z-axis cylinder (radius r, half-height half)."""
  pxy, pz = p[..., :2], p[..., 2]
  rd = _norm(pxy)
  dir_xy = pxy / torch.clamp(rd, min=_MINVAL)[..., None]
  zero = torch.zeros_like(pz)
  radial_dir = torch.cat([dir_xy, zero[..., None]], dim=-1)
  zsign = torch.where(pz >= 0, 1.0, -1.0).to(p.dtype)

  side_out = rd > r
  cap_out = pz.abs() > half
  # outside: the corner, side or cap point
  clamp_xy = torch.where(side_out, r, rd)
  clamp_z = torch.where(cap_out, zsign * half, pz)
  surf_out = torch.cat([dir_xy * clamp_xy[..., None], clamp_z[..., None]],
                       dim=-1)
  d_out = p - surf_out
  dn_out = _norm(d_out)
  n_out = d_out / torch.clamp(dn_out, min=_MINVAL)[..., None]
  # inside: the nearest face (side or cap)
  side_gap = r - rd
  cap_gap = half - pz.abs()
  use_side = side_gap < cap_gap
  surf_in = _where3(use_side,
                    torch.cat([dir_xy * r[..., None], pz[..., None]], dim=-1),
                    torch.cat([pxy, (zsign * half)[..., None]], dim=-1))
  n_in = _where3(use_side, radial_dir,
                 torch.stack([zero, zero, zsign], dim=-1))
  d_in = -torch.minimum(side_gap, cap_gap)

  outside = side_out | cap_out
  return (_where3(outside, surf_out, surf_in), _where3(outside, n_out, n_in),
          torch.where(outside, dn_out, d_in))


def _sphere_cylinder(c1, r1, gpos, gmat, r2, h2):
  local = _mtv(gmat, c1 - gpos)
  surf_l, n_l, dist_c = _cylinder_surface_point(local, r2, h2)
  dist = dist_c - r1
  n = -_mv(gmat, n_l)             # from the sphere (g1) into the cylinder
  surf_cyl = gpos + _mv(gmat, surf_l)
  surf_sph = c1 + n * r1[..., None]
  return dist, 0.5 * (surf_cyl + surf_sph), n


def _capsule_cylinder(gpos1, gmat1, r1, h1, gpos2, gmat2, r2, h2):
  """1D convex minimization over the capsule axis of the point-cylinder
  signed distance (see _seg_surface_argmin)."""
  a, b = _capsule_ends(gpos1, gmat1, h1)
  a_l = _mtv(gmat2, a - gpos2)
  b_l = _mtv(gmat2, b - gpos2)

  def surf(p, ws):
    return _cylinder_surface_point(p, r2, h2) + (ws,)

  t, _ = _seg_surface_argmin(a_l, b_l, surf, None)
  p = a + t[..., None] * (b - a)
  return _sphere_cylinder(p, r1, gpos2, gmat2, r2, h2)


def _onehot3(k, like):
  return torch.arange(3, device=like.device) == k[..., None]


def _sphere_box(c1, r1, gpos, gmat, size):
  local = _mtv(gmat, c1 - gpos)
  size = size.expand(local.shape)
  clamped = torch.minimum(torch.maximum(local, -size), size)
  inside = (local.abs() < size).all(-1)
  # outside: the closest point of the box
  d = local - clamped
  ln = _norm(d)
  n_out_local = d / torch.clamp(ln, min=_MINVAL)[..., None]
  dist_out = ln - r1
  # inside: out through the nearest face
  face_dist = size - local.abs()
  k = face_dist.argmin(-1)
  hot = _onehot3(k, local)
  sign = torch.gather(torch.sign(local), -1, k[..., None])[..., 0]
  n_in_local = torch.where(hot, sign[..., None], torch.zeros_like(local))
  dist_in = -(torch.gather(face_dist, -1, k[..., None])[..., 0] + r1)
  clamped_in = torch.where(
      hot, (sign * torch.gather(size, -1, k[..., None])[..., 0])[..., None],
      local)
  n_local = _where3(inside, n_in_local, n_out_local)
  dist = torch.where(inside, dist_in, dist_out)
  surf_local = _where3(inside, clamped_in, clamped)
  n_box_to_sphere = _mv(gmat, n_local)
  surf = gpos + _mv(gmat, surf_local)
  pos = 0.5 * (surf + c1 - n_box_to_sphere * r1[..., None])
  return dist, pos, -n_box_to_sphere  # n from the sphere (g1) into the box


def _capsule_box(gpos1, gmat1, r1, h1, gpos2, gmat2, size):
  """Sphere-box at both capsule ends and the midpoint (3 points)."""
  a, b = _capsule_ends(gpos1, gmat1, h1)
  c = torch.stack([a, b, 0.5 * (a + b)], dim=-2)           # [..., 3, 3]
  return _sphere_box(c, r1[..., None], gpos2[..., None, :],
                     gmat2[..., None, :, :], size[..., None, :])


# ---------------------------------------------------------------------------
# generic convex-convex (ellipsoid, cylinder and box cross pairs): support
# map MPR for penetration, alternating closest-point projection for
# separation; one contact point per pair
# ---------------------------------------------------------------------------


def _support_local(t: int):
  """f(size, d_local) -> support point of the geom in its local frame."""
  T = GeomType
  if t == T.SPHERE:
    return lambda s, d: (s[..., 0:1] * d
                         / torch.clamp(_norm(d), min=_MINVAL)[..., None])
  if t == T.CAPSULE:
    def f(s, d):
      z = torch.where(d[..., 2] >= 0, s[..., 1], -s[..., 1])
      zaxis = torch.stack([torch.zeros_like(z), torch.zeros_like(z), z], -1)
      return s[..., 0:1] * _unit(d) + zaxis
    return f
  if t == T.ELLIPSOID:
    def f(s, d):
      w = s * d
      return s * w / torch.clamp(_norm(w), min=_MINVAL)[..., None]
    return f
  if t == T.CYLINDER:
    def f(s, d):
      nxy = _norm(d[..., :2])
      xy = torch.where(
          (nxy > 1e-12)[..., None],
          s[..., 0:1] * d[..., :2] / torch.clamp(nxy, min=_MINVAL)[..., None],
          torch.zeros_like(d[..., :2]))
      z = torch.where(d[..., 2] >= 0, s[..., 1], -s[..., 1])
      return torch.cat([xy, z[..., None]], dim=-1)
    return f
  if t == T.BOX:
    return lambda s, d: s * torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
  raise NotImplementedError(f"support map for geom type {t}")


def _closest_surface_local(t: int):
  """f(size, p_local) -> (surface point, outward normal, signed dist)."""
  T = GeomType
  if t == T.SPHERE:
    def f(s, p):
      pn = _norm(p)
      n = p / torch.clamp(pn, min=_MINVAL)[..., None]
      return s[..., 0:1] * n, n, pn - s[..., 0]
    return f
  if t == T.CAPSULE:
    def f(s, p):
      seg = torch.minimum(torch.maximum(p[..., 2], -s[..., 1]), s[..., 1])
      zero = torch.zeros_like(seg)
      c = torch.stack([zero, zero, seg], dim=-1)
      d = p - c
      dn = _norm(d)
      n = d / torch.clamp(dn, min=_MINVAL)[..., None]
      return c + s[..., 0:1] * n, n, dn - s[..., 0]
    return f
  if t == T.ELLIPSOID:
    return lambda s, p: _ellipsoid_surface_point(p, s)
  if t == T.CYLINDER:
    return lambda s, p: _cylinder_surface_point(p, s[..., 0], s[..., 1])
  if t == T.BOX:
    def f(s, p):
      inside = (p.abs() < s).all(-1)
      q_out = torch.minimum(torch.maximum(p, -s), s)
      d_out = p - q_out
      dn_out = _norm(d_out)
      n_out = d_out / torch.clamp(dn_out, min=_MINVAL)[..., None]
      gaps = s - p.abs()
      k = gaps.argmin(-1)
      hot = _onehot3(k, p)
      pk = torch.gather(p, -1, k[..., None])[..., 0]
      sign = torch.where(pk >= 0, 1.0, -1.0).to(p.dtype)
      sk = torch.gather(s, -1, k[..., None])[..., 0]
      q_in = torch.where(hot, (sign * sk)[..., None], p)
      n_in = torch.where(hot, sign[..., None], torch.zeros_like(p))
      d_in = -gaps.amin(-1)
      return (_where3(inside, q_in, q_out), _where3(inside, n_in, n_out),
              torch.where(inside, d_in, dn_out))
    return f
  raise NotImplementedError(f"closest-point map for geom type {t}")


def _mpr_penetration(sup_m, v0):
  """Minkowski Portal Refinement (libccd semantics), batched.

  ``sup_m(d) -> (v, a1, a2)``: the support of the Minkowski difference
  S2 - S1 in world direction d, with its witness points on S1 and S2. v0
  [..., 3] is an interior point of the difference (center2 - center1).
  Portal discovery runs 16 masked iterations, refinement 24 and the
  normal polish 10, as the reference's. Returns (hit, depth, n, pos): n
  from geom1 into geom2, pos the mid-penetration point.
  """
  eps = 1e-12
  tiny = const((1e-8, 0.0, 0.0), v0)
  # degenerate center overlap: nudge
  v0 = _where3(_norm(v0) < 1e-10, v0 + tiny, v0)

  v1, a11, a12 = sup_m(-v0)
  sep1 = _dot(v1, -v0) < 0    # origin beyond the support along -v0
  d2 = _cross(v1, v0)
  # origin on the v0-v1 line: perturb the direction deterministically
  d2 = _where3(_norm(d2) < 1e-12,
               _cross(v1 + const((3e-8, 1e-8, 2e-8), v0), v0), d2)
  d2 = _where3(_norm(d2) < 1e-12, const((0.0, 0.0, 1.0), v0), d2)
  v2, a21, a22 = sup_m(_unit(d2))
  sep2 = _dot(v2, _unit(d2)) < 0

  flip = _dot(_cross(v1 - v0, v2 - v0), v0) > 0
  v1, v2 = _where3(flip, v2, v1), _where3(flip, v1, v2)
  a11, a21 = _where3(flip, a21, a11), _where3(flip, a11, a21)
  a12, a22 = _where3(flip, a22, a12), _where3(flip, a12, a22)

  # portal discovery: v3 such that the origin ray pierces (v1, v2, v3)
  v3 = a31 = a32 = torch.zeros_like(v0)
  done = torch.zeros(v0.shape[:-1], dtype=torch.bool, device=v0.device)
  for _ in range(16):
    v3n, b1, b2 = sup_m(_unit(_cross(v1 - v0, v2 - v0)))
    v3 = _where3(done, v3, v3n)
    a31 = _where3(done, a31, b1)
    a32 = _where3(done, a32, b2)
    out1 = _dot(_cross(v1, v3), v0) < -eps   # origin outside (v1, 0, v3)
    out2 = _dot(_cross(v3, v2), v0) < -eps   # origin outside (v3, 0, v2)
    done = done | (~out1 & ~out2)
    rep2 = ~done & out1
    rep1 = ~done & ~out1 & out2
    v2 = _where3(rep2, v3, v2)
    a21 = _where3(rep2, a31, a21)
    a22 = _where3(rep2, a32, a22)
    v1 = _where3(rep1, v3, v1)
    a11 = _where3(rep1, a31, a11)
    a12 = _where3(rep1, a32, a12)
  found = done

  def portal_normal(v1, v2, v3):
    n = _unit(_cross(v2 - v1, v3 - v1))
    # oriented away from v0 (outward through the portal)
    return _where3(_dot(n, v0) > 0, -n, n)

  # portal refinement (libccd's expand-portal vertex replacement)
  done = torch.zeros_like(found)
  for _ in range(24):
    n = portal_normal(v1, v2, v3)
    v4, b1, b2 = sup_m(n)
    done = done | (_dot(v4 - v1, n) < 1e-7)
    v4v0 = _cross(v4, v0)
    c1 = _dot(v1, v4v0) > 0
    c2 = _dot(v2, v4v0) > 0
    c3 = _dot(v3, v4v0) > 0
    rep1 = ~done & ((c1 & c2) | (~c1 & ~c3))
    rep3 = ~done & c1 & ~c2
    rep2 = ~done & ~c1 & c3
    v1, a11, a12 = (_where3(rep1, v4, v1), _where3(rep1, b1, a11),
                    _where3(rep1, b2, a12))
    v2, a21, a22 = (_where3(rep2, v4, v2), _where3(rep2, b1, a21),
                    _where3(rep2, b2, a22))
    v3, a31, a32 = (_where3(rep3, v4, v3), _where3(rep3, b1, a31),
                    _where3(rep3, b2, a32))

  n = portal_normal(v1, v2, v3)
  # depth: the support distance along n
  v4f, _, _ = sup_m(n)
  depth = _dot(v4f, n)
  hit = (_dot(v1, n) >= -1e-10) & ~sep1 & ~sep2 & found

  # witness position: barycentric coords of the origin projected onto the
  # portal plane
  p = _dot(v1, n)[..., None] * n
  e1, e2 = v2 - v1, v3 - v1
  q = p - v1
  d11, d12, d22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
  q1, q2 = _dot(q, e1), _dot(q, e2)
  det = torch.clamp(d11 * d22 - d12 * d12, min=_MINVAL)
  l2 = (d22 * q1 - d12 * q2) / det
  l3 = (d11 * q2 - d12 * q1) / det
  l1 = 1.0 - l2 - l3
  lam = torch.clamp(torch.stack([l1, l2, l3], dim=-1), 0.0, 1.0)
  lam = lam / torch.clamp(lam.sum(-1), min=_MINVAL)[..., None]
  p_on1 = (lam[..., 0:1] * a11 + lam[..., 1:2] * a21 + lam[..., 2:3] * a31)
  p_on2 = (lam[..., 0:1] * a12 + lam[..., 1:2] * a22 + lam[..., 2:3] * a32)
  pos = 0.5 * (p_on1 + p_on2)

  # normal polish: projected gradient descent on the directional depth,
  # keeping the best iterate (see the reference)
  eta0 = 1.0 / torch.clamp(_norm(v0), min=_MINVAL)
  nc, bd, bn, bp = -n, depth, -n, pos
  for i in range(10):
    _, x1, x2 = sup_m(-nc)        # x1 = sup1(nc), x2 = sup2(-nc)
    g = x1 - x2
    d_dir = _dot(g, nc)
    better = d_dir < bd
    bd = torch.where(better, d_dir, bd)
    bn = _where3(better, nc, bn)
    bp = _where3(better, 0.5 * (x1 + x2), bp)
    g_t = g - _dot(g, nc)[..., None] * nc
    eta = eta0 * (1.5 * 0.7 ** i)
    nc = _unit(nc - eta[..., None] * g_t)
  return hit, bd, bn, bp


def _alternating_closest(cl1, cl2, p1, m1, s1, p2, m2, s2, iters: int = 12):
  """Closest points of two disjoint convex geoms by alternating projection
  onto their surfaces. Returns (dist, pos, n)."""
  x = p2  # start from geom2's center
  for _ in range(iters):
    y = p1 + _mv(m1, cl1(s1, _mtv(m1, x - p1))[0])
    x = p2 + _mv(m2, cl2(s2, _mtv(m2, y - p2))[0])
  y = p1 + _mv(m1, cl1(s1, _mtv(m1, x - p1))[0])
  d = x - y
  dn = _norm(d)
  return dn, 0.5 * (x + y), d / torch.clamp(dn, min=_MINVAL)[..., None]


def _convex_convex_fn(t1: int, t2: int):
  """The narrowphase of a generic convex pair: (p1, m1, s1, p2, m2, s2) ->
  (dist, pos, n)."""
  sup1, sup2 = _support_local(t1), _support_local(t2)
  cl1, cl2 = _closest_surface_local(t1), _closest_surface_local(t2)

  def fn(p1, m1, s1, p2, m2, s2):
    def sup_m(d):
      x1 = p1 + _mv(m1, sup1(s1, _mtv(m1, -d)))
      x2 = p2 + _mv(m2, sup2(s2, _mtv(m2, d)))
      return x2 - x1, x1, x2

    hit, depth, n_pen, pos_pen = _mpr_penetration(sup_m, p2 - p1)
    d_sep, pos_sep, n_sep = _alternating_closest(
        cl1, cl2, p1, m1, s1, p2, m2, s2)
    return (torch.where(hit, -depth, d_sep), _where3(hit, pos_pen, pos_sep),
            _where3(hit, n_pen, n_sep))

  return fn


def _one(fn):
  """A single-point pair function with the point axis added."""
  def wrapped(*args):
    dist, pos, n = fn(*args)
    return dist[..., None], pos[..., None, :], n[..., None, :]
  return wrapped


def _hfield_heights(heights, idx):
  """``heights`` at flat cell indices ``idx`` [B, ...]: one field [N], or
  one per env [B, N]."""
  if heights.dim() == 1:
    return heights[idx]
  B = idx.shape[0]
  return torch.gather(heights, 1, idx.reshape(B, -1)).reshape(idx.shape)


def _hfield_height_normal(xy, heights, size, nrow: int, ncol: int):
  """Bilinear height [B, ...] and outward normal [B, ..., 3] of a field at
  local xy [B, ..., 2] (see ``_hfield_heights`` for ``heights``). The grid
  coordinate clips at n - 1.001, as the reference's."""
  sx, sy, sz = size
  gx = (xy[..., 0] + sx) / (2 * sx) * (ncol - 1)
  gy = (xy[..., 1] + sy) / (2 * sy) * (nrow - 1)
  gx = torch.clamp(gx, 0.0, ncol - 1.001)
  gy = torch.clamp(gy, 0.0, nrow - 1.001)
  c0 = torch.floor(gx)
  r0 = torch.floor(gy)
  fx = gx - c0
  fy = gy - r0
  idx = (r0 * ncol + c0).long()
  h00, h01, h10, h11 = (_hfield_heights(heights, idx + off)
                        for off in (0, 1, ncol, ncol + 1))
  h = ((1 - fy) * ((1 - fx) * h00 + fx * h01)
       + fy * ((1 - fx) * h10 + fx * h11)) * sz
  dx_cell = 2 * sx / (ncol - 1)
  dy_cell = 2 * sy / (nrow - 1)
  dhdx = ((1 - fy) * (h01 - h00) + fy * (h11 - h10)) * sz / dx_cell
  dhdy = ((1 - fx) * (h10 - h00) + fx * (h11 - h01)) * sz / dy_cell
  n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], -1)
  return h, _unit(n)


def _sphere_hfield(c2, r2, gpos, gmat, heights, size, nrow, ncol):
  """Sphere (geom2) against a field (geom1), one point: (dist, pos, n)
  with n the field's normal under the sphere, in world axes."""
  local = _mtv(gmat, c2 - gpos)
  h, n_l = _hfield_height_normal(local[..., :2], heights, size, nrow, ncol)
  dist = (local[..., 2] - h) * n_l[..., 2] - r2
  surf_l = torch.cat([local[..., :2], h[..., None]], -1)
  n = _mv(gmat, n_l)
  surf = gpos + _mv(gmat, surf_l)
  pos = 0.5 * (surf + (c2 - n * r2[..., None]))
  return dist, pos, n


def _capsule_hfield(c_pos, c_mat, r2, half, gpos, gmat, heights, size, nrow,
                    ncol):
  """Capsule (geom2) against a field (geom1): its ends and its midpoint as
  three probe spheres, in that order."""
  a, b = _capsule_ends(c_pos, c_mat, half)
  probes = torch.stack([a, b, 0.5 * (a + b)], dim=-2)      # [..., 3, 3]
  return _sphere_hfield(probes, r2[..., None], gpos[..., None, :],
                        gmat[..., None, :, :], heights, size, nrow, ncol)


def _hfield_fn(t2: int, heights, field: _HField):
  """The narrowphase of geom type ``t2`` against ``field`` with the given
  heights ([nrow * ncol], or [B, nrow * ncol] per env)."""
  args = (heights, field.size, field.nrow, field.ncol)
  if t2 == GeomType.SPHERE:
    return _one(lambda p1, m1, s1, p2, m2, s2: _sphere_hfield(
        p2, s2[..., 0], p1, m1, *args))
  if t2 == GeomType.CAPSULE:
    return lambda p1, m1, s1, p2, m2, s2: _capsule_hfield(
        p2, m2, s2[..., 0], s2[..., 1], p1, m1, *args)
  raise NotImplementedError(f"hfield collision vs type {t2}")


# ---------------------------------------------------------------------------
# convex mesh hulls: exact point and segment queries over hull triangles.
# A hull is shared by its whole group (one mesh), so its triangles [F, ...]
# broadcast against the batch's points [..., 3].
# ---------------------------------------------------------------------------


def _closest_on_tri(p, a, b, c):
  """The closest point on triangle abc to p (Ericson's regions, every
  candidate evaluated and the region's selected, as the reference's).
  Broadcasts over leading dims."""
  ab = b - a
  ac = c - a
  ap = p - a
  bp = p - b
  cp = p - c
  d1, d2 = _dot(ab, ap), _dot(ac, ap)
  d3, d4 = _dot(ab, bp), _dot(ac, bp)
  d5, d6 = _dot(ab, cp), _dot(ac, cp)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  denom = torch.clamp(va + vb + vc, min=_MINVAL)
  pt = a + (vb / denom)[..., None] * ab + (vc / denom)[..., None] * ac
  # edge and vertex regions, the reference's order of precedence
  t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=_MINVAL), 0, 1)
  t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=_MINVAL), 0, 1)
  e43, e56 = d4 - d3, d5 - d6
  t_bc = torch.clamp(e43 / torch.clamp(e43 + e56, min=_MINVAL), 0, 1)
  pt = _where3((va <= 0) & (e43 >= 0) & (e56 >= 0),
               b + t_bc[..., None] * (c - b), pt)
  pt = _where3((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[..., None] * ac,
               pt)
  pt = _where3((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[..., None] * ab,
               pt)
  pt = _where3((d6 >= 0) & (d5 <= d6), c, pt)
  pt = _where3((d3 >= 0) & (d4 <= d3), b, pt)
  return _where3((d1 <= 0) & (d2 <= 0), a, pt)


def _hull_sq_dists(p, tris):
  """Squared distances [..., F] from p [..., 3] to every hull triangle,
  and the closest points [..., F, 3]."""
  q = p[..., None, :]
  cps = _closest_on_tri(q, tris[:, 0], tris[:, 1], tris[:, 2])
  return ((cps - q) ** 2).sum(-1), cps


def _plane_dists(p, eqs):
  """n . p + offset [..., F] of every face (positive outside)."""
  return (p[..., None, :] * eqs[:, :3]).sum(-1) + eqs[:, 3]


def _point_hull(p, tris, eqs):
  """The hull's surface point, outward normal and signed distance for
  local points p [..., 3]: outside, the closest point over the triangles;
  inside, the projection onto the least deep face."""
  d2, cps = _hull_sq_dists(p, tris)
  k = torch.argmin(d2, dim=-1, keepdim=True)                  # [..., 1]
  cp = torch.gather(cps, -2, k[..., None].expand(k.shape + (3,)))[..., 0, :]
  d2min = torch.gather(d2, -1, k)[..., 0]
  plane_d = _plane_dists(p, eqs)
  inside = (plane_d <= 0).all(-1)
  kf = torch.argmax(plane_d, dim=-1)                          # [...]
  depth = torch.gather(plane_d, -1, kf[..., None])[..., 0]
  n_in = eqs[:, :3][kf]
  cp_in = p - depth[..., None] * n_in
  n_out = _unit(p - cp)
  surf = _where3(inside, cp_in, cp)
  n = _where3(inside, n_in, n_out)
  dist = torch.where(inside, depth, torch.sqrt(torch.clamp(d2min, min=0.0)))
  return surf, n, dist


def _point_hull_dist(p, tris, eqs):
  """``_point_hull``'s signed distance alone (the same values)."""
  d2, _ = _hull_sq_dists(p, tris)
  depth = _plane_dists(p, eqs).amax(-1)
  return torch.where(depth <= 0, depth,
                     torch.sqrt(torch.clamp(d2.amin(-1), min=0.0)))


def _sphere_hull(c1, r1, gpos, gmat, tris, eqs):
  """Sphere (geom1) against a hull (geom2): (dist, pos, n), n from the
  sphere into the hull."""
  surf_l, n_l, dist_c = _point_hull(_mtv(gmat, c1 - gpos), tris, eqs)
  n = -_mv(gmat, n_l)
  surf_hull = gpos + _mv(gmat, surf_l)
  surf_sph = c1 + n * r1[..., None]
  return dist_c - r1, 0.5 * (surf_hull + surf_sph), n


# the golden-section search of ``_capsule_hull``: its ratio and its fixed
# trip count (no early exit)
_GOLDEN = 0.6180339887498949
_GOLDEN_TRIPS = 32


def _capsule_hull(gpos1, gmat1, r1, h1, gpos2, gmat2, tris, eqs):
  """Capsule (geom1) against a hull: a golden-section search over the
  segment for the point nearest the hull, then that point as a sphere.
  The two probes of each trip are evaluated as one batch."""
  a, b = _capsule_ends(gpos1, gmat1, h1)
  a_l = _mtv(gmat2, a - gpos2)
  seg_l = _mtv(gmat2, b - gpos2) - a_l
  lo = torch.zeros(a_l.shape[:-1], dtype=a_l.dtype, device=a_l.device)
  hi = torch.ones_like(lo)
  for _ in range(_GOLDEN_TRIPS):
    m1 = hi - _GOLDEN * (hi - lo)
    m2 = lo + _GOLDEN * (hi - lo)
    t = torch.stack([m1, m2], -1)                             # [..., 2]
    f = _point_hull_dist(a_l[..., None, :] + t[..., None] * seg_l[..., None, :],
                         tris, eqs)
    left = f[..., 0] < f[..., 1]
    lo, hi = torch.where(left, lo, m1), torch.where(left, m2, hi)
  t = 0.5 * (lo + hi)
  return _sphere_hull(a + t[..., None] * (b - a), r1, gpos2, gmat2, tris,
                      eqs)


def _ellipsoid_hull(gpos1, gmat1, radii, gpos2, gmat2, tris, eqs):
  """Ellipsoid (geom1) against a hull, approximate as the reference's: the
  hull point nearest the ellipsoid's centre, then the exact distance from
  that point to the ellipsoid; n from the ellipsoid into the hull."""
  surf_l, _, _ = _point_hull(_mtv(gmat2, gpos1 - gpos2), tris, eqs)
  hull_pt = gpos2 + _mv(gmat2, surf_l)
  x, n_l, dist = _ellipsoid_surface_point(_mtv(gmat1, hull_pt - gpos1), radii)
  surf_ell = gpos1 + _mv(gmat1, x)
  return dist, 0.5 * (surf_ell + hull_pt), _mv(gmat1, n_l)


def _plane_hull(ppos, pmat, gpos, gmat, verts):
  """Plane against a hull: its 4 lowest vertices as contact points (ties
  by vertex order, as ``lax.top_k``)."""
  n = pmat[..., :, 2]
  world = gpos[..., None, :] + _mv(gmat[..., None, :, :], verts)  # [..., V, 3]
  heights = _dot(world - ppos[..., None, :], n[..., None, :])     # [..., V]
  idx = torch.sort(heights, dim=-1, stable=True).indices[..., :4]
  dist = torch.gather(heights, -1, idx)
  w = torch.gather(world, -2, idx[..., None].expand(idx.shape + (3,)))
  return dist, w - 0.5 * dist[..., None] * n[..., None, :], n[..., None, :]


def _mesh_fn(t1: int, hull: _Hull):
  """The narrowphase of geom type ``t1`` against ``hull`` (geom2)."""
  T = GeomType
  tris, eqs = hull.tris, hull.eqs
  if t1 == T.PLANE:
    return lambda p1, m1, s1, p2, m2, s2: _plane_hull(p1, m1, p2, m2,
                                                      hull.verts)
  if t1 == T.SPHERE:
    return _one(lambda p1, m1, s1, p2, m2, s2: _sphere_hull(
        p1, s1[..., 0], p2, m2, tris, eqs))
  if t1 == T.CAPSULE:
    return _one(lambda p1, m1, s1, p2, m2, s2: _capsule_hull(
        p1, m1, s1[..., 0], s1[..., 1], p2, m2, tris, eqs))
  if t1 == T.ELLIPSOID:
    return _one(lambda p1, m1, s1, p2, m2, s2: _ellipsoid_hull(
        p1, m1, s1, p2, m2, tris, eqs))
  raise NotImplementedError(f"mesh collision vs type {t1}")


def _narrow_fn(t1: int, t2: int):
  """Uniform signature (p1, m1, s1, p2, m2, s2) -> (dist [..., P],
  pos [..., P, 3], n [..., P, 3]), the reference's dispatch table."""
  T = GeomType
  table = {
      (T.PLANE, T.SPHERE): _one(
          lambda p1, m1, s1, p2, m2, s2: _plane_sphere(p1, m1, p2,
                                                       s2[..., 0])),
      (T.PLANE, T.CAPSULE): lambda p1, m1, s1, p2, m2, s2: _plane_capsule(
          p1, m1, p2, m2, s2[..., 0], s2[..., 1]),
      (T.PLANE, T.ELLIPSOID): _one(
          lambda p1, m1, s1, p2, m2, s2: _plane_ellipsoid(p1, m1, p2, m2,
                                                          s2)),
      (T.PLANE, T.BOX): lambda p1, m1, s1, p2, m2, s2: _plane_box(
          p1, m1, p2, m2, s2),
      (T.PLANE, T.CYLINDER): lambda p1, m1, s1, p2, m2, s2: _plane_cylinder(
          p1, m1, p2, m2, s2[..., 0], s2[..., 1]),
      (T.SPHERE, T.SPHERE): _one(
          lambda p1, m1, s1, p2, m2, s2: _sphere_sphere(p1, s1[..., 0], p2,
                                                        s2[..., 0])),
      (T.SPHERE, T.CAPSULE): _one(
          lambda p1, m1, s1, p2, m2, s2: _sphere_capsule(
              p1, s1[..., 0], p2, m2, s2[..., 0], s2[..., 1])),
      (T.SPHERE, T.ELLIPSOID): _one(
          lambda p1, m1, s1, p2, m2, s2: _sphere_ellipsoid(
              p1, s1[..., 0], p2, m2, s2)),
      (T.SPHERE, T.BOX): _one(
          lambda p1, m1, s1, p2, m2, s2: _sphere_box(p1, s1[..., 0], p2, m2,
                                                     s2)),
      (T.SPHERE, T.CYLINDER): _one(
          lambda p1, m1, s1, p2, m2, s2: _sphere_cylinder(
              p1, s1[..., 0], p2, m2, s2[..., 0], s2[..., 1])),
      (T.CAPSULE, T.CYLINDER): _one(
          lambda p1, m1, s1, p2, m2, s2: _capsule_cylinder(
              p1, m1, s1[..., 0], s1[..., 1], p2, m2, s2[..., 0],
              s2[..., 1])),
      (T.CAPSULE, T.CAPSULE): _one(
          lambda p1, m1, s1, p2, m2, s2: _capsule_capsule(
              p1, m1, s1[..., 0], s1[..., 1], p2, m2, s2[..., 0],
              s2[..., 1])),
      (T.CAPSULE, T.ELLIPSOID): _one(
          lambda p1, m1, s1, p2, m2, s2: _capsule_ellipsoid(
              p1, m1, s1[..., 0], s1[..., 1], p2, m2, s2)),
      (T.CAPSULE, T.BOX): lambda p1, m1, s1, p2, m2, s2: _capsule_box(
          p1, m1, s1[..., 0], s1[..., 1], p2, m2, s2),
  }
  if (t1, t2) in table:
    return table[(t1, t2)]
  # generic convex pairs (ellipsoid, cylinder and box cross combinations)
  return _one(_convex_convex_fn(t1, t2))


def group_fn(g: _Group, d: Data):
  """The narrowphase of a type group: ``_narrow_fn``'s, a hull's, or a
  field's with its heights (the model's, or ``d.overlay["hfield_data"]``
  per env)."""
  if g.hull is not None:
    return _mesh_fn(g.types[0], g.hull)
  if g.hfield is None:
    return _narrow_fn(*g.types)
  f = g.hfield
  heights = d.overlay.get("hfield_data")
  heights = (f.heights if heights is None else
             heights[:, f.adr:f.adr + f.nrow * f.ncol])
  return _hfield_fn(g.types[1], heights, f)


def narrowphase_all(m: DeviceModel, d: Data, spec: _CollisionSpec):
  """All candidate contact points in slot order: dist [B, C], pos and n
  [B, C, 3]. ``overlay["geom_size"]`` [B, ngeom, 3] replaces the sizes per
  env, ``overlay["hfield_data"]`` [B, len(hfield_data)] the heights. Each
  type group runs as one batch [B, G] with its points on a last axis;
  slots are point-major, then pair-major."""
  sizes = d.overlay.get("geom_size")
  B = d.qpos.shape[0]
  dists, poss, ns = [], [], []
  for g in spec.groups:
    if sizes is None:
      s1 = g.size1.expand(B, -1, -1)                           # [B, G, 3]
      s2 = g.size2.expand(B, -1, -1)
    else:
      s1, s2 = sizes[:, g.g1], sizes[:, g.g2]
    with spans.span(g.span):
      di, po, nn = group_fn(g, d)(
          d.geom_xpos[:, g.g1], d.geom_xmat[:, g.g1], s1,
          d.geom_xpos[:, g.g2], d.geom_xmat[:, g.g2], s2)
      dists.append(di.transpose(1, 2).reshape(B, -1))
      poss.append(po.transpose(1, 2).reshape(B, -1, 3))
      ns.append(nn.expand(po.shape).transpose(1, 2).reshape(B, -1, 3))
  return (torch.cat(dists, dim=1), torch.cat(poss, dim=1),
          torch.cat(ns, dim=1))


def contacts(m: DeviceModel, d: Data, max_contacts: int | None = None):
  """Top-k cull and contact constraint blocks.

  Returns (blocks, Contact) or (None, None) without candidates. blocks has
  J [B, R, nv], pos [B, R], invweight [B, R], solref [B, R, 2], solimp
  [B, R, 5] for the k deepest candidates of each env (R = k rows-per-slot)
  and ``dropped`` [B], the in-margin candidates the cull discarded.
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
    # a stable sort breaks ties by slot, as ``lax.top_k`` does (feet
    # resting on a flat field and on the floor tie exactly)
    idx = torch.sort(score, dim=1, stable=True).indices[:, :k]
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
    signs = const((1.0, -1.0), d.qpos)
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
