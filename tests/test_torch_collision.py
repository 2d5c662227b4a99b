"""The narrowphase and the contact layout: the port against the JAX
package's ``engine/collision.py``, float64 on the CPU.

Every ported pair type runs one seeded batch of poses and sizes through
the port's ``_narrow_fn`` and through the JAX function of the same name
under ``jax.vmap`` (one compile per pair type). The batch holds separated,
shallow, deep and coincident-centre cases. Both evaluate the same formulas
with the same fixed trip counts (Newton, the segment search, MPR's
discovery, refinement and polish, the alternating projection), so only
rounding differs: dist, pos and normal agree within ``PAIR_TOL``.

Then: the MuJoCo oracle cases of ``tests/test_convex.py`` on the port
(shallow overlap, its laddered tolerances); ``contacts()`` on the prims
scene against JAX's (slot order, the top-k cull, condim 3/4/6 rows, the
``geom_size`` overlay); the scenes of ``tests/test_condim.py`` stepped
against MuJoCo, and the capsule-ellipsoid depth sweep of
``tests/test_deep_penetration.py`` (also against JAX), copied here as
cases.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from torch_parity import (FIXTURE_NPZ, assert_close, fixture_xml, to_np)
from myosuite_mjx_tpu.engine import collision as jc
from myosuite_mjx_tpu.engine import data as jdata
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.engine import collision as tc
from myosuite_mjx_tpu_torch.engine import data as tdata
from myosuite_mjx_tpu_torch.engine import forward as tforward
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.engine.model import GeomType as T

# same formulas and trip counts in float64: rounding only
PAIR_TOL = dict(rtol=1e-9, atol=1e-12)
N_CASE = 16          # poses per regime
# the centre distance as a share of the summed extents along the offset:
# separated, shallow, deep; and coincident centres
REGIMES = (1.4, 0.93, 0.5, 0.0)
PAIRS = sorted(tc.PRIMITIVE)
# the reference's own sensitivity (see test_pair_matches_jax)
N_PERTURB = 8
PERTURB = 1e-12
ILL = 1e-7
# the types with a support map and a closest-point map
MAPPED = (T.SPHERE, T.CAPSULE, T.ELLIPSOID, T.CYLINDER, T.BOX)


def _pair_id(p):
  return f"{T(p[0]).name}-{T(p[1]).name}"


def _rot(rng, n):
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], -2)


def _sizes(rng, t, n):
  s = rng.uniform(0.01, 0.04, (n, 3))
  if t in (T.SPHERE,):
    s[:, 1:] = 0.0
  if t in (T.CAPSULE, T.CYLINDER):
    s[:, 2] = 0.0
  return s


def _extent(t, s, mat, u):
  """Support distance of a geom at the origin along world directions u."""
  d = np.einsum("nji,nj->ni", mat, u)          # local direction
  if t == T.SPHERE:
    return s[:, 0]
  if t == T.CAPSULE:
    return s[:, 0] + s[:, 1] * np.abs(d[:, 2])
  if t == T.ELLIPSOID:
    return np.linalg.norm(s * d, axis=-1)
  if t == T.CYLINDER:
    return s[:, 0] * np.linalg.norm(d[:, :2], axis=-1) + s[:, 1] * np.abs(
        d[:, 2])
  return (s * np.abs(d)).sum(-1)


def pair_cases(t1, t2, seed=0):
  """Poses and sizes (p1, m1, s1, p2, m2, s2) as numpy [N, ...]: N_CASE per
  regime of ``REGIMES``. A plane's pose sets its normal; geom2 sits along
  it (or along a random direction from geom1) at the regime's share of the
  summed extents."""
  rng = np.random.default_rng(seed)
  out = []
  for f in REGIMES:
    n = N_CASE
    m1, m2 = _rot(rng, n), _rot(rng, n)
    s1, s2 = _sizes(rng, t1, n), _sizes(rng, t2, n)
    p1 = rng.uniform(-0.05, 0.05, (n, 3))
    if t1 == T.PLANE:
      u = m1[:, :, 2]
      e = _extent(t2, s2, m2, -u)
      # a plane has no centre: the deep regime puts geom2's centre below
      off = {1.4: 1.4, 0.93: 0.93, 0.5: 0.3, 0.0: -0.4}[f] * e
    else:
      u = rng.normal(size=(n, 3))
      u /= np.linalg.norm(u, axis=-1, keepdims=True)
      off = f * (_extent(t1, s1, m1, u) + _extent(t2, s2, m2, -u))
    p2 = p1 + off[:, None] * u
    out.append((p1, m1, s1, p2, m2, s2))
  return tuple(np.concatenate(x) for x in zip(*out))


@functools.lru_cache(maxsize=None)
def _jax_pair(t1, t2):
  fn = jc._narrow_fn(t1, t2)

  def stacked(*args):
    pts = fn(*args)
    return (jnp.stack([p[0] for p in pts], -1),
            jnp.stack([p[1] for p in pts], -2),
            jnp.stack([p[2] for p in pts], -2))
  return jax.jit(jax.vmap(stacked))


def _port_pair(t1, t2, *args):
  dist, pos, n = tc._narrow_fn(t1, t2)(*(torch.as_tensor(a) for a in args))
  return dist, pos, n.expand(pos.shape)


def _lanes(x, n):
  return np.asarray(x).reshape(n, -1)


@pytest.mark.parametrize("pair", PAIRS, ids=_pair_id)
def test_pair_matches_jax(pair):
  """Lanes where the reference's answer is well conditioned agree within
  ``PAIR_TOL``. A lane is ill conditioned where one of ``N_PERTURB``
  copies of the batch with every input scaled by 1 + U(-PERTURB, PERTURB)
  moves JAX's answer by more than ``ILL``: the normal of a zero offset
  (coincident centres), a set-valued support (a box face, a cylinder rim)
  or the medial axis of a deep point, where rounding alone picks the
  branch. There the port's distance must stay within twice the spread of
  JAX's over the copies, and every output be finite."""
  cases = pair_cases(*pair)
  n = len(cases[0])
  jfn = _jax_pair(*pair)
  ref = [np.asarray(x) for x in jfn(*(jnp.asarray(a) for a in cases))]
  port = [to_np(x) for x in _port_pair(*pair, *cases)]
  assert port[0].shape == ref[0].shape
  rng = np.random.default_rng(1)
  near = []
  for _ in range(N_PERTURB):
    pert = [a * (1 + PERTURB * rng.uniform(-1, 1, a.shape)) for a in cases]
    near.append([np.asarray(x) for x in jfn(*(jnp.asarray(a) for a in pert))])
  moved = np.max([np.abs(_lanes(a, n) - _lanes(b, n)).max(-1)
                  for copy in near for a, b in zip(ref, copy)], axis=0)
  ok = moved <= ILL
  for a, b, what in zip(port, ref, ("dist", "pos", "normal")):
    assert_close(a[ok], b[ok], what=what, **PAIR_TOL)
    assert np.isfinite(a).all(), what
  dists = np.stack([ref[0]] + [copy[0] for copy in near])
  spread = dists.max(0) - dists.min(0)
  within = np.abs(port[0] - ref[0]) <= 2 * spread + 1e-12
  assert within[~ok].all(), np.where(~within)
  # separated lanes are always well conditioned; ill-conditioned lanes stay
  # a minority away from coincident centres; both sides of contact occur
  assert ok[:N_CASE].all() and ok[:3 * N_CASE].mean() >= 0.75
  assert (port[0][ok] > 0).any() and (port[0][ok] < 0).any()


def test_every_supported_pair_but_hfield_and_mesh_is_ported():
  # the heightfield pairs (tests/test_torch_hfield.py) and the mesh pairs
  # (tests/test_torch_mesh_hulls.py) are ported too: every supported pair
  want = set(jc._SUPPORTED)
  assert tc.PORTED == want and len(want) == 26
  assert tc.PRIMITIVE == {p for p in want
                          if T.HFIELD not in p and T.MESH not in p}
  assert len(tc.PRIMITIVE) == 20
  assert tc.MESH == {p for p in want if T.MESH in p} and len(tc.MESH) == 4
  # the slot counts of the reference
  assert sorted(tc._SUPPORTED) == sorted(jc._SUPPORTED)


@pytest.mark.parametrize("t", MAPPED, ids=lambda t: T(t).name)
def test_support_and_closest_maps_match_jax(t):
  rng = np.random.default_rng(int(t))
  n = 64
  s = _sizes(rng, t, n)
  d = rng.normal(size=(n, 3))
  d[:4] = [[0, 0, 1], [0, 0, -1], [1e-14, 0, 1], [0.0, 0.0, 0.0]]
  p = rng.normal(scale=0.03, size=(n, 3))
  p[:2] = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.02]]
  jsup = jax.vmap(jc._support_local(t))(jnp.asarray(s), jnp.asarray(d))
  psup = tc._support_local(t)(torch.as_tensor(s), torch.as_tensor(d))
  assert_close(psup, jsup, what="support", **PAIR_TOL)
  jcl = jax.vmap(jc._closest_surface_local(t))(jnp.asarray(s),
                                               jnp.asarray(p))
  pcl = tc._closest_surface_local(t)(torch.as_tensor(s), torch.as_tensor(p))
  for a, b, what in zip(pcl, jcl, ("surface", "normal", "dist")):
    assert_close(a, b, what=what, **PAIR_TOL)


def test_mpr_and_alternating_closest_match_jax():
  """MPR's hit flag, depth, normal and witness point, and the alternating
  projection, on their own (ellipsoid against cylinder: smooth against
  a rim), away from coincident centres."""
  pair = (T.ELLIPSOID, T.CYLINDER)
  cases = [a[:3 * N_CASE] for a in pair_cases(*pair, seed=5)]
  sup1, sup2 = (jc._support_local(t) for t in pair)
  tsup1, tsup2 = (tc._support_local(t) for t in pair)
  cl1, cl2 = (jc._closest_surface_local(t) for t in pair)
  tcl1, tcl2 = (tc._closest_surface_local(t) for t in pair)

  def jfn(p1, m1, s1, p2, m2, s2):
    def sup_m(d):
      x1 = p1 + m1 @ sup1(s1, m1.T @ (-d))
      x2 = p2 + m2 @ sup2(s2, m2.T @ d)
      return x2 - x1, x1, x2
    return (jc._mpr_penetration(sup_m, p2 - p1),
            jc._alternating_closest(cl1, cl2, p1, m1, s1, p2, m2, s2))

  jmpr, jalt = jax.jit(jax.vmap(jfn))(*(jnp.asarray(a) for a in cases))
  p1, m1, s1, p2, m2, s2 = (torch.as_tensor(a) for a in cases)

  def sup_m(d):
    x1 = p1 + tc._mv(m1, tsup1(s1, tc._mtv(m1, -d)))
    x2 = p2 + tc._mv(m2, tsup2(s2, tc._mtv(m2, d)))
    return x2 - x1, x1, x2

  pmpr = tc._mpr_penetration(sup_m, p2 - p1)
  palt = tc._alternating_closest(tcl1, tcl2, p1, m1, s1, p2, m2, s2)
  np.testing.assert_array_equal(to_np(pmpr[0]), np.asarray(jmpr[0]))
  hit = np.asarray(jmpr[0])
  assert hit.any() and (~hit).any()
  for a, b, what in zip(pmpr[1:], jmpr[1:], ("depth", "normal", "pos")):
    assert_close(to_np(a)[hit], np.asarray(b)[hit], what=what, **PAIR_TOL)
  for a, b, what in zip(palt, jalt, ("dist", "pos", "normal")):
    assert_close(to_np(a)[~hit], np.asarray(b)[~hit], what=what, **PAIR_TOL)


# ---------------------------------------------------------------------------
# the MuJoCo oracle cases of tests/test_convex.py, on the port
# ---------------------------------------------------------------------------

_TMAP = {"ellipsoid": T.ELLIPSOID, "cylinder": T.CYLINDER, "box": T.BOX}
ORACLE_SHAPES = [
    ("ellipsoid", [0.015, 0.015, 0.045]),
    ("ellipsoid", [0.007, 0.0055, 0.002]),   # fingertip pad scale
    ("cylinder", [0.013, 0.025, 0.0]),
    ("box", [0.017, 0.017, 0.017]),
    ("box", [0.023, 0.015, 0.02]),
    ("cylinder", [0.019, 0.04, 0.0]),
]
ORACLE_CASES = []
_rs = np.random.RandomState(11)
for _i, (_t1, _s1) in enumerate(ORACLE_SHAPES):
  for _t2, _s2 in ORACLE_SHAPES[_i:]:
    for _ in range(6):
      ORACLE_CASES.append((_t1, _s1, _t2, _s2, _rs.randint(0, 2**31)))


def _oracle_contact(type1, size1, type2, size2, pos2, quat2):
  """MuJoCo's deepest contact for geom1 at the origin, geom2 at pos2/quat2:
  (dist, pos, normal from geom1 into geom2), or None."""
  def geom(t, s):
    n = 2 if t == "cylinder" else 3
    return f'type="{t}" size="{" ".join(str(x) for x in s[:n])}"'

  xml = f"""
  <mujoco>
    <option><flag gravity="disable"/></option>
    <worldbody>
      <body name="b1"><geom name="g1" {geom(type1, size1)}/>
        <joint type="free"/></body>
      <body name="b2" pos="{pos2[0]} {pos2[1]} {pos2[2]}"
            quat="{quat2[0]} {quat2[1]} {quat2[2]} {quat2[3]}">
        <geom name="g2" {geom(type2, size2)}/>
        <joint type="free"/></body>
    </worldbody>
  </mujoco>"""
  m = mujoco.MjModel.from_xml_string(xml)
  d = mujoco.MjData(m)
  mujoco.mj_forward(m, d)
  if d.ncon == 0:
    return None
  k = int(np.argmin(d.contact.dist[:d.ncon]))
  c = d.contact
  n = c.frame[k][:3].copy()
  if int(m.geom_bodyid[c.geom1[k]]) != 1:
    n = -n
  return float(c.dist[k]), c.pos[k].copy(), n


def _port_convex(type1, size1, type2, size2, pos2, quat2):
  fn = tc._convex_convex_fn(_TMAP[type1], _TMAP[type2])
  R = np.zeros(9)
  mujoco.mju_quat2Mat(R, np.asarray(quat2, float))
  t = lambda x: torch.as_tensor(np.asarray(x, np.float64))[None]
  d, p, n = fn(t(np.zeros(3)), t(np.eye(3)), t(size1), t(pos2),
               t(R.reshape(3, 3)), t(size2))
  return float(d[0]), to_np(p[0]), to_np(n[0])


@pytest.mark.parametrize("t1,s1,t2,s2,seed", ORACLE_CASES)
def test_convex_pair_vs_mujoco_oracle(t1, s1, t2, s2, seed):
  """Shallow overlap (centres at 88-97% of the summed support extents),
  ``tests/test_convex.py``'s ladder: depth within 35% of the depth scale
  plus 5e-5, normals within cos 0.9 or pushing out along ours separates,
  position within half the larger minimum extent."""
  r = np.random.RandomState(seed)
  q = r.randn(4)
  q /= np.linalg.norm(q)
  dirn = r.randn(3)
  dirn /= np.linalg.norm(dirn)
  R = np.zeros(9)
  mujoco.mju_quat2Mat(R, np.asarray(q, float))
  R = R.reshape(3, 3)
  t = lambda x: torch.as_tensor(np.asarray(x, np.float64))
  e1 = float(np.dot(to_np(tc._support_local(_TMAP[t1])(t(s1), t(dirn))),
                    dirn))
  e2 = float(np.dot(R @ to_np(tc._support_local(_TMAP[t2])(
      t(s2), t(R.T @ -dirn))), -dirn))
  pos2 = dirn * r.uniform(0.88, 0.97) * (e1 + e2)
  oracle = _oracle_contact(t1, s1, t2, s2, pos2, q)
  d_m, p_m, n_m = _port_convex(t1, s1, t2, s2, pos2, q)
  if oracle is None:
    assert d_m > -2e-4, f"phantom contact {d_m}"
    return
  d_o, p_o, n_o = oracle
  if d_o > -1e-5:
    return  # grazing: both sides are noise
  assert abs(d_m - d_o) < 0.35 * max(-d_o, 1e-4) + 5e-5, (d_m, d_o)
  if float(np.dot(n_m, n_o)) <= 0.90:
    pushed = _oracle_contact(t1, s1, t2, s2,
                             pos2 + (abs(d_m) + 2e-4) * n_m, q)
    assert pushed is None or pushed[0] > -1e-4, (n_m, n_o, pushed)
  ext = lambda s: min(x for x in s if x > 0)
  assert np.linalg.norm(p_m - p_o) < 0.5 * max(ext(s1), ext(s2))


# ---------------------------------------------------------------------------
# the contact layout on the prims scene
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _prims():
  jm = jmodel.load_model(fixture_xml("prims"), dtype=np.float64)
  pm = tmodel.DeviceModel(tmodel.load_npz(FIXTURE_NPZ["prims"]),
                          torch.float64, "cpu")
  return jm, pm


def _prims_states(m, batch, seed):
  """Each free body moved by up to 1 cm and turned at random from qpos0,
  so that bodies overlap each other and the plane."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(np.asarray(m.qpos0), (batch, 1))
  for b in range(m.nq // 7):
    qpos[:, 7 * b:7 * b + 3] += rng.uniform(-0.01, 0.01, (batch, 3))
    q = qpos[:, 7 * b + 3:7 * b + 7] + 0.4 * rng.normal(size=(batch, 4))
    qpos[:, 7 * b + 3:7 * b + 7] = q / np.linalg.norm(q, axis=-1,
                                                      keepdims=True)
  return qpos


def _slot_order(geom1, geom2, dist):
  return np.stack([np.lexsort((g2, g1, di))
                   for g1, g2, di in zip(geom1, geom2, dist)])


@functools.lru_cache(maxsize=None)
def _jax_prims_contacts():
  jm, _ = _prims()
  return jax.jit(jax.vmap(lambda d: jc.contacts(
      jm, jforward.fwd_position(jm, d))))


@pytest.mark.parametrize("overlay", [False, True], ids=["nominal", "overlay"])
def test_prims_contacts_match_jax(overlay):
  """Every pair type of the scene in one contacts() call: the culled slots
  (compared in (dist, geom1, geom2) order, which no top-k tie order
  changes), their constraint rows for condim 3, 4 and 6, and ``dropped``;
  with ``overlay`` every geom's size is scaled per env. Slots where
  ``N_PERTURB`` copies of the state (qpos scaled by 1 + U(-PERTURB,
  PERTURB)) move JAX's dist by more than ``ILL`` are ill conditioned (see
  test_pair_matches_jax): there dist stays within twice JAX's spread."""
  jm, pm = _prims()
  B = 6
  qpos = _prims_states(jm, B, seed=3)
  d0 = jdata.make_data(jm, dtype=jnp.float64)
  jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
  # JAX always reads the sizes from the overlay (one compile); the port
  # reads its static tables when there is no overlay
  scale = (np.random.default_rng(4).uniform(0.8, 1.2, (B, jm.ngeom, 1))
           if overlay else np.ones((B, jm.ngeom, 1)))
  jd = jd.replace(qpos=jnp.asarray(qpos), overlay={
      "geom_size": jnp.asarray(np.asarray(jm.geom_size) * scale)})
  contacts = _jax_prims_contacts()
  jb, ji = contacts(jd)
  jd1 = jax.vmap(lambda d: jforward.fwd_position(jm, d))(jd)
  pd = tdata.data_from_numpy(jax.tree.map(np.asarray, jd1), "cpu")
  if not overlay:
    pd = pd.replace(overlay={})
  pb, pi = tc.contacts(pm, pd)

  spec = tc.collision_spec(pm)
  kinds = {tuple(g.types) for g in spec.groups}
  assert kinds == tc.PRIMITIVE and spec.condim == 6
  assert sorted(set(to_np(spec.itab[:, 4]).tolist())) == [3, 4, 6]
  assert spec.nslot > tc.DEFAULT_MAX_CONTACTS
  jo = _slot_order(to_np(ji.geom1), to_np(ji.geom2), to_np(ji.dist))
  po = _slot_order(to_np(pi.geom1), to_np(pi.geom2), to_np(pi.dist))
  take = lambda x, o: np.take_along_axis(
      to_np(x), o.reshape(o.shape + (1,) * (to_np(x).ndim - 2)), axis=1)
  ref_dist = take(ji.dist, jo)
  rng = np.random.default_rng(1)
  near = []
  for _ in range(N_PERTURB):
    _, jn = contacts(jd.replace(qpos=jnp.asarray(
        qpos * (1 + PERTURB * rng.uniform(-1, 1, qpos.shape)))))
    near.append(take(jn.dist, _slot_order(to_np(jn.geom1), to_np(jn.geom2),
                                          to_np(jn.dist))))
  near = np.stack(near)
  ok = np.abs(near - ref_dist).max(0) <= ILL                  # [B, k]
  spread = np.maximum(near.max(0), ref_dist) - np.minimum(near.min(0),
                                                          ref_dist)
  assert ok.mean() >= 0.9
  for f in ("dist", "pos", "frame", "friction", "solref", "solimp", "geom1",
            "geom2", "includemargin"):
    assert_close(take(getattr(pi, f), po)[ok], take(getattr(ji, f), jo)[ok],
                 what=f, **PAIR_TOL)
  port_dist = take(pi.dist, po)
  assert (np.abs(port_dist - ref_dist) <= 2 * spread + 1e-12)[~ok].all()
  k = jo.shape[1]
  rows = jb["J"].shape[1] // k
  assert rows == 10                  # condim 6: five pyramid pairs
  for f in ("J", "pos", "invweight", "solref", "solimp"):
    pr, jr = to_np(pb[f]), to_np(jb[f])
    pr = take(pr.reshape((B, k, rows) + pr.shape[2:]), po)
    jr = take(jr.reshape((B, k, rows) + jr.shape[2:]), jo)
    assert_close(pr[ok], jr[ok], what=f, **PAIR_TOL)
  assert_close(pb["dropped"], jb["dropped"], rtol=0, atol=0, what="dropped")
  assert (to_np(pi.dist) < 0).any()


# ---------------------------------------------------------------------------
# the scenes of tests/test_condim.py, stepped on the port against MuJoCo
# ---------------------------------------------------------------------------


def _condim_scene(condim, friction):
  return f"""
<mujoco><compiler angle="radian"/>
<option timestep="0.002"/>
<worldbody>
  <geom name="floor" type="plane" size="1 1 1" condim="{condim}"
        friction="{friction}"/>
  <body pos="0 0 0.0499">
    <freejoint/>
    <geom name="ball" type="sphere" size="0.05" mass="0.1"
          condim="{condim}" friction="{friction}"/>
  </body>
</worldbody></mujoco>"""


_PEN_LIKE = """
<mujoco><compiler angle="radian"/>
<option timestep="0.002"/>
<worldbody>
  <geom name="floor" type="plane" size="1 1 1"/>
  <body pos="0 0 0.0149">
    <freejoint/>
    <geom name="obj" type="ellipsoid" size="0.015 0.015 0.045"
          condim="4" density="1500" euler="0 1.5708 0"/>
  </body>
</worldbody></mujoco>"""

# (scene, steps, qvel0 index -> value, qpos atol), test_condim.py's cases
CONDIM_CASES = {
    "condim4_spindown": (_condim_scene(4, "1 0.05 0.0001"), 150, {5: 20.0},
                         1e-6),
    "condim3_spin": (_condim_scene(3, "1 0.05 0.0001"), 100, {5: 20.0}, 1e-6),
    "condim4_spin": (_condim_scene(4, "1 0.05 0.0001"), 100, {5: 20.0}, 1e-6),
    "condim6_rolling": (_condim_scene(6, "1 0.05 0.01"), 150,
                        {0: 0.5, 4: 10.0}, 1e-6),
    "condim4_ellipsoid_pen_like": (_PEN_LIKE, 100, {5: 10.0}, 5e-5),
}


@pytest.mark.parametrize("case", sorted(CONDIM_CASES))
def test_condim_scene_matches_mujoco(case):
  """The port's step against MuJoCo's: qpos within the case's atol, qvel
  within 100 times it (``tests/test_condim.py``'s bounds)."""
  xml, steps, v0, atol = CONDIM_CASES[case]
  mj = mujoco.MjModel.from_xml_string(xml)
  pm = tmodel.DeviceModel(tmodel.from_reference(jmodel.from_mj(mj)),
                          torch.float64, "cpu")
  qvel0 = np.zeros(6)
  for i, v in v0.items():
    qvel0[i] = v
  ref = mujoco.MjData(mj)
  ref.qvel[:] = qvel0
  d = tdata.make_data(pm, 1, torch.float64, "cpu")
  d = d.replace(qvel=torch.as_tensor(qvel0)[None])
  for _ in range(steps):
    mujoco.mj_step(mj, ref)
    d = tforward.step(pm, d)
  assert_close(d.qpos[0], ref.qpos, rtol=0, atol=atol, what="qpos")
  assert_close(d.qvel[0], ref.qvel, rtol=0, atol=atol * 100, what="qvel")
  if case == "condim4_spindown":
    assert abs(ref.qvel[5]) < 15.0       # the torsional row did work
  if case == "condim6_rolling":
    assert abs(ref.qvel[4]) < 9.0        # the rolling rows did work


def test_condim3_spin_persists_condim4_decays():
  out = {}
  for case in ("condim3_spin", "condim4_spin"):
    xml, steps, v0, _ = CONDIM_CASES[case]
    mj = mujoco.MjModel.from_xml_string(xml)
    pm = tmodel.DeviceModel(tmodel.from_reference(jmodel.from_mj(mj)),
                            torch.float64, "cpu")
    d = tdata.make_data(pm, 1, torch.float64, "cpu")
    qvel0 = torch.zeros(1, 6, dtype=torch.float64)
    qvel0[0, 5] = v0[5]
    d = d.replace(qvel=qvel0)
    for _ in range(steps):
      d = tforward.step(pm, d)
    out[case] = abs(float(d.qvel[0, 5]))
  assert out["condim3_spin"] > out["condim4_spin"] + 1.0


# ---------------------------------------------------------------------------
# the capsule-ellipsoid depth sweep of tests/test_deep_penetration.py
# ---------------------------------------------------------------------------


def _brute_capsule_ellipsoid(a, b, r1, radii, n_t=2001):
  """A dense scan over the capsule axis with 40-step projections."""
  ts = torch.linspace(0.0, 1.0, n_t, dtype=torch.float64)[:, None]
  pts = a[None] * (1 - ts) + b[None] * ts
  rr = radii.expand(n_t, 3)
  dists = tc._ellipsoid_proj(pts, rr, iters=40)[2]
  p = pts[int(torch.argmin(dists))]
  _, nl, dc, _ = tc._ellipsoid_proj(p[None], radii[None], iters=40)
  return float(dc[0]) - r1, -nl[0]


@pytest.mark.parametrize("depth_mm,tol_dist_mm,tol_n", [
    (0.2, 0.05, 0.05),   # dynamics-reachable: sub-millimetre
    (1.0, 0.10, 2.00),   # medial-axis normal conditioning
    (3.0, 0.35, 2.00),
    (8.0, 8.00, 2.00),   # pathological: bounded, not exact
])
def test_capsule_ellipsoid_depth_sweep(depth_mm, tol_dist_mm, tol_n):
  """The port's capsule-ellipsoid against a brute-force scan at controlled
  depths (24 orientations each), the reference test's envelope; and
  against JAX's ``_capsule_ellipsoid`` on the same 24 cases."""
  rng = np.random.default_rng(1)
  radii = np.asarray([0.012, 0.02, 0.008])
  r1, h1 = 0.006, 0.015
  g1p, g1m = [], []
  for _ in range(24):
    u = rng.normal(size=3)
    u /= np.linalg.norm(u)
    supp = float(1.0 / np.linalg.norm(u / radii))
    g1p.append(u * (supp + r1 - depth_mm * 1e-3))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    m1 = np.eye(3)
    m1[:, 2] = axis
    m1[:, 0] = np.cross([0.3, 0.9, 0.1] / np.linalg.norm([0.3, 0.9, 0.1]),
                        axis)
    m1[:, 0] /= np.linalg.norm(m1[:, 0])
    m1[:, 1] = np.cross(axis, m1[:, 0])
    g1m.append(m1)
  g1p, g1m = np.asarray(g1p), np.asarray(g1m)
  t = lambda x: torch.as_tensor(np.asarray(x, np.float64))
  n = len(g1p)
  args = (t(g1p), t(g1m), t(np.full(n, r1)), t(np.full(n, h1)),
          t(np.zeros((n, 3))), t(np.tile(np.eye(3), (n, 1, 1))),
          t(np.tile(radii, (n, 1))))
  d, pos, nrm = tc._capsule_ellipsoid(*args)
  a, b = tc._capsule_ends(args[0], args[1], args[3])
  worst_d = worst_n = 0.0
  for i in range(n):
    d_ref, n_ref = _brute_capsule_ellipsoid(a[i], b[i], r1, t(radii))
    worst_d = max(worst_d, abs(float(d[i]) - d_ref))
    worst_n = max(worst_n, float((nrm[i] - n_ref).abs().max()))
  assert worst_d < tol_dist_mm * 1e-3, (depth_mm, worst_d)
  assert worst_n < tol_n, (depth_mm, worst_n)
  jout = jax.vmap(lambda *x: jc._capsule_ellipsoid(*x)[0])(
      *(jnp.asarray(to_np(x)) for x in args))
  if depth_mm <= 0.2:
    for p_, j_, what in zip((d, pos, nrm), jout, ("dist", "pos", "normal")):
      assert_close(p_, j_, what=what, **PAIR_TOL)
  else:
    assert_close(d, jout[0], rtol=0, atol=tol_dist_mm * 1e-3, what="dist")


def test_deep_penetration_is_bounded_not_nan():
  """Capsule centres inside the ellipsoid stay finite, bounded and unit
  (one NaN would poison the whole batch of the masked solver)."""
  rng = np.random.default_rng(7)
  n = 40
  c = rng.normal(size=(n, 3)) * 0.003
  m = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(n)])
  t = lambda x: torch.as_tensor(np.asarray(x, np.float64))
  d, pos, nrm = tc._capsule_ellipsoid(
      t(c), t(m), t(np.full(n, 0.004)), t(np.full(n, 0.01)),
      t(np.zeros((n, 3))), t(np.tile(np.eye(3), (n, 1, 1))),
      t(np.tile([0.012, 0.04, 0.005], (n, 1))))
  for x in (d, pos, nrm):
    assert bool(torch.isfinite(x).all())
  assert float(d.abs().max()) < 0.2
  assert float((torch.linalg.vector_norm(nrm, dim=-1) - 1).abs().max()) < 1e-6
