"""Mesh hulls: the port's mesh pairs against the JAX package's
``engine/collision.py``, float64 on the CPU.

- ``_closest_on_tri`` on points in every region of seeded triangles, and
  the hull geometry (outward winding, face equations) of the checked-in
  scenes;
- each mesh pair (plane, sphere, capsule and ellipsoid against a hull) on
  seeded poses, separated, shallow, deep and centred inside the hull,
  through the port's ``_mesh_fn`` and JAX's ``_mesh_narrow_fn`` under
  ``jax.vmap``. Both run the same formulas and trip counts (the capsule's
  32 golden-section trips), so only rounding differs. Where rounding picks
  the branch (a triangle's region, inside against outside, the deepest
  face, ties among the lowest vertices) PR 7's ill-lane rule applies, as
  in ``tests/test_torch_collision.py``: a lane is ill conditioned when one
  of ``N_PERTURB`` copies of the batch with every input scaled by
  1 + U(-1e-12, 1e-12) moves JAX's answer by more than 1e-7; the other
  lanes agree within ``PAIR_TOL`` (rtol 1e-9, atol 1e-12), ill lanes'
  distance within twice JAX's spread;
- the slot layout of a scene with two meshes (groups sorted by the mesh of
  geom2, as the reference's key (t1, t2, dataid)) and its narrowphase
  slot by slot;
- the ``hulls`` fixture in dynamics: ``Physics.step`` against JAX's
  ``forward.step`` for ``ROLLOUT_STEPS`` substeps, within ``ROLLOUT``
  (rtol 1e-8, atol 1e-9, as the free-joint rollout);
- a mesh whose hull has no triangles is refused when the model loads.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FIXTURE_NPZ, assert_close, fixture_xml, to_np
from myosuite_mjx_tpu.engine import collision as jc
from myosuite_mjx_tpu.engine import data as jdata
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.assets import fixtures
from myosuite_mjx_tpu_torch.engine import api
from myosuite_mjx_tpu_torch.engine import collision as tc
from myosuite_mjx_tpu_torch.engine import data as tdata
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.engine.model import GeomType as T

PAIR_TOL = dict(rtol=1e-9, atol=1e-12)
ROLLOUT = dict(rtol=1e-8, atol=1e-9)
ROLLOUT_STEPS = 40
N_CASE = 16
# centre offset as a share of the summed support extents: separated,
# shallow, deep, and geom1's centre well inside the hull
REGIMES = (1.4, 0.93, 0.5, 0.1)
N_PERTURB = 8
PERTURB = 1e-12
ILL = 1e-7
MESH_PAIRS = sorted(tc.MESH)


def _pair_id(p):
  return f"{T(p[0]).name}-{T(p[1]).name}"


@functools.lru_cache(maxsize=None)
def _hulls():
  jm = jmodel.load_model(fixture_xml("hulls"), dtype=np.float64)
  pm = tmodel.DeviceModel(tmodel.load_npz(FIXTURE_NPZ["hulls"]),
                          torch.float64, "cpu")
  return jm, pm


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


def _extent(t, s, mat, u):
  d = np.einsum("nji,nj->ni", mat, u)
  if t == T.SPHERE:
    return s[:, 0]
  if t == T.CAPSULE:
    return s[:, 0] + s[:, 1] * np.abs(d[:, 2])
  return np.linalg.norm(s * d, axis=-1)


def mesh_cases(t1, verts, seed=0):
  """(p1, m1, s1, p2, m2, s2) numpy [N, ...] for geom1 of type ``t1``
  against a hull with vertices ``verts`` (geom2): N_CASE per regime."""
  rng = np.random.default_rng(seed)
  out = []
  for f in REGIMES:
    n = N_CASE
    m1, m2 = _rot(rng, n), _rot(rng, n)
    s1 = rng.uniform(0.005, 0.02, (n, 3))
    if t1 == T.SPHERE:
      s1[:, 1:] = 0.0
    if t1 == T.CAPSULE:
      s1[:, 1] = rng.uniform(0.01, 0.05, n)
      s1[:, 2] = 0.0
    s2 = np.zeros((n, 3))
    p2 = rng.uniform(-0.05, 0.05, (n, 3))
    if t1 == T.PLANE:
      u = -m1[:, :, 2]                       # from the plane up to the hull
      hull = (np.einsum("nij,vj->nvi", m2, verts) * -u[:, None]).sum(-1)
      share = {1.4: 1.4, 0.93: 0.93, 0.5: 0.3, 0.1: -0.4}[f]
      p1 = p2 + share * hull.max(-1)[:, None] * u
    else:
      u = rng.normal(size=(n, 3))
      u /= np.linalg.norm(u, axis=-1, keepdims=True)
      hull = (np.einsum("nij,vj->nvi", m2, verts) * u[:, None]).sum(-1)
      off = f * (hull.max(-1) + _extent(t1, s1, m1, -u))
      p1 = p2 + off[:, None] * u
    out.append((p1, m1, s1, p2, m2, s2))
  return tuple(np.concatenate(x) for x in zip(*out))


@functools.lru_cache(maxsize=None)
def _jax_mesh(t1):
  jm, _ = _hulls()
  fn = jc._mesh_narrow_fn(jm, t1, 0, jnp.float64)

  def stacked(*args):
    pts = fn(*args)
    return (jnp.stack([p[0] for p in pts], -1),
            jnp.stack([p[1] for p in pts], -2),
            jnp.stack([p[2] for p in pts], -2))
  return jax.jit(jax.vmap(stacked))


def _port_mesh(t1, *args):
  _, pm = _hulls()
  dist, pos, n = tc._mesh_fn(t1, tc._hull(pm, 0))(
      *(torch.as_tensor(a) for a in args))
  return dist, pos, n.expand(pos.shape)


def _lanes(x, n):
  return np.asarray(x).reshape(n, -1)


def test_closest_on_triangle_matches_jax():
  """Points in all seven regions of seeded triangles (and degenerate
  triangles: a repeated vertex, collinear vertices)."""
  rng = np.random.default_rng(0)
  n = 512
  a, b, c = (rng.normal(size=(n, 3)) for _ in range(3))
  c[:8] = a[:8]
  b[8:16] = 0.5 * (a[8:16] + c[8:16])
  # barycentric draws far outside the triangle reach every region
  w = rng.uniform(-1.5, 2.5, (n, 3))
  p = (w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c) / w.sum(-1,
                                                           keepdims=True)
  p += 0.3 * rng.normal(size=(n, 3))
  ref = np.asarray(jax.jit(jax.vmap(jc._closest_on_tri))(
      *(jnp.asarray(x) for x in (p, a, b, c))))
  port = to_np(tc._closest_on_tri(*(torch.as_tensor(x)
                                    for x in (p, a, b, c))))
  assert_close(port, ref, **PAIR_TOL)
  # the closest point is no farther than any vertex
  d = np.linalg.norm(port - p, axis=-1)
  for v in (a, b, c):
    assert (d <= np.linalg.norm(v - p, axis=-1) + 1e-12).all()


@pytest.mark.parametrize("name", ["hulls", "relocate5"])
def test_hull_geometry_matches_jax(name):
  jm = jmodel.load_model(fixture_xml(name), dtype=np.float64)
  pm = tmodel.load_npz(FIXTURE_NPZ[name])
  assert sorted(pm.mesh_hull_tris) == sorted(jm.mesh_hull_tris)
  for mid in jm.mesh_hull_tris:
    tris, eqs = tc.hull_geometry(pm, mid)
    jtris, jeqs = jc._hull_geometry(jm, mid)
    assert_close(tris, jtris, rtol=0, atol=0, what="tris")
    assert_close(eqs, jeqs, rtol=0, atol=0, what="eqs")
    # every vertex lies inside every face's half space
    verts = np.asarray(pm.mesh_hull_verts[mid])
    assert (verts @ eqs[:, :3].T + eqs[:, 3] <= 1e-12).all()


@pytest.mark.parametrize("pair", MESH_PAIRS, ids=_pair_id)
def test_mesh_pair_matches_jax(pair):
  """See the module note for the ill-lane rule."""
  jm, _ = _hulls()
  t1 = pair[0]
  cases = mesh_cases(t1, np.asarray(jm.mesh_hull_verts[0]), seed=int(t1))
  n = len(cases[0])
  jfn = _jax_mesh(t1)
  ref = [np.asarray(x) for x in jfn(*(jnp.asarray(a) for a in cases))]
  port = [to_np(x) for x in _port_mesh(t1, *cases)]
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
  # separated lanes are well conditioned; both sides of contact occur
  assert ok[:N_CASE].mean() >= 0.9 and ok.mean() >= 0.75
  assert (port[0][ok] > 0).any() and (port[0][ok] < 0).any()


def test_point_hull_inside_and_outside_match_jax():
  """``_point_hull`` alone on points inside the hull (the deepest-face
  branch) and outside it."""
  jm, pm = _hulls()
  verts = np.asarray(jm.mesh_hull_verts[0])
  rng = np.random.default_rng(5)
  w = rng.dirichlet(np.ones(len(verts)), 64)
  inside = w @ verts
  outside = inside + rng.normal(scale=0.05, size=inside.shape)
  p = np.concatenate([inside, outside])
  tris, eqs = jc._hull_geometry(jm, 0)
  ref = jax.jit(jax.vmap(lambda x: jc._point_hull(x, jnp.asarray(tris),
                                                  jnp.asarray(eqs))))(
      jnp.asarray(p))
  hull = tc._hull(pm, 0)
  port = tc._point_hull(torch.as_tensor(p), hull.tris, hull.eqs)
  for a, b, what in zip(port, ref, ("surf", "n", "dist")):
    assert_close(a, b, what=what, **PAIR_TOL)
  assert (to_np(port[2])[:64] < 0).all()
  dist = to_np(tc._point_hull_dist(torch.as_tensor(p), hull.tris, hull.eqs))
  # the search's distance alone is the full query's, bit for bit
  assert_close(dist, port[2], rtol=0, atol=0, what="dist alone")


# two meshes: "wedge" has mesh id 0 but its geom comes after the slab's,
# so the reference's key (t1, t2, mesh id) puts its groups first
TWO_MESH_XML = f"""<mujoco>
  <asset>
    <mesh name="wedge" vertex="0 0 0 .06 0 0 0 .05 0 0 0 .04 .05 .04 .03"/>
    <mesh name="slab" vertex="{" ".join(
        " ".join(str(x) for x in v) for v in fixtures._SLAB_VERTS)}"/>
  </asset>
  <worldbody>
    <geom type="plane" size="1 1 .1"/>
    <body pos="0 0 .03"><freejoint/><geom type="mesh" mesh="slab"/></body>
    <body pos=".1 0 .02"><freejoint/><geom type="mesh" mesh="wedge"/></body>
    <body pos=".04 .01 .06"><freejoint/>
      <geom type="sphere" size=".012"/>
      <geom type="capsule" size=".008 .02" pos="0 .03 0" euler="0 1.2 0"/>
    </body>
    <body pos=".08 .02 .05"><freejoint/>
      <geom type="ellipsoid" size=".02 .012 .009"/>
    </body>
  </worldbody>
</mujoco>"""


def test_two_meshes_slot_layout_matches_jax():
  jm = jmodel.load_model(TWO_MESH_XML, dtype=np.float64)
  pm = tmodel.DeviceModel(tmodel.from_reference(jm), torch.float64, "cpu")
  jspec = jc._build_collision_spec(jm)
  spec = tc.collision_spec(pm)
  jkeys = [(tuple(int(t) for t in types), g["dataid"])
           for types, g in jspec.groups]
  dataid = lambda g: (int(pm.host.geom_dataid[int(g.g2[0])])
                      if g.hull is not None else -1)
  keys = [(tuple(g.types), dataid(g)) for g in spec.groups]
  assert keys == jkeys
  # both meshes collide with each primitive type, in mesh-id order
  mesh_keys = [k for k in keys if k[0][1] == T.MESH]
  assert [k[1] for k in mesh_keys if k[0][0] == T.SPHERE] == [0, 1]
  assert {k[0] for k in mesh_keys} == tc.MESH
  for (_, g), pg in zip(jspec.groups, spec.groups):
    np.testing.assert_array_equal(to_np(pg.g1), g["g1"])
    np.testing.assert_array_equal(to_np(pg.g2), g["g2"])
  for col, name in enumerate(("body1", "body2", "geom1", "geom2",
                              "condim_slot")):
    np.testing.assert_array_equal(to_np(spec.itab[:, col]),
                                  getattr(jspec, name), err_msg=name)
  assert_close(spec.ftab[:, 12], jspec.invweight, rtol=1e-15, atol=0)
  # the narrowphase of every slot on perturbed states
  B = 5
  rng = np.random.default_rng(2)
  qpos = np.tile(np.asarray(jm.qpos0), (B, 1))
  for b in range(jm.nq // 7):
    qpos[:, 7 * b:7 * b + 3] += rng.uniform(-0.01, 0.01, (B, 3))
    q = qpos[:, 7 * b + 3:7 * b + 7] + 0.3 * rng.normal(size=(B, 4))
    qpos[:, 7 * b + 3:7 * b + 7] = q / np.linalg.norm(q, axis=-1,
                                                      keepdims=True)
  d0 = jdata.make_data(jm, dtype=jnp.float64)
  jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
  jd = jax.vmap(lambda d: jforward.fwd_position(jm, d))(
      jd.replace(qpos=jnp.asarray(qpos)))
  ref = jax.vmap(lambda d: jc.narrowphase_all(jm, d, jspec))(jd)
  pd = tdata.data_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
  port = tc.narrowphase_all(pm, pd, spec)
  for a, b, what in zip(port, ref, ("dist", "pos", "normal")):
    assert_close(a, b, what=what, **PAIR_TOL)
  assert (to_np(port[0]) < 0).any()


def test_hulls_rollout_matches_jax_step():
  """The hulls fixture from the checked-in file through ``Physics``: the
  three small bodies drop onto the slab (every mesh pair in dynamics)."""
  jm, _ = _hulls()
  phys = api.Physics(tmodel.load_npz(FIXTURE_NPZ["hulls"]), torch.float64,
                     "cpu")
  B = 3
  rng = np.random.default_rng(0)
  qpos = np.tile(np.asarray(jm.qpos0), (B, 1))
  for b in range(jm.nq // 7):
    qpos[:, 7 * b:7 * b + 3] += rng.uniform(-0.003, 0.003, (B, 3))
  d0 = jdata.make_data(jm, dtype=jnp.float64)
  jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
  jd = jd.replace(qpos=jnp.asarray(qpos), overlay={})
  pd = tdata.data_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  spec = tc.collision_spec(phys.device_model)
  touching = {tuple(g.types): False for g in spec.groups
              if g.hull is not None}
  assert set(touching) == tc.MESH
  for _ in range(ROLLOUT_STEPS):
    jd = jstep(jd)
    pd = phys.step(pd)
    for g in spec.groups:
      if g.hull is not None:
        dist, _, _ = tc.group_fn(g, pd)(
            pd.geom_xpos[:, g.g1], pd.geom_xmat[:, g.g1],
            g.size1.expand(B, -1, -1), pd.geom_xpos[:, g.g2],
            pd.geom_xmat[:, g.g2], g.size2.expand(B, -1, -1))
        touching[tuple(g.types)] |= bool((dist < 0).any())
  for f in ("qpos", "qvel", "qacc", "qfrc_constraint", "xpos"):
    assert_close(getattr(pd, f), getattr(jd, f), what=f, **ROLLOUT)
  assert all(touching.values()), touching


def test_empty_hull_is_refused_at_load():
  """A colliding mesh whose hull has no triangles (what the reference's
  compiler keeps for a flat mesh) is refused with a message."""
  jm, _ = _hulls()
  m = tmodel.from_reference(jm)
  m.mesh_hull_tris = {0: np.zeros((0, 3, 3))}
  with pytest.raises(ValueError, match="no triangles"):
    tmodel.DeviceModel(m, torch.float64, "cpu")
