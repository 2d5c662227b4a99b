"""Heightfield contacts: the port's pair functions and the hfield overlay
against the JAX package, float64 on the CPU.

The pair functions run on seeded lanes: a 12 x 15 field of seeded
heights under a turned and shifted geom frame; spheres and capsules of
1-4 cm, a quarter each separated, shallow, deep and centred on a cell
boundary (both grid coordinates whole numbers), and some past the field's
edge (the clip at n - 1.001). Where the geometry is smooth the lanes agree
within rtol 1e-9, atol 1e-12 (one formula, rounding only). On a cell
boundary rounding picks the cell: there ``test_pair_functions_match_jax``
applies the ill-lane rule of ``test_torch_collision.py``. The heights
come either as the model's (one field) or as a per-lane overlay.

Then JAX's overlay scene (``tests/test_heightfields.py``): a sphere
dropped on a flat and on a raised field comes to rest at 0.05 and at
0.25; the port against JAX after 300 substeps within 1e-9 (contact
dynamics at rest, as the engine rollouts).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, jax_batch, port_batch, to_np
from myosuite_mjx_tpu.engine import collision as jc
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.engine import collision as tc
from myosuite_mjx_tpu_torch.engine import forward
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.engine.model import GeomType as T

PAIR = dict(rtol=1e-9, atol=1e-12)
# the ill-lane rule of test_torch_collision.py, with 32 copies: on a cell
# corner both grid coordinates are ambiguous, four cells in all, and 8
# copies miss one of them one time in ten
N_PERTURB = 32
PERTURB = 1e-12
ILL = 1e-7
NROW, NCOL = 12, 15
SIZE = (0.6, 0.45, 0.3)
N_CASE = 64


def _rot(rng, n):
  """Random rotation matrices [n, 3, 3] (QR of gaussian matrices)."""
  q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
  return q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]


def _lanes(t2: int, seed: int = 0):
  """(heights [N], per-lane heights [n, N], field pos and frame, geom pos,
  frame and size) for ``t2`` against the field."""
  rng = np.random.default_rng(seed)
  n = 4 * N_CASE
  heights = rng.uniform(0.0, 1.0, NROW * NCOL)
  per_lane = rng.uniform(0.0, 1.0, (n, NROW * NCOL))
  yaw = 0.7
  fmat = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                   [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
  fpos = np.array([0.1, -0.2, 0.05])
  sx, sy, sz = SIZE
  # local xy: anywhere over the field and 10% past its edges
  lx = rng.uniform(-1.1 * sx, 1.1 * sx, n)
  ly = rng.uniform(-1.1 * sy, 1.1 * sy, n)
  # the last quarter on a cell corner
  k = slice(3 * N_CASE, None)
  lx[k] = -sx + rng.integers(0, NCOL, N_CASE) * 2 * sx / (NCOL - 1)
  ly[k] = -sy + rng.integers(0, NROW, N_CASE) * 2 * sy / (NROW - 1)
  size = np.zeros((n, 3))
  size[:, 0] = rng.uniform(0.01, 0.04, n)
  if t2 == T.CAPSULE:
    size[:, 1] = rng.uniform(0.01, 0.04, n)
  # height over the surface: separated, shallow, deep, any
  lift = np.concatenate([rng.uniform(1.2, 2.0, N_CASE),
                         rng.uniform(0.7, 1.0, N_CASE),
                         rng.uniform(-0.5, 0.3, N_CASE),
                         rng.uniform(-0.5, 1.5, N_CASE)])
  lz = sz * 0.5 + lift * size[:, 0]
  local = np.stack([lx, ly, lz], -1)
  gpos = fpos + local @ fmat.T
  return (heights, per_lane, np.broadcast_to(fpos, (n, 3)),
          np.broadcast_to(fmat, (n, 3, 3)), gpos, _rot(rng, n), size)


def _jax_pair(t2, heights, fpos, fmat, gpos, gmat, size, per_lane):
  sx, sy, sz = SIZE

  def one(h, p1, m1, p2, m2, s2):
    data = h.reshape(NROW, NCOL)
    if t2 == T.SPHERE:
      pts = jc._sphere_hfield(p2, s2[0], p1, m1, data, sx, sy, sz)
    else:
      pts = jc._capsule_hfield(p2, m2, s2[0], s2[1], p1, m1, data, sx, sy,
                               sz)
    return tuple(jnp.stack([pt[i] for pt in pts]) for i in range(3))

  axes = (0 if per_lane else None, 0, 0, 0, 0, 0)
  return jax.vmap(one, in_axes=axes)(*map(jnp.asarray, (
      heights, fpos, fmat, gpos, gmat, size)))


@pytest.mark.parametrize("per_lane", (False, True), ids=("model", "overlay"))
@pytest.mark.parametrize("t2", (T.SPHERE, T.CAPSULE), ids=lambda t: T(t).name)
def test_pair_functions_match_jax(t2, per_lane):
  """The ill-lane rule of ``test_torch_collision.py``, per contact point:
  a point is ill conditioned where one of ``N_PERTURB`` copies of the
  batch with every input scaled by 1 + U(-PERTURB, PERTURB) moves JAX's
  answer by more than ``ILL``. On a cell boundary rounding alone picks the cell, and with it
  the slope that sets the normal (the height itself is continuous). There
  the port's distance must stay within twice the spread of JAX's over the
  copies. Ill points occur only on the corner quarter."""
  heights, lanes, fpos, fmat, gpos, gmat, size = _lanes(t2, int(t2))
  h = lanes if per_lane else heights
  cases = (h, fpos, fmat, gpos, gmat, size)
  ref = [np.asarray(x) for x in _jax_pair(t2, *cases[:-1], size, per_lane)]
  field = tc._HField(adr=0, nrow=NROW, ncol=NCOL, size=SIZE,
                     heights=torch.as_tensor(h))
  t = lambda x: torch.as_tensor(np.array(x))
  port = [to_np(x) for x in tc._hfield_fn(int(t2), t(h), field)(
      t(fpos), t(fmat), t(np.zeros_like(size)), t(gpos), t(gmat), t(size))]
  n, npts = 4 * N_CASE, 1 if t2 == T.SPHERE else 3
  assert port[0].shape == (n, npts)
  rng = np.random.default_rng(1)
  near = []
  for _ in range(N_PERTURB):
    pert = [a * (1 + PERTURB * rng.uniform(-1, 1, np.shape(a)))
            for a in cases]
    near.append([np.asarray(x) for x in _jax_pair(t2, *pert[:-1], pert[-1],
                                                  per_lane)])
  # per contact point [n, P]: each output's largest move over the copies
  per_point = lambda x: np.broadcast_to(x, (n, npts, 3)) if np.ndim(x) == 3 \
      else np.asarray(x)[..., None]
  moved = np.max([np.abs(per_point(a) - per_point(b)).max(-1)
                  for copy in near for a, b in zip(ref, copy)], axis=0)
  ok = moved <= ILL
  for a, b, what in zip(port, ref, ("dist", "pos", "normal")):
    assert_close(per_point(a)[ok], per_point(b)[ok], what=what, **PAIR)
    assert np.isfinite(a).all(), what
  dists = np.stack([ref[0]] + [copy[0] for copy in near])
  spread = dists.max(0) - dists.min(0)
  within = np.abs(port[0] - ref[0]) <= 2 * spread + 1e-12
  assert within[~ok].all(), np.where(~within)
  # off the boundaries every point is well conditioned; a sphere centred
  # on a boundary mostly is not
  assert ok[:3 * N_CASE].all()
  assert t2 != T.SPHERE or not ok[3 * N_CASE:].all()
  assert (port[0][ok] > 0).any() and (port[0][ok] < 0).any()


def test_cell_boundary_and_edge_lanes():
  """The corner lanes sit on whole grid coordinates and some lanes lie past
  the edge, where the clip at n - 1.001 holds them in the last cell."""
  heights, _, fpos, fmat, gpos, gmat, size = _lanes(T.SPHERE)
  local = np.einsum("nji,nj->ni", fmat, gpos - fpos)
  sx, sy, _ = SIZE
  gx = (local[:, 0] + sx) / (2 * sx) * (NCOL - 1)
  gy = (local[:, 1] + sy) / (2 * sy) * (NROW - 1)
  corner = slice(3 * N_CASE, None)
  assert np.abs(gx[corner] - np.round(gx[corner])).max() < 1e-9
  assert (gx < 0).any() and (gx > NCOL - 1).any() and (gy > NROW - 1).any()


def test_hfield_pairs_are_ported():
  assert {(T.HFIELD, T.SPHERE), (T.HFIELD, T.CAPSULE)} <= tc.PORTED
  # the mesh pairs are ported too (tests/test_torch_mesh_hulls.py)
  assert {p for p in tc.PORTED if T.MESH in p} == tc.MESH
  assert len(tc.MESH) == 4


OVERLAY_XML = """
  <mujoco><option timestep="0.002"/>
  <asset><hfield name="hf" nrow="20" ncol="20" size="0.5 0.5 0.2 0.05"/></asset>
  <worldbody>
    <geom name="terrain" type="hfield" hfield="hf"/>
    <body pos="0 0 0.4"><freejoint/><geom type="sphere" size="0.05" mass="0.1"/></body>
  </worldbody></mujoco>"""


def test_overlay_scene_rests_where_jax_does():
  """JAX's overlay scene: env 0 on a flat field, env 1 on a field raised
  to its full height (0.2); 300 substeps."""
  jm = jmodel.load_model(OVERLAY_XML, dtype=np.float64)
  pm = tmodel.DeviceModel(tmodel.from_reference(jm), torch.float64, "cpu")
  zeros = lambda n: np.zeros((2, n))
  jd = jax_batch(jm, zeros(jm.nq) + jm.qpos0, zeros(jm.nv), zeros(jm.na),
                 zeros(jm.nu), zeros(jm.nv))
  jd = jd.replace(overlay={"hfield_data": jnp.asarray(
      np.stack([np.zeros(400), np.ones(400)]))})
  pd = port_batch(jd)
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  for _ in range(300):
    jd = jstep(jd)
    pd = forward.step(pm, pd)
  for f in ("qpos", "qvel"):
    assert_close(getattr(pd, f), getattr(jd, f), rtol=0, atol=1e-9, what=f)
  z = to_np(pd.qpos[:, 2])
  assert abs(z[0] - 0.05) < 0.01 and abs(z[1] - 0.25) < 0.01


def test_unported_mesh_pair_names_its_roadmap_item():
  xml = """<mujoco><asset><mesh name="tet" vertex="0 0 0 .05 0 0 0 .05 0
      0 0 .05"/></asset><worldbody><geom type="plane" size="1 1 .1"/>
      <body pos="0 0 .1"><joint type="slide" axis="0 0 1"/>
      <geom type="mesh" mesh="tet"/></body></worldbody></mujoco>"""
  dm = tmodel.DeviceModel(
      tmodel.from_reference(jmodel.load_model(xml, dtype=np.float64)),
      torch.float64, "cpu")
  # the mesh pairs are ported: the scene builds one plane-mesh group on
  # the tetrahedron's hull (4 triangles), with the reference's 4 slots
  spec = tc.collision_spec(dm)
  (g,) = spec.groups
  assert tuple(g.types) == (T.PLANE, T.MESH) and spec.nslot == 4
  assert g.hull.tris.shape == (4, 3, 3) and g.hull.verts.shape == (4, 3)
  # what is refused is a hull without triangles, naming the mesh
  m = tmodel.from_reference(jmodel.load_model(xml, dtype=np.float64))
  m.mesh_hull_tris = {0: np.zeros((0, 3, 3))}
  with pytest.raises(ValueError, match="mesh 0 .*no triangles"):
    tmodel.DeviceModel(m, torch.float64, "cpu")
