"""Inverse kinematics (``utils/ik.py``) and ``engine/smooth.point_jacobian``:
the port against the JAX package on hand11's fingertip sites, float64.

The JAX IK tests load their scene from the MyoSuite asset tree, which the
repository does not hold, so the port is held against JAX ``ik`` here on
the hand11 fixture: for a batch of targets taken from feasible joint
configurations, each env's qpos within 1e-8 of JAX's single-target
solution (``vmap`` of it), and the same ``steps`` and ``success`` per
target; with a rotation target and with a joint mask too. The two solve
the damped normal equations differently (the port by Cholesky through
``ops/linalg.spd_solve``, JAX by LU), which is rounding at 1e-12 per step;
1e-8 leaves room for that over up to 200 iterations.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myosuite_mjx_tpu.engine import smooth as jsmooth
from myosuite_mjx_tpu.ops import quat as jquat
from myosuite_mjx_tpu.utils import ik as jik
from myosuite_mjx_tpu_torch.engine import smooth as tsmooth
from myosuite_mjx_tpu_torch.utils import ik as tik

from torch_parity import jax_model, port_model, to_np

QPOS_TOL = 1e-8
SITES = ("IFtip", "THtip")


@pytest.fixture(scope="module")
def models():
  return jax_model(2), port_model(2)


def _jax_site_pose(m, qpos, sid):
  kin = jsmooth.kinematics(
      m, qpos, jnp.zeros((m.nmocap, 3), qpos.dtype),
      jnp.tile(jquat.quat_identity(dtype=qpos.dtype), (m.nmocap, 1)))
  return kin["site_xpos"][sid], kin["site_xmat"][sid]


def _goals(m, batch: int, seed: int, lo_frac=0.2, hi_frac=0.8):
  rng = np.random.default_rng(seed)
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  return lo + rng.uniform(lo_frac, hi_frac, (batch, m.nq)) * (hi - lo)


def _targets(m, goals, site: str):
  sid = m.name2id("site", site)
  pos, mat = jax.vmap(lambda q: _jax_site_pose(m, q, sid))(jnp.asarray(goals))
  return np.asarray(pos), np.asarray(jax.vmap(jquat.mat_to_quat)(mat))


def _compare(res_port, res_jax, tol=QPOS_TOL):
  np.testing.assert_allclose(to_np(res_port.qpos), np.asarray(res_jax.qpos),
                             rtol=0, atol=tol)
  np.testing.assert_array_equal(to_np(res_port.steps),
                                np.asarray(res_jax.steps))
  np.testing.assert_array_equal(to_np(res_port.success),
                                np.asarray(res_jax.success))


@pytest.mark.parametrize("site", SITES)
def test_point_jacobian_matches_jax(models, site):
  jm, pm = models
  goals = _goals(jm, 6, seed=11)
  sid = jm.name2id("site", site)
  body = int(jm.site_bodyid[sid])

  def jac(q):
    kin = jsmooth.kinematics(jm, q, jnp.zeros((jm.nmocap, 3)),
                             jnp.tile(jquat.quat_identity(), (jm.nmocap, 1)))
    _, _, cdof = jsmooth.com_pos(jm, kin)
    return jsmooth.point_jacobian(jm, cdof, kin["site_xpos"][sid], body)

  jp, jr = jax.vmap(jac)(jnp.asarray(goals))
  q = torch.as_tensor(goals)
  kin = tsmooth.kinematics(pm, q)
  _, _, cdof = tsmooth.com_pos(pm, kin)
  pp, pr = tsmooth.point_jacobian(pm, cdof, kin["site_xpos"][:, sid], body)
  np.testing.assert_allclose(to_np(pp), np.asarray(jp), rtol=1e-12,
                             atol=1e-14)
  np.testing.assert_allclose(to_np(pr), np.asarray(jr), rtol=1e-12,
                             atol=1e-14)


@pytest.mark.parametrize("site", SITES)
def test_ik_position_target_matches_jax(models, site):
  jm, pm = models
  tpos, _ = _targets(jm, _goals(jm, 8, seed=0), site)
  solve = jax.jit(jax.vmap(lambda t: jik.qpos_from_site_pose(
      jm, site, target_pos=t, tol=1e-8, max_steps=200)))
  rj = solve(jnp.asarray(tpos))
  rp = tik.qpos_from_site_pose(pm, site, target_pos=torch.as_tensor(tpos),
                               tol=1e-8, max_steps=200)
  _compare(rp, rj)
  assert bool(rp.success.all()), to_np(rp.err_norm)


# IFtip's six joints past pro_sup: with a rotation target the damped
# normal equations are square (6 rows, 6 dofs)
IF_SIX = ("deviation", "flexion", "mcp2_flexion", "mcp2_abduction",
          "pm2_flexion", "md2_flexion")


def _rotation_targets(jm, seed: int):
  """Poses of IFtip from feasible configurations that keep pro_sup at
  qpos0, so the six joints of IF_SIX reach them."""
  goals = _goals(jm, 6, seed=seed, lo_frac=0.3, hi_frac=0.7)
  pro_sup = int(jm.jnt_qposadr[jm.name2id("joint", "pro_sup")])
  goals[:, pro_sup] = jm.qpos0[pro_sup]
  return _targets(jm, goals, "IFtip")


def _solve_rotation(jm, pm, tpos, tquat, joint_names):
  solve = jax.jit(jax.vmap(lambda p, q: jik.qpos_from_site_pose(
      jm, "IFtip", target_pos=p, target_quat=q, joint_names=joint_names,
      tol=1e-8, max_steps=300)))
  rj = solve(jnp.asarray(tpos), jnp.asarray(tquat))
  rp = tik.qpos_from_site_pose(pm, "IFtip", target_pos=torch.as_tensor(tpos),
                               target_quat=torch.as_tensor(tquat),
                               joint_names=joint_names, tol=1e-8,
                               max_steps=300)
  return rp, rj


def test_ik_rotation_target_matches_jax(models):
  jm, pm = models
  tpos, tquat = _rotation_targets(jm, seed=3)
  rp, rj = _solve_rotation(jm, pm, tpos, tquat, IF_SIX)
  _compare(rp, rj)
  assert bool(rp.success.all()), to_np(rp.err_norm)
  np.testing.assert_allclose(to_np(rp.err_norm), np.asarray(rj.err_norm),
                             rtol=0, atol=QPOS_TOL)


def test_ik_redundant_rotation_target_matches_jax(models):
  """All seven joints of IFtip's chain for six constraints: a one-dof null
  space that the 1e-10 floor of reg barely damps, so J^T J + reg I has a
  condition near 1e10 and the two factorizations leave that component of
  qpos apart by up to cond x eps ~ 1e-6 (measured 5.5e-7). The steps, the
  success and the error norm per target still agree, as does the pose."""
  jm, pm = models
  tpos, tquat = _rotation_targets(jm, seed=3)
  rp, rj = _solve_rotation(jm, pm, tpos, tquat, None)
  _compare(rp, rj, tol=2e-6)
  np.testing.assert_allclose(to_np(rp.err_norm), np.asarray(rj.err_norm),
                             rtol=0, atol=QPOS_TOL)


def test_ik_joint_mask_matches_jax_and_freezes_other_dofs(models):
  jm, pm = models
  names = [jm.id2name("joint", j) for j in range(jm.njnt)]
  allowed = names[-3:]
  tpos, _ = _targets(jm, _goals(jm, 5, seed=1, lo_frac=0.3, hi_frac=0.7),
                     "IFtip")
  rng = np.random.default_rng(9)
  lo, hi = jm.jnt_range[:, 0], jm.jnt_range[:, 1]
  q0 = lo + rng.uniform(0.4, 0.6, (5, jm.nq)) * (hi - lo)
  solve = jax.jit(jax.vmap(lambda t, q: jik.qpos_from_site_pose(
      jm, "IFtip", target_pos=t, qpos0=q, joint_names=allowed,
      max_steps=50)))
  rj = solve(jnp.asarray(tpos), jnp.asarray(q0))
  rp = tik.qpos_from_site_pose(pm, "IFtip", target_pos=torch.as_tensor(tpos),
                               qpos0=torch.as_tensor(q0),
                               joint_names=allowed, max_steps=50)
  _compare(rp, rj)
  frozen = [int(jm.jnt_qposadr[jm.name2id("joint", n)])
            for n in names if n not in allowed]
  np.testing.assert_array_equal(to_np(rp.qpos)[:, frozen], q0[:, frozen])
  np.testing.assert_array_equal(tik._dof_mask(pm, allowed),
                                jik._dof_mask(jm, allowed))


def test_ik_batch_lanes_equal_single_targets(models):
  """Envs that finish early are frozen: a batch of one target each equals
  the batch, env by env (steps differ between envs)."""
  jm, pm = models
  tpos, _ = _targets(jm, _goals(jm, 4, seed=2, lo_frac=0.25, hi_frac=0.75),
                     "IFtip")
  rb = tik.qpos_from_site_pose(pm, "IFtip", target_pos=torch.as_tensor(tpos),
                               tol=1e-8, max_steps=200)
  assert len(set(to_np(rb.steps).tolist())) > 1
  for i in range(4):
    r1 = tik.qpos_from_site_pose(pm, "IFtip",
                                 target_pos=torch.as_tensor(tpos[i:i + 1]),
                                 tol=1e-8, max_steps=200)
    assert int(r1.steps[0]) == int(rb.steps[i])
    np.testing.assert_allclose(to_np(r1.qpos)[0], to_np(rb.qpos)[i],
                               rtol=0, atol=1e-13)


def test_ik_needs_a_target(models):
  with pytest.raises(ValueError):
    tik.qpos_from_site_pose(models[1], "IFtip")


def test_nullspace_method_matches_jax_and_reference_algebra():
  """Batch-first against JAX under vmap at a damping that conditions the
  3 x 5 system's normal equations (cond <= 1e3: 1e-8 relative); at reg 0
  the floor 1e-10 leaves them at cond ~1e10, where the two factorizations
  differ by ~1e-6, so there both must solve J dq = delta instead."""
  rng = np.random.default_rng(4)
  jac = rng.standard_normal((6, 3, 5))
  delta = rng.standard_normal((6, 3))
  jnp_call = lambda reg: jax.vmap(lambda j, d: jik.nullspace_method(
      j, d, regularization_strength=reg))(jnp.asarray(jac),
                                          jnp.asarray(delta))
  for reg in (3e-2, 1e-2):
    got = tik.nullspace_method(torch.as_tensor(jac), torch.as_tensor(delta),
                               regularization_strength=reg)
    np.testing.assert_allclose(to_np(got), np.asarray(jnp_call(reg)),
                               rtol=1e-8, atol=1e-10)
  got = to_np(tik.nullspace_method(torch.as_tensor(jac),
                                   torch.as_tensor(delta)))
  for dq in (got, np.asarray(jnp_call(0.0))):
    np.testing.assert_allclose(np.einsum("bij,bj->bi", jac, dq), delta,
                               rtol=0, atol=1e-6)
  hess = jac[0].T @ jac[0] + np.eye(5) * 3e-2
  expected = np.linalg.solve(hess, jac[0].T @ delta[0])
  got = tik.nullspace_method(torch.as_tensor(jac[:1]),
                             torch.as_tensor(delta[:1]),
                             regularization_strength=3e-2)
  np.testing.assert_allclose(to_np(got)[0], expected, atol=1e-10)
