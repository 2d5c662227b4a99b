"""Engine parity: each ported stage against its JAX function on hand11.

The JAX side runs under ``jax.vmap`` in float64 on the CPU; the port runs
the same float64 inputs as a written-out batch. Both evaluate the same
formulas in nearly the same order, so single stages agree to ~1e-12;
tolerances below are stated per comparison with the reason.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, jax_batch, jax_model, port_batch,
                          port_model, random_states, to_np)
from myosuite_mjx_tpu.engine import collision as jcollision
from myosuite_mjx_tpu.engine import constraint as jconstraint
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import muscle as jmuscle
from myosuite_mjx_tpu.engine import smooth as jsmooth
from myosuite_mjx_tpu.engine import solver as jsolver
from myosuite_mjx_tpu.engine import tendon as jtendon
from myosuite_mjx_tpu.ops import quat as jquat
from myosuite_mjx_tpu_torch.engine import collision, constraint, forward
from myosuite_mjx_tpu_torch.engine import muscle, smooth, solver, tendon
from myosuite_mjx_tpu_torch.ops import quat

B = 8
# one stage, same formulas, float64: only summation order differs
STAGE = dict(rtol=1e-10, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _setup(seed: int = 0):
  jm = jax_model(2)
  pm = port_model(2)
  jd = jax_batch(jm, *random_states(jm, B, seed))
  return jm, pm, jd


def _vmap(fn, *args):
  return jax.vmap(fn)(*args)


@functools.lru_cache(maxsize=None)
def _jax_kinematics():
  jm, _, jd = _setup()
  jkin = _vmap(lambda q: jsmooth.kinematics(jm, q, jnp.zeros((0, 3)),
                                            jnp.zeros((0, 4))), jd.qpos)
  return jkin, _vmap(lambda kk: jsmooth.com_pos(jm, kk), jkin)


def _fields(port_d, jax_d, names, tol=STAGE):
  for f in names:
    assert_close(getattr(port_d, f), getattr(jax_d, f), what=f, **tol)


def test_fixture_state_has_contacts_and_limits():
  jm, pm, jd = _setup()
  d = forward.forward(pm, port_batch(jd))
  assert (d.contact.dist < 0).any(), "no active contact in the test states"
  spec = constraint.limit_spec(pm)
  q = d.qpos[:, spec.jl_qadr]
  assert ((q < spec.jl_lo) | (q > spec.jl_hi)).any(), "no violated limit"


def test_quat_ops():
  rng = np.random.default_rng(1)
  q = rng.normal(size=(5, 4))
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  q2 = rng.normal(size=(5, 4))
  v = rng.normal(size=(5, 3))
  ang = rng.normal(size=(5,))
  axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
  t = torch.as_tensor
  cases = [
      (quat.quat_mul(t(q), t(q2)), jquat.quat_mul(q, q2), "quat_mul"),
      (quat.quat_rotate(t(q), t(v)), jquat.quat_rotate(q, v), "quat_rotate"),
      (quat.quat_to_mat(t(q)), jquat.quat_to_mat(q), "quat_to_mat"),
      (quat.axis_angle_to_quat(t(axis), t(ang)),
       jquat.axis_angle_to_quat(axis, ang), "axis_angle_to_quat"),
      (quat.normalize(t(q2)), jquat.normalize(q2), "normalize"),
  ]
  for port, ref, what in cases:
    assert_close(port, ref, rtol=1e-13, atol=1e-15, what=what)


def test_kinematics_com_crb_rne():
  jm, pm, jd = _setup()
  pd = port_batch(jd)
  jkin, jcom = _jax_kinematics()
  kin = smooth.kinematics(pm, pd.qpos)
  for k in jkin:
    assert_close(kin[k], jkin[k], what=k, **STAGE)
  com = smooth.com_pos(pm, kin)
  for port, ref, what in zip(com, jcom, ("subtree_com", "cinert", "cdof")):
    assert_close(port, ref, what=what, **STAGE)
  assert_close(smooth.crb(pm, com[1], com[2]),
               _vmap(lambda ci, cd: jsmooth.crb(jm, ci, cd), jcom[1], jcom[2]),
               what="qM", **STAGE)
  jvel = _vmap(lambda cd, qv: jsmooth.com_vel(jm, cd, qv), jcom[2], jd.qvel)
  vel = smooth.com_vel(pm, com[2], pd.qvel)
  assert_close(vel[0], jvel[0], what="cvel", **STAGE)
  assert_close(vel[1], jvel[1], what="cdof_dot", **STAGE)
  jbias = _vmap(lambda ci, cd, cdd, cv, qv: jsmooth.rne(jm, ci, cd, cdd, cv, qv),
                jcom[1], jcom[2], jvel[1], jvel[0], jd.qvel)
  assert_close(smooth.rne(pm, com[1], com[2], vel[1], vel[0], pd.qvel), jbias,
               what="qfrc_bias", **STAGE)


def test_tendon_lengths_and_moments():
  jm, pm, jd = _setup()
  pd = port_batch(jd)
  jkin, (_, _, jcdof) = _jax_kinematics()
  jlen, jJ = _vmap(lambda kk, cd: jtendon.tendon(jm, kk, cd), jkin, jcdof)
  kin = smooth.kinematics(pm, pd.qpos)
  ln, J = tendon.tendon(pm, kin, smooth.com_pos(pm, kin)[2])
  # the wrap Newton (inside wrap) and arctan2 chains: a few ulps more
  assert_close(ln, jlen, rtol=1e-10, atol=1e-12, what="ten_length")
  assert_close(J, jJ, rtol=1e-9, atol=1e-12, what="ten_J")
  spec = tendon.tendon_spec(pm)
  kinds = {(g.geom_type, g.inside, g.has_side) for g in spec.wrap_groups}
  assert kinds == {(2, False, False), (2, False, True), (5, False, True),
                   (5, True, True)}, kinds


def test_muscle_curves_on_a_grid():
  rng = np.random.default_rng(2)
  n = 4000
  length = rng.uniform(0.03, 0.2, n)
  vel = rng.uniform(-0.5, 0.5, n)
  lr = np.stack([rng.uniform(0.05, 0.09, n), rng.uniform(0.1, 0.15, n)], -1)
  acc0 = rng.uniform(1.0, 50.0, n)
  prm = np.stack([np.full(n, 0.75), np.full(n, 1.05),
                  np.where(rng.uniform(size=n) < 0.2, -1.0,
                           rng.uniform(5, 50, n)),
                  np.full(n, 200.0), np.full(n, 0.5), np.full(n, 1.6),
                  np.full(n, 1.5), np.full(n, 1.3), np.full(n, 1.2)], -1)
  ctrl = rng.uniform(-0.2, 1.2, n)
  act = rng.uniform(-0.1, 1.1, n)
  dyn = np.stack([np.full(n, 0.01), np.full(n, 0.04),
                  np.where(rng.uniform(size=n) < 0.5, 0.0, 0.3)], -1)
  t = torch.as_tensor
  tol = dict(rtol=1e-12, atol=1e-12)   # elementwise, same formulas
  assert_close(muscle.muscle_gain(t(length), t(vel), t(lr), t(acc0), t(prm)),
               jmuscle.muscle_gain(length, vel, lr, acc0, prm),
               what="gain", **tol)
  assert_close(muscle.muscle_bias(t(length), t(lr), t(acc0), t(prm)),
               jmuscle.muscle_bias(length, lr, acc0, prm), what="bias", **tol)
  assert_close(muscle.muscle_dynamics(t(ctrl), t(act), t(dyn)),
               jmuscle.muscle_dynamics(ctrl, act, dyn), what="dyn", **tol)


def test_transmission_actuation_passive():
  jm, pm, jd = _setup()
  jd1 = _vmap(lambda d: jforward.fwd_velocity(
      jm, jforward.fwd_position(jm, d)), jd)
  pd1 = forward.fwd_velocity(pm, forward.fwd_position(pm, port_batch(jd)))
  _fields(pd1, jd1, ("ten_length", "ten_J", "actuator_length",
                     "actuator_moment", "ten_velocity", "actuator_velocity",
                     "qM"), tol=dict(rtol=1e-9, atol=1e-12))
  ja = _vmap(lambda d: jforward.fwd_passive(jm, jforward.fwd_actuation(jm, d)),
             jd1)
  pa = forward.fwd_passive(pm, forward.fwd_actuation(pm, port_batch(jd1)))
  _fields(pa, ja, ("actuator_force", "qfrc_actuator", "act_dot",
                   "qfrc_passive"))


@functools.lru_cache(maxsize=None)
def _pre_constraint():
  """JAX Data after the smooth stages, and the port's copy of it."""
  jm, _, jd = _setup()
  jd = _vmap(lambda d: jforward.fwd_acceleration(jm, jforward.fwd_passive(
      jm, jforward.fwd_actuation(jm, jforward.fwd_velocity(
          jm, jforward.fwd_position(jm, d))))), jd)
  return jd, port_batch(jd)


def _slot_order(geom1, geom2, dist):
  """Per-env slot order by (dist, geom1, geom2): equal under any top-k
  tie order."""
  return np.stack([np.lexsort((g2, g1, di))
                   for g1, g2, di in zip(geom1, geom2, dist)])


@pytest.mark.parametrize("max_contacts", [None, 2])
def test_contacts(max_contacts):
  jm, pm, jd = _setup()
  jd, pd = _pre_constraint()
  jb, ji = _vmap(lambda d: jcollision.contacts(jm, d, max_contacts), jd)
  pb, pi = collision.contacts(pm, pd, max_contacts)
  jo = _slot_order(to_np(ji.geom1), to_np(ji.geom2), to_np(ji.dist))
  po = _slot_order(to_np(pi.geom1), to_np(pi.geom2), to_np(pi.dist))
  take = lambda x, o: np.take_along_axis(
      to_np(x), o.reshape(o.shape + (1,) * (to_np(x).ndim - 2)), axis=1)
  for f in ("dist", "pos", "frame", "friction", "solref", "solimp", "geom1",
            "geom2", "includemargin"):
    assert_close(take(getattr(pi, f), po), take(getattr(ji, f), jo), what=f,
                 **STAGE)
  k = jo.shape[1]
  rows = jb["J"].shape[1] // k
  for f in ("J", "pos", "invweight", "solref", "solimp"):
    pr, jr = to_np(pb[f]), to_np(jb[f])
    pr = pr.reshape((B, k, rows) + pr.shape[2:])
    jr = jr.reshape((B, k, rows) + jr.shape[2:])
    assert_close(take(pr, po), take(jr, jo), what=f, **STAGE)
  assert_close(pb["dropped"], jb["dropped"], rtol=0, atol=0, what="dropped")
  if max_contacts is not None:
    assert to_np(pb["dropped"]).sum() > 0, "the cull dropped nothing"


def test_make_efc_and_newton():
  jm, pm, jd = _setup()
  jd, pd = _pre_constraint()

  def jefc(d):
    blocks, _ = jcollision.contacts(jm, d)
    J, aref, D, is_eq, pos, meta = jconstraint.make_efc(jm, d, blocks)
    qacc, force, niter = jsolver._newton_solve(
        jm, d, J, aref, D, is_eq, int(jm.opt.solver_iterations),
        int(jm.opt.ls_iterations))
    return J, aref, D, pos, qacc, force, niter

  jout = _vmap(jefc, jd)
  blocks, _ = collision.contacts(pm, pd)
  J, aref, D, is_eq, pos, _ = constraint.make_efc(pm, pd, blocks)
  for port, ref, what in zip((J, aref, D, pos), jout[:4],
                             ("J", "aref", "D", "pos")):
    assert_close(port, ref, what=what, **STAGE)
  qacc, force, niter = solver._newton_solve(
      pm, pd, J, aref, D, is_eq, int(pm.opt.solver_iterations),
      int(pm.opt.ls_iterations))
  # Newton on the same system: the iterates agree to rounding, amplified by
  # the condition of H (stiff contact rows) -> relative 1e-8
  assert_close(qacc, jout[4], rtol=1e-8, atol=1e-8, what="qacc")
  assert_close(force, jout[5], rtol=1e-8, atol=1e-8, what="force")
  np.testing.assert_array_equal(to_np(niter), to_np(jout[6]))


_FORWARD_FIELDS = (
    "xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
    "site_xpos", "site_xmat", "geom_xpos", "geom_xmat", "subtree_com",
    "cinert", "cdof", "ten_length", "ten_J", "actuator_length",
    "actuator_moment", "qM", "qLD", "cvel", "cdof_dot", "ten_velocity",
    "actuator_velocity", "qfrc_bias", "actuator_force", "qfrc_actuator",
    "qfrc_passive", "qfrc_smooth", "qacc_smooth", "qfrc_constraint", "qacc",
    "qacc_warmstart", "act_dot", "contact_force", "contact_force_vec",
    "efc_force_limit", "ne_active", "ncon_dropped")


def test_full_forward():
  jm, pm, jd = _setup()
  jf = _vmap(lambda d: jforward.forward(jm, d), jd)
  pf = forward.forward(pm, port_batch(jd))
  # after the Newton solve: relative 1e-8 as in test_make_efc_and_newton
  _fields(pf, jf, _FORWARD_FIELDS, tol=dict(rtol=1e-8, atol=1e-8))
  assert (to_np(pf.ne_active) > 0).any()


def test_step_rollout_with_contacts_and_limits():
  """20 physics steps from states with active contacts and limits."""
  jm, pm, jd = _setup()
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  pd = port_batch(jd)
  saw_contact = saw_limit = False
  for i in range(20):
    jd = jstep(jd)
    pd = forward.step(pm, pd, full_data=True)
    saw_contact |= bool((to_np(pd.ne_active) > 0).any())
    saw_limit |= bool((np.abs(to_np(pd.efc_force_limit)) > 0).any())
  # 20 contact-rich steps: rounding differences grow through the stiff
  # contact and limit rows; 1e-6 relative still pins the trajectory
  tol = dict(rtol=1e-6, atol=1e-7)
  for f in ("qpos", "qvel", "act", "time", "qacc", "qacc_warmstart"):
    assert_close(getattr(pd, f), getattr(jd, f), what=f, **tol)
  assert saw_contact and saw_limit


def test_step_full_data_false_keeps_carry_exact():
  """Substeps without the diagnostics give the same carry as full ones."""
  _, pm, jd = _setup()
  a = b = port_batch(jd)
  for _ in range(3):
    a = forward.step(pm, a, full_data=False)
    b = forward.step(pm, b, full_data=True)
  for f in ("qpos", "qvel", "act", "time", "qacc", "qacc_warmstart"):
    assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_unported_pair_type_raises():
  from myosuite_mjx_tpu.engine.model import load_model
  xml = """<mujoco><worldbody><geom type="plane" size="1 1 .1"/>
    <body pos="0 0 .1"><joint type="slide" axis="0 0 1"/>
    <geom type="box" size=".05 .05 .05"/></body></worldbody></mujoco>"""
  from myosuite_mjx_tpu_torch.engine.model import DeviceModel, from_reference
  dm = DeviceModel(from_reference(load_model(xml)), torch.float64)
  with pytest.raises(NotImplementedError, match="PLANE-BOX"):
    collision.collision_spec(dm)
