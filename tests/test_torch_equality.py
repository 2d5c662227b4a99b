"""Equality rows: the port's joint and tendon couplings against the JAX
package, float64 on the CPU.

Two inline scenes:
- ``JOINT_XML``: a hinge chain with a slide coupled to a hinge by a quartic
  ``polycoef`` (the MyoLeg knee's form), a hinge coupled to another
  hinge, and a one-sided equality that holds a hinge at a constant;
- ``TENDON_XML``: spatial tendons, one coupled to another by a quadratic,
  one held at a constant length (one-sided), and a joint coupling between
  the two tendon rows, so that the rows' model order interleaves the two
  kinds.

Rows: J, aref, D, pos and is_eq of ``make_efc`` on random states, within
rtol 1e-10 (one stage, same formulas); then 50 substeps of ``step``
against JAX's, within rtol 1e-8 (Newton on the same system: rounding
amplified by the condition of H, as ``test_torch_engine.py``'s rollout).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_close, jax_batch, port_batch, to_np
from myosuite_mjx_tpu.engine import constraint as jconstraint
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.engine import constraint, forward
from myosuite_mjx_tpu_torch.engine import model as tmodel

B = 6
STAGE = dict(rtol=1e-10, atol=1e-12)
ROLLOUT = dict(rtol=1e-8, atol=1e-9)

JOINT_XML = """<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="h1" axis="0 1 0" damping="0.2" range="-1 1"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="1"/>
      <body name="b" pos="0.3 0 0">
        <joint name="h2" axis="0 1 0" damping="0.1"/>
        <joint name="s2" type="slide" axis="1 0 0" damping="2"/>
        <geom type="capsule" fromto="0 0 0 0.25 0 0" size="0.025" mass="0.7"/>
        <body name="c" pos="0.25 0 0">
          <joint name="h3" axis="1 0 0" damping="0.05"/>
          <joint name="h4" axis="0 0 1" damping="0.05"/>
          <geom type="sphere" size="0.04" mass="0.3"/>
        </body>
      </body>
    </body>
  </worldbody>
  <equality>
    <joint joint1="s2" joint2="h2" polycoef="0.01 0.012 -0.006 0.0012 -0.0001"/>
    <joint joint1="h4" joint2="h1" polycoef="0 -0.5 0.2 0 0" solref="0.01 1"/>
    <joint joint1="h3" polycoef="0.15 0 0 0 0"/>
  </equality>
  <actuator>
    <motor joint="h1" gear="4"/>
    <motor joint="h2" gear="3"/>
  </actuator>
</mujoco>"""

TENDON_XML = """<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <site name="o1" pos="0 0.05 1.1"/>
    <site name="o2" pos="0 -0.05 1.1"/>
    <site name="o3" pos="0.1 0 1.1"/>
    <body name="a" pos="0 0 1">
      <joint name="h1" axis="0 1 0" damping="0.2"/>
      <joint name="h2" axis="1 0 0" damping="0.2"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03" mass="1"/>
      <site name="i1" pos="0.2 0.03 0.02"/>
      <site name="i2" pos="0.25 -0.03 0.02"/>
      <body name="b" pos="0.3 0 0">
        <joint name="h3" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.025" mass="0.5"/>
        <site name="i3" pos="0.1 0 0.03"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t1"><site site="o1"/><site site="i1"/></spatial>
    <spatial name="t2"><site site="o2"/><site site="i2"/></spatial>
    <spatial name="t3"><site site="o3"/><site site="i3"/></spatial>
  </tendon>
  <equality>
    <tendon tendon1="t1" tendon2="t2" polycoef="0.002 1.2 0.3 0 0"/>
    <joint joint1="h3" joint2="h2" polycoef="0 0.4 0 0 0"/>
    <tendon tendon1="t3" polycoef="0.004 0 0 0 0" solref="0.01 1"/>
  </equality>
  <actuator>
    <motor joint="h1" gear="4"/>
    <motor joint="h2" gear="2"/>
  </actuator>
</mujoco>"""

SCENES = {"joint": JOINT_XML, "tendon": TENDON_XML}


@functools.lru_cache(maxsize=None)
def _models(name: str):
  jm = jmodel.load_model(SCENES[name], dtype=np.float64)
  return jm, tmodel.DeviceModel(tmodel.from_reference(jm), torch.float64,
                                "cpu")


def _states(jm, seed: int = 0):
  """Random joint states away from the couplings (rows violated both
  ways) with random controls."""
  rng = np.random.default_rng(seed)
  return (rng.uniform(-0.6, 0.6, (B, jm.nq)), rng.normal(0, 1.0, (B, jm.nv)),
          np.zeros((B, jm.na)), rng.uniform(-1, 1, (B, jm.nu)),
          np.zeros((B, jm.nv)))


def test_scenes_have_both_kinds_of_rows():
  jm, pm = _models("joint")
  spec = constraint.eq_spec(pm)
  assert spec.n == 3 and spec.tendon is None and spec.order is None
  jm, pm = _models("tendon")
  spec = constraint.eq_spec(pm)
  assert spec.n == 3 and spec.joint is not None and spec.tendon is not None
  # joint rows first, then tendon rows, back to model order
  np.testing.assert_array_equal(to_np(spec.order), [1, 0, 2])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_equality_rows_match_jax(name):
  jm, pm = _models(name)
  jd = jax_batch(jm, *_states(jm))
  jd = jax.vmap(lambda d: jforward.fwd_position(jm, d))(jd)
  pd = forward.fwd_position(pm, port_batch(jd))
  jout = jax.vmap(lambda d: jconstraint.make_efc(jm, d, None)[:5])(jd)
  J, aref, D, is_eq, pos, meta = constraint.make_efc(pm, pd, None)
  for port, ref, what in zip((J, aref, D, pos), (jout[0], jout[1], jout[2],
                                                 jout[4]),
                             ("J", "aref", "D", "pos")):
    assert_close(port, ref, what=what, **STAGE)
  np.testing.assert_array_equal(to_np(is_eq), to_np(jout[3])[0])
  n_eq = int(to_np(is_eq).sum())
  assert n_eq == 3 and meta["jl_offset"] == n_eq
  # an equality row is active whatever its sign
  eq_pos = to_np(pos[:, :n_eq])
  assert (eq_pos > 0).any() and (eq_pos < 0).any()
  assert (to_np(D[:, :n_eq]) > 0).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_rollout_matches_jax(name):
  """50 substeps from the random states: the couplings pull the joints
  onto their curves."""
  jm, pm = _models(name)
  jd = jax_batch(jm, *_states(jm, seed=1))
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  violation = jax.jit(jax.vmap(lambda d: jconstraint.make_efc(
      jm, jforward.fwd_position(jm, d), None)[4][:3]))
  before = np.abs(np.asarray(violation(jd))).mean()
  pd = port_batch(jd)
  for _ in range(50):
    jd = jstep(jd)
    pd = forward.step(pm, pd)
  for f in ("qpos", "qvel", "qacc", "qfrc_constraint"):
    assert_close(getattr(pd, f), getattr(jd, f), what=f, **ROLLOUT)
  # the couplings have pulled the joints toward their curves
  assert np.abs(np.asarray(violation(jd))).mean() < 0.5 * before


def test_other_equality_types_stay_refused():
  xml = """<mujoco><worldbody><body name="a"><freejoint/><geom size=".1"/>
      </body></worldbody><equality><connect body1="a" anchor="0 0 0"/>
      </equality></mujoco>"""
  jm = jmodel.load_model(xml, dtype=np.float64)
  with pytest.raises(NotImplementedError, match="equality type 0"):
    jd = jax_batch(jm, *[np.zeros((1, n)) for n in
                         (jm.nq, jm.nv, jm.na, jm.nu, jm.nv)])
    jax.vmap(functools.partial(jforward.step, jm))(jd)
  with pytest.raises(NotImplementedError, match="equality type 0"):
    tmodel.DeviceModel(tmodel.from_reference(jm), torch.float64, "cpu")


def test_disabled_equality_drops_the_rows():
  jm, pm = _models("joint")
  pd = forward.fwd_position(pm, port_batch(jax_batch(jm, *_states(jm))))
  h = pm.host
  off = tmodel.Model(**{**h.__dict__, "opt": tmodel.Option(**{
      **h.opt.__dict__, "disableflags": h.opt.disableflags
      | tmodel.DSBL_EQUALITY})})
  pm_off = tmodel.DeviceModel(off, torch.float64, "cpu")
  J_on = constraint.make_efc(pm, pd, None)[0]
  J_off = constraint.make_efc(pm_off, pd, None)[0]
  assert J_on.shape[1] == J_off.shape[1] + 3
  assert_close(J_on[:, 3:], J_off, rtol=0, atol=0)
