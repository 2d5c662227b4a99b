"""Ball and free joints and mocap bodies: the port's smooth stages,
``Physics`` and the model check against the JAX package.

Two scenes: the ``free10`` fixture (a hinge-ball chain, a free body that
lands on a plane and a bar, the bar on a mocap body) and the JAX tests'
``MIXED_XML`` (slide, hinge and ball on one chain, and a free box). States
are drawn as ``tests/test_smooth.py`` draws them (hinge and slide in range,
random unit quaternions, free positions around the origin), with random
velocities and mocap poses set on both sides (the reference's
``make_data`` starts mocap bodies at the origin, not at the body). The JAX
side runs under ``jax.vmap`` in float64 on the CPU.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_smooth import MIXED_XML
from torch_parity import FREE_NPZ, assert_close, jax_batch, port_batch
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu.engine import smooth as jsmooth
from myosuite_mjx_tpu_torch.assets.fixtures import free_fixture_xml
from myosuite_mjx_tpu_torch.engine import api, forward, smooth
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.engine.model import JointType

B = 6
# one stage, same formulas, float64: only summation order differs
STAGE = dict(rtol=1e-10, atol=1e-12)
# 50 substeps through contacts, float64 (as the env rollout's bound)
ROLLOUT = dict(rtol=1e-8, atol=1e-9)
ROLLOUT_STEPS = 50
# where the bar lies on the plane
BAR_POS = (0.0, 0.0, 0.015)


@functools.lru_cache(maxsize=None)
def _models(scene: str):
  xml = free_fixture_xml() if scene == "free10" else MIXED_XML
  jm = jmodel.load_model(xml, dtype=np.float64)
  pm = (tmodel.load_npz(FREE_NPZ) if scene == "free10"
        else tmodel.from_reference(jm))
  return jm, tmodel.DeviceModel(pm, torch.float64, "cpu")


def _random_states(m, seed: int):
  """qpos [B, nq] and qvel [B, nv] as tests/test_smooth.py:42 draws them."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(m.qpos0, (B, 1))
  for j in range(m.njnt):
    adr, jt = int(m.jnt_qposadr[j]), int(m.jnt_type[j])
    if jt in (JointType.HINGE, JointType.SLIDE):
      lo, hi = m.jnt_range[j]
      qpos[:, adr] = (rng.uniform(lo, hi, B) if m.jnt_limited[j]
                      else rng.normal(size=B))
    else:
      if jt == JointType.FREE:
        qpos[:, adr:adr + 3] = rng.normal(scale=0.3, size=(B, 3))
        adr += 3
      q = rng.normal(size=(B, 4))
      qpos[:, adr:adr + 4] = q / np.linalg.norm(q, axis=-1, keepdims=True)
  qvel = rng.normal(size=(B, m.nv))
  return qpos, qvel


def _mocap(m, seed: int):
  rng = np.random.default_rng(seed + 100)
  pos = rng.normal(scale=0.1, size=(B, m.nmocap, 3))
  quat = rng.normal(size=(B, m.nmocap, 4))
  return pos, quat / np.linalg.norm(quat, axis=-1, keepdims=True)


def _batches(scene: str, seed: int):
  jm, pm = _models(scene)
  qpos, qvel = _random_states(jm, seed)
  z = np.zeros
  jd = jax_batch(jm, qpos, qvel, z((B, jm.na)), z((B, jm.nu)),
                 z((B, jm.nv)))
  if jm.nmocap:
    mp, mq = _mocap(jm, seed)
    jd = jd.replace(mocap_pos=jnp.asarray(mp), mocap_quat=jnp.asarray(mq))
  return jm, pm, jd


@pytest.mark.parametrize("scene", ["free10", "mixed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_smooth_stages_match_jax(scene, seed):
  jm, pm, jd = _batches(scene, seed)
  pd = port_batch(jd)
  jkin = jax.vmap(lambda q, mp, mq: jsmooth.kinematics(jm, q, mp, mq))(
      jd.qpos, jd.mocap_pos, jd.mocap_quat)
  kin = smooth.kinematics(pm, pd.qpos, mocap_pos=pd.mocap_pos,
                          mocap_quat=pd.mocap_quat)
  assert sorted(kin) == sorted(jkin)
  for k in jkin:
    assert_close(kin[k], jkin[k], what=k, **STAGE)
  jcom = jax.vmap(lambda kk: jsmooth.com_pos(jm, kk))(jkin)
  com = smooth.com_pos(pm, kin)
  for port, ref, what in zip(com, jcom, ("subtree_com", "cinert", "cdof")):
    assert_close(port, ref, what=what, **STAGE)
  assert_close(smooth.crb(pm, com[1], com[2]),
               jax.vmap(lambda ci, cd: jsmooth.crb(jm, ci, cd))(*jcom[1:]),
               what="qM", **STAGE)
  jvel = jax.vmap(lambda cd, qv: jsmooth.com_vel(jm, cd, qv))(jcom[2],
                                                              jd.qvel)
  vel = smooth.com_vel(pm, com[2], pd.qvel)
  assert_close(vel[0], jvel[0], what="cvel", **STAGE)
  assert_close(vel[1], jvel[1], what="cdof_dot", **STAGE)
  jbias = jax.vmap(lambda ci, cd, cdd, cv, qv: jsmooth.rne(
      jm, ci, cd, cdd, cv, qv))(jcom[1], jcom[2], jvel[1], jvel[0], jd.qvel)
  assert_close(smooth.rne(pm, com[1], com[2], vel[1], vel[0], pd.qvel),
               jbias, what="qfrc_bias", **STAGE)

  # full_data=False: the fields it keeps, and cdof from them, are the same
  lean = smooth.kinematics(pm, pd.qpos, full_data=False,
                           mocap_pos=pd.mocap_pos, mocap_quat=pd.mocap_quat)
  assert set(kin) - set(lean) == {"xmat", "site_xmat"}
  for k in lean:
    assert torch.equal(lean[k], kin[k]), k
  assert torch.equal(smooth.com_pos(pm, lean)[2], com[2])


def test_scenes_cover_every_joint_type_and_a_mocap_body():
  for scene in ("free10", "mixed"):
    jm, _ = _models(scene)
    assert {int(t) for t in jm.jnt_type} >= {JointType.FREE,
                                             JointType.BALL,
                                             JointType.HINGE}, scene
  jm, pm = _models("free10")
  assert (jm.nq, jm.nv, jm.nmocap, jm.nu) == (12, 10, 1, 0)
  assert JointType.SLIDE in {int(t) for t in _models("mixed")[0].jnt_type}


def test_kinematics_needs_the_mocap_pose():
  _, pm = _models("free10")
  with pytest.raises(ValueError, match="mocap"):
    smooth.kinematics(pm, torch.zeros((1, pm.nq), dtype=torch.float64))


def _rollout_start(jm):
  """B envs at the fixture's start, the bar on the plane, small random
  joint offsets and velocities per env."""
  rng = np.random.default_rng(7)
  qpos = np.tile(jm.qpos0, (B, 1))
  qpos[:, 0] += rng.uniform(-0.3, 0.3, B)                 # swing
  qpos[:, 5:8] += rng.uniform(-0.005, 0.005, (B, 3))      # rod position
  qvel = rng.normal(scale=0.2, size=(B, jm.nv))
  z = np.zeros
  jd = jax_batch(jm, qpos, qvel, z((B, jm.na)), z((B, jm.nu)), z((B, jm.nv)))
  return jd.replace(mocap_pos=jnp.broadcast_to(
      jnp.asarray(BAR_POS), (B, 1, 3)))


def test_physics_rollout_matches_jax_step():
  jm, _ = _models("free10")
  phys = api.Physics(tmodel.load_npz(FREE_NPZ), torch.float64, "cpu")
  jd = _rollout_start(jm)
  pd = port_batch(jd)
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  contacts = 0
  for t in range(ROLLOUT_STEPS):
    jd = jstep(jd)
    pd = phys.step(pd)
    contacts += int((pd.contact.dist < 0).sum())
  for f in ("qpos", "qvel", "qacc", "qfrc_constraint", "xpos", "cvel"):
    assert_close(getattr(pd, f), getattr(jd, f), what=f, **ROLLOUT)
  assert contacts > 0, "the free body never touched the plane or the bar"
  # quaternions stay unit
  for adr in (1, 8):
    n = torch.linalg.vector_norm(pd.qpos[:, adr:adr + 4], dim=-1)
    assert_close(n, torch.ones_like(n), rtol=0, atol=1e-12)


def test_physics_api():
  path = FREE_NPZ
  phys = api.load(path, torch.float64, "cpu")
  assert api.load(path, torch.float64, "cpu") is phys
  assert api.load(path, torch.float32, "cpu") is not phys
  assert phys.step_batch == phys.step and phys.forward_batch == phys.forward
  d = phys.make_data(3)
  assert d.qpos.shape == (3, 12) and d.mocap_pos.shape == (3, 1, 3)
  assert torch.equal(d.mocap_pos, torch.zeros_like(d.mocap_pos))
  d = d.replace(mocap_pos=torch.tensor(BAR_POS, dtype=torch.float64).expand(
      3, 1, 3).clone())
  a = phys.step_n(4)(d)
  b = d
  for _ in range(4):
    b = phys.step(b)
  for f in ("qpos", "qvel", "qacc_warmstart", "time"):
    assert torch.equal(getattr(a, f), getattr(b, f)), f
  f = phys.forward(d)
  assert torch.equal(f.qpos, d.qpos) and f.qM.abs().sum() > 0
  # the mocap body carries its geom
  bar = phys.model.name2id("geom", "bar_geom")
  assert_close(f.geom_xpos[:, bar], d.mocap_pos[:, 0], rtol=0, atol=1e-15)


_REFUSED = {
    "ball joint limits": """<mujoco><worldbody><body>
        <joint type="ball" range="0 1"/><geom size=".1"/></body></worldbody>
        </mujoco>""",
    "spring on ball/free joint": """<mujoco><worldbody><body>
        <freejoint/><geom size=".1"/></body><body pos="1 0 0">
        <joint type="ball" stiffness="2"/><geom size=".1"/></body>
        </worldbody></mujoco>""",
    "joint transmission on ball/free joints": """<mujoco><worldbody><body>
        <joint name="b" type="ball"/><geom size=".1"/></body></worldbody>
        <actuator><motor joint="b"/></actuator></mujoco>""",
}


@pytest.mark.parametrize("what", sorted(_REFUSED))
def test_features_the_reference_refuses_stay_refused(what):
  jm = jmodel.load_model(_REFUSED[what], dtype=np.float64)
  with pytest.raises(NotImplementedError, match=what.split()[0]):
    d = jax_batch(jm, *[np.zeros((1, n)) for n in
                        (jm.nq, jm.nv, jm.na, jm.nu, jm.nv)])
    jax.vmap(functools.partial(jforward.step, jm))(d)
  with pytest.raises(NotImplementedError, match=what):
    tmodel.DeviceModel(tmodel.from_reference(jm), torch.float64, "cpu")


def test_free_integration_is_the_references():
  """_integrate_pos on ball and free joints: quat_integrate, then
  normalize, one joint at a time in the reference."""
  jm, pm = _models("mixed")
  qpos, qvel = _random_states(jm, 3)
  ref = jax.vmap(lambda q, v: jforward._integrate_pos(jm, q, v, 0.01))(
      jnp.asarray(qpos), jnp.asarray(qvel))
  out = forward._integrate_pos(pm, torch.as_tensor(qpos),
                               torch.as_tensor(qvel), 0.01)
  assert_close(out, ref, rtol=1e-13, atol=1e-15)
