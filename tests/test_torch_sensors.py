"""Sensors: the port's touch and force sensors against the JAX package,
float64 on the CPU, on the scenes of ``tests/test_sensors.py``.

Each compares the sensors on one forward pass of the same state, reached
by a seeded rollout of the port.

- ``ARM_XML``: a motor-driven hinge chain under gravity (no contact): the
  wrist's force sensor, within rtol 1e-9 of JAX's (one formula on the same
  forward pass, rounding only);
- ``PLATE_XML``: a ball resting on a hinged plate: the plate mount's force
  sensor (contact forces in the subtree balance) and a touch sensor on the
  ball's contact, within rtol 1e-8 (after the Newton solve, as the engine
  rollouts), and the static-weight anchor: at rest the mount carries the
  plate's and the ball's weight, within 1%;
- the legs scene's four foot touch sensors through ``sensor_by_name``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from test_sensors import ARM_XML, PLATE_XML
from torch_parity import (LEGS_NPZ, assert_close, export_model, fixture_xml,
                          jax_batch, port_batch, to_np)
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu.engine import sensors as jsensors
from myosuite_mjx_tpu_torch.engine import forward, sensors
from myosuite_mjx_tpu_torch.engine import model as tmodel

B = 4
SMOOTH = dict(rtol=1e-9, atol=1e-11)
SOLVED = dict(rtol=1e-8, atol=1e-9)


@functools.lru_cache(maxsize=None)
def _models(xml: str):
  jm = jmodel.load_model(xml, dtype=np.float64)
  return jm, tmodel.DeviceModel(tmodel.from_reference(jm), torch.float64,
                                "cpu")


def _rollout(xml: str, steps: int, seed: int = 0, qvel_scale: float = 0.5):
  """B envs from seeded states, ``steps`` substeps of the port; then the
  forward pass of the final state in both packages (JAX Data, port
  Data)."""
  jm, pm = _models(xml)
  rng = np.random.default_rng(seed)
  qpos = np.tile(jm.qpos0, (B, 1))
  hinge = np.asarray(jm.jnt_qposadr)[np.asarray(jm.jnt_type) == 3]
  qpos[:, hinge] += rng.uniform(-0.3, 0.3, (B, len(hinge)))
  qvel = rng.normal(0, qvel_scale, (B, jm.nv))
  ctrl = rng.uniform(-1, 1, (B, jm.nu))
  d = port_batch(jax_batch(jm, qpos, qvel, np.zeros((B, jm.na)), ctrl,
                           np.zeros((B, jm.nv))))
  for _ in range(steps):
    d = forward.step(pm, d)
  return (jm, pm) + _both_forward(jm, pm, d)


def _both_forward(jm, pm, d):
  """The forward pass of the port's state ``d`` in both packages."""
  jd = jax_batch(jm, *(to_np(x) for x in (d.qpos, d.qvel, d.act, d.ctrl,
                                          d.qacc_warmstart)))
  jd = jax.jit(jax.vmap(functools.partial(jforward.forward, jm)))(jd)
  return jd, forward.forward(pm, port_batch(jd))


def _site(m, name: str) -> int:
  return int(m.sensor_objid[m.name2id("sensor", name)])


def test_force_sensor_smooth_chain():
  jm, pm, jd, pd = _rollout(ARM_XML, 30)
  site = _site(jm, "wrist_load")
  ref = jax.vmap(lambda d: jsensors.force_sensor(jm, d, site))(jd)
  got = sensors.force_sensor(pm, pd, site)
  assert got.shape == (B, 3)
  assert_close(got, ref, what="wrist_load", **SMOOTH)
  assert_close(sensors.sensor_by_name(pm, pd, "wrist_load"), got, rtol=0,
               atol=0)


def test_force_and_touch_sensors_with_contact():
  jm, pm, jd, pd = _rollout(PLATE_XML, 200, qvel_scale=0.05)
  assert (to_np(pd.contact.dist) < 0).any(), "the ball left the plate"
  site = _site(jm, "plate_load")
  ref = jax.vmap(lambda d: jsensors.force_sensor(jm, d, site))(jd)
  assert_close(sensors.force_sensor(pm, pd, site), ref, what="plate_load",
               **SOLVED)
  touch = jax.vmap(lambda d: jsensors.touch_sensor(jm, d, site))(jd)
  got = sensors.touch_sensor(pm, pd, site)
  assert_close(got, touch, what="touch", **SOLVED)
  assert (to_np(got) > 0).any()


def test_plate_fixture_is_the_sensor_tests_scene():
  """``assets/plate.npz`` (the card's copy of PLATE_XML) compiles to the
  same model as the JAX tests' scene."""
  a = export_model(PLATE_XML)
  b = export_model(fixture_xml("plate"))
  assert sorted(a) == sorted(b)
  for k in a:
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_force_sensor_matches_static_weight():
  """At rest (1500 substeps) the mount carries plate + ball weight."""
  jm, pm = _models(PLATE_XML)
  d = port_batch(jax_batch(jm, jm.qpos0[None], np.zeros((1, jm.nv)),
                           np.zeros((1, jm.na)), np.zeros((1, jm.nu)),
                           np.zeros((1, jm.nv))))
  for _ in range(1500):
    d = forward.step(pm, d)
  assert float(d.qvel.abs().max()) < 1e-3, "did not settle"
  d = forward.forward(pm, d)
  got = to_np(sensors.force_sensor(pm, d, _site(jm, "plate_load")))[0]
  total_w = (0.5 + 0.2) * 9.81
  assert abs(np.linalg.norm(got) - total_w) / total_w < 0.01


@functools.lru_cache(maxsize=None)
def _standing_legs():
  """legs16 from its standing key after 300 substeps of the port (it
  settles); the forward pass of that state in both packages."""
  jm = jmodel.load_model(fixture_xml("legs16"), dtype=np.float64)
  pm = tmodel.DeviceModel(tmodel.load_npz(LEGS_NPZ["legs16"]), torch.float64,
                          "cpu")
  z = lambda n: np.zeros((1, n))
  d = port_batch(jax_batch(jm, jm.key_qpos[:1], z(jm.nv), z(jm.na),
                           z(jm.nu), z(jm.nv)))
  for _ in range(300):
    d = forward.step(pm, d)
  return (jm, pm) + _both_forward(jm, pm, d)


@pytest.mark.parametrize("name", ("r_foot", "r_toes", "l_foot", "l_toes"))
def test_leg_touch_sensors_by_name(name):
  """Each foot sensor against JAX's; the four together carry the body's
  weight."""
  jm, pm, jd, pd = _standing_legs()
  got = sensors.sensor_by_name(pm, pd, name)
  want = jax.vmap(lambda d: jsensors.sensor_by_name(jm, d, name))(jd)
  assert_close(got, want, what=name, **SOLVED)
  total = sum(sensors.sensor_by_name(pm, pd, n)
              for n in ("r_foot", "r_toes", "l_foot", "l_toes"))
  weight = float(np.sum(jm.body_mass)) * 9.81
  assert abs(float(total[0, 0]) - weight) / weight < 0.02
