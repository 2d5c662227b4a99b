"""BimanualEnv: the port against the JAX package, float64, on the arm15
bimanual scene (``arm15Bimanual-v0``'s task: the start and goal jitter,
the object's mass overlay and the friction draw).

The JAX class is built on the same MJCF (``bimanual_fixture_xml(2)``) and
runs under ``jax.vmap``. Its draws are rebuilt from its key schedule
(reset splits its key in 4: the jitter from the second, split in 2; the
overlay from the third, split in 2; ``autoreset_step`` resets from the
second half of a split of the state's key) and handed to the port through
``draw_start_goal`` and ``draw_object_overlay``. frame_skip 2 keeps the
JAX compile short; horizon 3 makes autoreset fire inside the rollout.
B = 4.

Also: the contact classes of ``_touching_vec`` on a contact set that
holds every class (and inactive slots), against the reference's; the
friction overlay, which the reference (and so the port) adds as one draw
to every geom's friction; the body order the classes need.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info and aux, as the other tasks' rollouts; overlays and
contact classes exact.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (FIXTURE_NPZ, QueuedDraws, assert_close,
                          bare_envs_package, reset_split, task_kwargs,
                          task_rollout, to_np)
from myosuite_mjx_tpu.engine import data as jdata
from myosuite_mjx_tpu_torch.assets.fixtures import bimanual_fixture_xml
from myosuite_mjx_tpu_torch.engine import data as tdata
from myosuite_mjx_tpu_torch.envs.bimanual import BimanualEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("arm15Bimanual-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.bimanual import BimanualEnv as J
    return J(bimanual_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, BimanualEnv):
  HOOKS = ("draw_start_goal", "draw_object_overlay")

  def draw_start_goal(self, batch, device, generator):
    return self.next_draw("draw_start_goal", device)

  def draw_object_overlay(self, batch, device, generator):
    return self.next_draw("draw_object_overlay", device)


def _queue(penv):
  f64 = jnp.float64
  delta = jnp.asarray(KWARGS["obj_friction_change"], f64)

  def jitter(k):
    k1, k2 = jax.random.split(k)
    return (jax.random.uniform(k1, (3,), f64),
            jax.random.uniform(k2, (3,), f64))

  def overlay(k):
    k1, k2 = jax.random.split(k)
    return (jax.random.uniform(k1, (), f64, *KWARGS["obj_mass_change"]),
            jax.random.uniform(k2, (3,), f64, -delta, delta))

  def queue(keys):
    k_aux, k_state = reset_split(keys)
    penv.draws["draw_start_goal"].append(jax.vmap(jitter)(k_aux))
    penv.draws["draw_object_overlay"].append(jax.vmap(overlay)(k_state))
  return queue


def _port():
  return _Port(FIXTURE_NPZ["bimanual2"], dtype=torch.float64, **KWARGS)


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _port()
  for name in ("myo_body_range", "prosth_body_range", "obj_bid",
               "start_bid", "goal_bid", "elbow_qadr"):
    assert getattr(penv, name) == getattr(jenv, name), name
  for name in ("myo_qadr", "myo_dadr", "pro_qadr", "pro_dadr", "obj_qadr",
               "obj_dadr"):
    np.testing.assert_array_equal(getattr(penv, name), getattr(jenv, name))
  assert_close([penv.init_obj_z, penv.init_palm_z],
               [jenv.init_obj_z, jenv.init_palm_z], rtol=0, atol=1e-14)
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv), B, STEPS)
  assert ends > 0
  for k in ("body_mass", "geom_friction"):
    assert_close(pst.data.overlay[k], jst.data.overlay[k], rtol=0, atol=0,
                 what=k)


def test_friction_draw_is_added_to_every_geom():
  """The reference's ``.at[None]`` adds its one draw to all geoms; the
  port keeps that for parity (upstream perturbs the object alone)."""
  penv = _port()
  draw = np.array([[0.05, -0.0004, 0.00001], [-0.02, 0.0007, -0.00002]])
  penv.draws["draw_object_overlay"].append((np.array([0.01, -0.03]), draw))
  out = penv.reset_overlay(2, "cpu", {}, None)
  delta = to_np(out["geom_friction"]) - penv.model.geom_friction
  assert delta.shape == (2, penv.model.ngeom, 3)
  np.testing.assert_allclose(delta, np.broadcast_to(
      draw[:, None, :], delta.shape), rtol=0, atol=1e-15)
  mass = to_np(out["body_mass"])
  base = penv.model.body_mass
  assert_close(mass[:, penv.obj_bid], base[penv.obj_bid] + np.array(
      [0.01, -0.03]), rtol=0, atol=1e-15)
  others = np.arange(penv.model.nbody) != penv.obj_bid
  assert (mass[:, others] == base[others]).all()
  # the reference's own overlay: one draw, the same offset on every geom
  jenv = _jax_env()
  ref = jenv.reset_overlay(jax.random.PRNGKey(0), {})
  jdelta = (np.asarray(ref["geom_friction"])
            - np.asarray(jenv.model.geom_friction))
  np.testing.assert_allclose(jdelta, np.broadcast_to(jdelta[:1],
                                                     jdelta.shape),
                             rtol=0, atol=1e-15)
  assert np.abs(jdelta).max() > 0


def test_touching_vector_matches_jax():
  """Every class (the arm, the prosthesis, the start and goal pillars,
  anything else: the floor), in either slot order, and inactive slots."""
  jenv = _jax_env()
  penv = _port()
  m = penv.model
  gb = np.asarray(m.geom_bodyid)
  obj_geom = int(np.where(gb == penv.obj_bid)[0][0])
  pick = lambda lo, hi: int(np.where((gb >= lo) & (gb <= hi))[0][0])
  partners = {"myo": pick(*penv.myo_body_range),
              "pro": pick(*penv.prosth_body_range),
              "start": m.name2id("geom", "start"),
              "goal": m.name2id("geom", "goal"),
              "env": m.name2id("geom", "floor")}
  names = list(partners)
  rng = np.random.default_rng(0)
  n_env, k = 12, 6
  g1 = np.full((n_env, k), partners["env"])
  g2 = np.full((n_env, k), partners["myo"])
  dist = np.full((n_env, k), 0.01)
  margin = np.zeros((n_env, k))
  for e in range(n_env):
    for s in range(k):
      other = partners[names[rng.integers(len(names))]]
      g1[e, s], g2[e, s] = ((obj_geom, other) if rng.uniform() < 0.5
                            else (other, obj_geom))
      dist[e, s] = rng.choice([-0.001, 0.002, 0.0])
      margin[e, s] = rng.choice([0.0, 0.001])
  # one env with no object contact at all
  g1[0], g2[0] = partners["env"], partners["myo"]
  d0 = jdata.make_data(jenv.model, dtype=jnp.float64)
  jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_env,) + x.shape), d0)
  jc = jd.contact
  ncon = jc.dist.shape[1]
  assert ncon >= k
  pad = lambda x, fill: np.concatenate(
      [x, np.full((n_env, ncon - k), fill, x.dtype)], 1)
  jc = jc.replace(geom1=jnp.asarray(pad(g1.astype(np.int32), 0)),
                  geom2=jnp.asarray(pad(g2.astype(np.int32), 0)),
                  dist=jnp.asarray(pad(dist, 1.0)),
                  includemargin=jnp.asarray(pad(margin, 0.0)))
  jd = jd.replace(contact=jc, overlay={})
  ref = np.asarray(jax.vmap(jenv._touching_vec)(jd))
  pdata = tdata.data_from_numpy(jax.tree.map(np.asarray, jd), "cpu")
  port = to_np(penv._touching_vec(pdata))
  np.testing.assert_array_equal(port, ref)
  assert ref.shape == (n_env, 5) and (ref.sum(0) > 0).all()
  assert (ref[0] == 0).all()


def test_body_order_and_widths():
  """The arm's bodies, then the prosthesis's, then the pillars and the
  object (the classes are body-id ranges); the prosthesis's joints are
  driven by position actuators, so the env has fewer activations than
  actuators."""
  env = _port()
  m = env.model
  lo, hi = env.myo_body_range
  plo, phi = env.prosth_body_range
  assert 0 < lo <= hi < plo <= phi < min(env.start_bid, env.goal_bid,
                                         env.obj_bid)
  assert m.nv == 15 + 11 + 6 and m.na == 45 and m.nu == 56
  assert len(env.pro_qadr) == 11 and len(env.myo_qadr) == 15
  # the object drops 0.5 mm onto the start pillar and rests there: the
  # start class is on in every env
  env = BimanualEnv(FIXTURE_NPZ["bimanual2"], dtype=torch.float64,
                    **task_kwargs("arm15Bimanual-v0"))
  st = env.reset(2, "cpu", torch.Generator().manual_seed(0))
  for _ in range(6):
    st = env.step(st, torch.zeros((2, env.action_dim), dtype=torch.float64))
  touching = to_np(env._touching_vec(st.data))
  assert (touching[:, 2] == 1).all() and (touching[:, 3] == 0).all()
  assert (to_np(st.aux["goal_touch"]) == 0).all()
