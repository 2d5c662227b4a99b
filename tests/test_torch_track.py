"""TrackEnv (the MyoDM ids): the port against the JAX package, float64, on
the track17 scene (``assets/fixtures.py``: hand11 on a 6-dof base, 17
robot dofs, a convex mesh cube on 3 slides and 3 hinges).

The JAX class derives its scene from the object's name through the asset
tree; here ``myosuite_mjx_tpu.envs.track.assets.object_scene_xml`` is
patched, inside the test, to return the same MJCF. The JAX env runs under
``jax.vmap`` with a registered id's kwargs.

- ``track17CubesmallRandom-v0``: 3 autoreset steps of 4 envs with horizon
  2; JAX's RANDOM draws, rebuilt from the key its aux holds (split in 3
  for robot, robot_vel and object), go to the port through
  ``draw_reference``; the port keeps the draw in aux (``ref_draw``), JAX
  the key, so aux is compared as draws;
- ``Fixed``, ``Lift`` (a TRACK clip with ``robot_vel``) and ``Inspect``
  (a clip without): the init pose and lift height, a reset to given
  states (the object raised over the lift height in some envs), and obs
  and reward dict there with the clocks moved across the clip (between
  frames, on the last frame, past the end).

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info, aux and the draws, as the other task rollouts.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (QueuedDraws, TASK_TOL, TRACK, TRACK_CLIP_NPZ,
                          TRACK_NPZ, assert_close, bare_envs_package,
                          compare_task_states, fixture_xml, reset_split,
                          task_kwargs, task_rollout, to_np)
from myosuite_mjx_tpu_torch.assets import fixtures
from myosuite_mjx_tpu_torch.envs import myodm
from myosuite_mjx_tpu_torch.envs.track import TrackEnv

B = 4
STEPS = 3
F64 = jnp.float64
SCENE = "track17"
IDS = {name: f"{SCENE}Cubesmall{name}-v0"
       for name in ("Fixed", "Random", "Lift", "Inspect")}


@functools.lru_cache(maxsize=None)
def _jax_env(name: str, **over):
  kw = task_kwargs(IDS[name], **over)
  with bare_envs_package(), pytest.MonkeyPatch.context() as mp:
    from myosuite_mjx_tpu.envs import track as jtrack
    mp.setattr(jtrack.assets, "object_scene_xml",
               lambda object_name: fixture_xml(SCENE))
    return jtrack.TrackEnv(dtype=F64, **kw)


class _Port(QueuedDraws, TrackEnv):
  HOOKS = ("draw_reference",)

  def draw_reference(self, batch, device, generator):
    return self.next_draw("draw_reference", device)

  def next_draw(self, hook, device):
    out = self.draws[hook].pop(0)
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in out.items()}


def _port_env(name: str, **over) -> _Port:
  return _Port(TRACK_NPZ[SCENE], dtype=torch.float64,
               **task_kwargs(IDS[name], **over))


def _jax_draws(jenv, ref_rng):
  """JAX's RANDOM draw from the key its aux holds."""
  out = jenv.ref.get_reference(jnp.zeros((), F64), ref_rng)
  return {k: v for k, v in out.items() if v is not None}


def _queue(penv, jenv):
  def queue(keys):
    if not penv.HOOKS or penv.ref.type.name != "RANDOM":
      return
    k_aux, _ = reset_split(keys)
    ref_rng = jax.vmap(lambda k: jax.random.split(k, 1)[0])(k_aux)
    penv.draws["draw_reference"].append(
        jax.vmap(lambda r: _jax_draws(jenv, r))(ref_rng))
  return queue


def _rollout(name: str):
  over = dict(horizon=2)
  jenv, penv = _jax_env(name, **over), _port_env(name, **over)
  np.testing.assert_allclose(penv.init_qpos, jenv.init_qpos, rtol=1e-12,
                             atol=1e-15)
  assert abs(penv._lift_z - jenv._lift_z) < 1e-12
  random = name == "Random"
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv, jenv), B, STEPS,
                                compare_aux=not random)
  assert ends > 0
  if random:
    # the port's kept draw is the one JAX draws again from its kept key
    ref = jax.vmap(lambda r: _jax_draws(jenv, r))(jst.aux["ref_rng"])
    assert sorted(pst.aux["ref_draw"]) == sorted(ref)
    for k, v in ref.items():
      assert_close(pst.aux["ref_draw"][k], v, what=f"draw {k}", **TASK_TOL)
  return jst, pst


@pytest.fixture(scope="module")
def random_rollout():
  return _rollout("Random")


def test_random_rollout_matches_jax(random_rollout):
  _, pst = random_rollout
  # the object rests on the table and meets the mesh-plane pair
  assert (to_np(pst.data.contact.dist) < 0).any()


@pytest.mark.parametrize("name", ["Fixed", "Lift", "Inspect"])
def test_reset_and_reward_match_jax(name):
  jenv, penv = _jax_env(name), _port_env(name)
  np.testing.assert_allclose(penv.init_qpos, jenv.init_qpos, rtol=1e-12,
                             atol=1e-15)
  assert abs(penv._lift_z - jenv._lift_z) < 1e-12
  # restored states (a reset from given qpos, qvel): the hand jittered
  # about its init pose, the object raised 5 cm in envs 0, 2 and 3 (over
  # the lift height); then obs and reward dict with the clocks moved
  # across the clip (between frames, on the inspect clip's last frame,
  # past both clips' ends)
  keys = jax.random.split(jax.random.PRNGKey(3), B)
  rng = np.random.default_rng(4)
  qpos = np.tile(jenv.init_qpos, (B, 1))
  rd = jenv.ref.robot_dim
  qpos[:, :rd] += rng.uniform(-0.02, 0.02, (B, rd))
  qpos[[0, 2, 3], rd + 2] += 0.05
  qvel = rng.normal(0.0, 0.1, (B, penv.model.nv))
  jst = jax.jit(jax.vmap(lambda q, v, k: jenv.reset_to(q, v, k)))(
      jnp.asarray(qpos), jnp.asarray(qvel), keys)
  pst = penv.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel), aux={})
  compare_task_states(jenv, jst, penv, pst, f"{name} reset")
  t = np.array([0.337, 1.2, 1.9, 2.5])
  jd = jst.data.replace(time=jnp.asarray(t, F64))
  pd = pst.data.replace(time=torch.as_tensor(t))
  jobs = jax.jit(jax.vmap(lambda d: jenv.get_obs_dict(d, {})))(jd)
  jrwd = jax.jit(jax.vmap(lambda d: jenv.get_reward_dict(
      jenv.get_obs_dict(d, {}), d, {})))(jd)
  pobs = penv.get_obs_dict(pd, {})
  prwd = penv.get_reward_dict(pobs, pd, {})
  assert sorted(pobs) == sorted(jobs) and sorted(prwd) == sorted(jrwd)
  for k, v in jobs.items():
    assert_close(pobs[k], v, what=f"obs {k}", **TASK_TOL)
  for k, v in jrwd.items():
    assert_close(prwd[k], v, what=f"reward {k}", **TASK_TOL)
  if name == "Lift":
    # the lift bonus where the target and the object are both high
    np.testing.assert_array_equal(to_np(prwd["bonus"]), [0, 0, 1, 1])


def test_random_draw_is_held_across_the_episode():
  """One draw per episode: kept through plain steps, and replaced only in
  the envs that autoreset."""
  env = TrackEnv(TRACK_NPZ[SCENE], dtype=torch.float64,
                 **task_kwargs(IDS["Random"], horizon=3))
  g = torch.Generator().manual_seed(0)
  st = env.reset(6, "cpu", g)
  first = {k: v.clone() for k, v in st.aux["ref_draw"].items()}
  targ0 = env.get_obs_dict(st.data, st.aux)["targ_obj_com"]
  a = lambda: torch.rand((6, env.action_dim), generator=g,
                         dtype=torch.float64)
  for _ in range(2):
    st = env.step(st, a(), g)
  for k, v in first.items():
    np.testing.assert_array_equal(to_np(st.aux["ref_draw"][k]), to_np(v))
  np.testing.assert_array_equal(
      to_np(env.get_obs_dict(st.data, st.aux)["targ_obj_com"]), to_np(targ0))
  np.testing.assert_array_equal(to_np(targ0), to_np(first["object"][:, :3]))
  st = env.autoreset_step(st, a(), g)   # step 3 reaches horizon 3
  ended = to_np(st.info["terminated"] | st.info["truncated"])
  assert ended.all()
  assert not np.array_equal(to_np(st.aux["ref_draw"]["object"]),
                            to_np(first["object"]))
  lo = np.array([-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, -1.0])
  hi = np.array([0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 1.0])
  x = to_np(st.aux["ref_draw"]["object"])
  assert ((x >= lo) & (x <= hi)).all()


@pytest.mark.parametrize("scene", sorted(TRACK))
def test_clips_equal_fresh_export(scene):
  fresh = fixtures.track_clips(TRACK[scene])
  assert sorted(fresh) == sorted(myodm.CLIPS)
  for name, clip in fresh.items():
    with np.load(TRACK_CLIP_NPZ[scene, name]) as z:
      assert sorted(z.files) == sorted(clip)
      for k, v in clip.items():
        np.testing.assert_array_equal(z[k], v, err_msg=k)
    q = clip["object"][:, 3:]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=1e-12)
    assert clip["robot"].shape[1] == myodm.SCENES[scene]
  assert "robot_vel" in fresh["lift"] and "robot_vel" not in fresh["inspect"]
