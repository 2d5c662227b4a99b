"""RelocateEnv: the port against the JAX package, float64, on the arm15
relocate scene (``arm15RelocateP2-v0``'s task: a drawn goal pose, a drawn
object start from the scene's second keyframe, jittered joints), whose
object collides as a convex mesh (plane-mesh with the table,
capsule-mesh with the digits, ellipsoid-mesh with the nails).

The JAX class is built on the same MJCF (``relocate_fixture_xml(2)``) and
runs under ``jax.vmap``. Its draws are rebuilt from its key schedule
(reset splits its key in 4: the goal from the second, split in 2; the
start and the joint noise from the third, split in 2; ``autoreset_step``
resets from the second half of a split of the state's key) and handed to
the port through ``draw_goal`` and ``draw_start``. frame_skip 2 keeps the
JAX compile short; horizon 3 makes autoreset fire inside the rollout.
B = 4.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info and aux, as the other tasks' rollouts.
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
from myosuite_mjx_tpu_torch.assets.fixtures import relocate_fixture_xml
from myosuite_mjx_tpu_torch.engine import collision
from myosuite_mjx_tpu_torch.engine.model import GeomType as T
from myosuite_mjx_tpu_torch.envs.relocate import RelocateEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("arm15RelocateP2-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.relocate import RelocateEnv as J
    return J(relocate_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, RelocateEnv):
  HOOKS = ("draw_goal", "draw_start")

  def draw_goal(self, batch, device, generator):
    return self.next_draw("draw_goal", device)

  def draw_start(self, batch, device, generator):
    return self.next_draw("draw_start", device)


def _queue(penv, nq):
  f64 = jnp.float64
  box = lambda k, r: jax.random.uniform(k, (3,), f64, jnp.asarray(r["low"]),
                                        jnp.asarray(r["high"]))
  noise = KWARGS["qpos_noise_range"]

  def goal(k):
    k1, k2 = jax.random.split(k)
    return (box(k1, KWARGS["target_xyz_range"]),
            box(k2, KWARGS["target_rxryrz_range"]))

  def start(k):
    k1, k2 = jax.random.split(k)
    return (box(k1, KWARGS["obj_xyz_range"]),
            jax.random.uniform(k2, (nq,), f64, -noise, noise))

  def queue(keys):
    k_aux, k_state = reset_split(keys)
    penv.draws["draw_goal"].append(jax.vmap(goal)(k_aux))
    penv.draws["draw_start"].append(jax.vmap(start)(k_state))
  return queue


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _Port(FIXTURE_NPZ["relocate2"], dtype=torch.float64, **KWARGS)
  # the second keyframe: the task draws the object's start
  assert_close(penv.init_qpos, penv.model.key_qpos[1], rtol=0, atol=0)
  assert_close(penv.init_qpos, jenv.init_qpos, rtol=0, atol=0)
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv, penv.model.nq), B,
                                STEPS)
  assert ends > 0
  # every mesh pair but the sphere's is a candidate of the scene
  spec = collision.collision_spec(penv.device_model("cpu"))
  kinds = {tuple(g.types) for g in spec.groups if g.hull is not None}
  assert kinds == {(T.PLANE, T.MESH), (T.CAPSULE, T.MESH),
                   (T.ELLIPSOID, T.MESH)}


def test_p1_starts_from_the_first_keyframe():
  env = RelocateEnv(FIXTURE_NPZ["relocate2"], dtype=torch.float64,
                    **task_kwargs("arm15RelocateP1-v0"))
  assert_close(env.init_qpos, env.model.key_qpos[0], rtol=0, atol=0)
  st = env.reset(3, "cpu", torch.Generator().manual_seed(0))
  obs = env.get_obs_dict(st.data, st.aux)
  # the object where the keyframe puts it, the goals at z 0.9, the palm
  # within reach
  assert_close(obs["obj_pos"], np.tile([0.0, -0.25, 1.0], (3, 1)), rtol=0,
               atol=1e-12)
  assert_close(obs["goal_pos"][:, 2], np.full(3, 0.9), rtol=0, atol=1e-12)
  reach = np.linalg.norm(to_np(obs["reach_err"]), axis=-1)
  assert (reach < 0.3).all() and not to_np(st.done).any()
  assert env.model.nv == 21 and env.action_dim == 45
  # the object drops 0.5 mm onto the table and rests there on its four
  # lowest vertices (plane-mesh contacts)
  for _ in range(8):
    st = env.step(st, torch.zeros((3, env.action_dim), dtype=torch.float64))
  c = st.data.contact
  g = np.asarray(env.model.geom_type)
  touching = to_np(c.dist < 0) & (g[to_np(c.geom2)] == T.MESH)
  assert (touching.sum(-1) >= 3).all()
  assert abs(float(st.data.qvel[:, -6:].abs().max())) < 0.05
