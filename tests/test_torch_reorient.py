"""ReorientEnv (die reorientation): the port against the JAX package,
float64, on the hand11 die scene (``hand11DieReorientP1-v0``'s task).

The JAX class is built on the same MJCF (``die_fixture_xml(2)``) and runs
under ``jax.vmap``. Its goal draws are rebuilt from its key schedule
(reset splits its key in 4 and the second in 2: the position offset from
the first half, the Euler angles from the second; ``autoreset_step``
resets from the second half of a split of the state's key) and handed to
the port through ``draw_goal``. frame_skip 2 keeps the JAX compile short;
horizon 3 makes autoreset fire inside the rollout. B = 4.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info and aux, as the reach task's rollout.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (OBJECT_NPZ, QueuedDraws, assert_close,
                          bare_envs_package, reset_split, task_kwargs,
                          task_rollout, to_np)
from myosuite_mjx_tpu_torch.assets.fixtures import die_fixture_xml
from myosuite_mjx_tpu_torch.envs.reorient import ReorientEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("hand11DieReorientP1-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.reorient import ReorientEnv as J
    return J(die_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, ReorientEnv):
  HOOKS = ("draw_goal",)

  def draw_goal(self, batch, device, generator):
    return self.next_draw("draw_goal", device)


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _Port(OBJECT_NPZ["die", 2], dtype=torch.float64, **KWARGS)
  for name in ("goal_obj_offset", "goal_init_pos", "goal_site_local_pos",
               "goal_site_local_quat"):
    assert_close(getattr(penv, name), getattr(jenv, name), rtol=0,
                 atol=1e-14, what=name)
  (lo, hi), (rlo, rhi) = KWARGS["goal_pos"], KWARGS["goal_rot"]

  def draw(k):
    k1, k2 = jax.random.split(k)
    return (jax.random.uniform(k1, (3,), jnp.float64, lo, hi),
            jax.random.uniform(k2, (3,), jnp.float64, rlo, rhi))

  def queue(keys):
    k_aux, _ = reset_split(keys)
    penv.draws["draw_goal"].append(jax.vmap(draw)(k_aux))

  jst, pst, ends = task_rollout(jenv, penv, queue, B, STEPS)
  assert ends > 0


def test_hand_qpos_keeps_the_off_by_one():
  env = ReorientEnv(OBJECT_NPZ["die", 2], dtype=torch.float64,
                    **task_kwargs("hand11DieReorientP2-v0"))
  st = env.reset(2, "cpu", torch.Generator().manual_seed(0))
  obs = env.get_obs_dict(st.data, st.aux)
  nq = env.model.nq
  assert obs["hand_qpos_noMD5"].shape == (2, nq - 7)
  assert obs["hand_qpos"].shape == (2, nq - 6)
  assert env.obs_keys[0] == "hand_qpos_noMD5"
  # at the start the die sits at its goal up to the drawn offset
  assert_close(obs["pos_err"], st.aux["goal_body_pos"]
               - torch.as_tensor(env.goal_init_pos), rtol=0, atol=1e-12)
  assert not to_np(st.done).any()
