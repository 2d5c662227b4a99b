"""ObjHoldRandomEnv: the port against the JAX package, float64, on the
hand11 hold scene (``hand11ObjHoldRandom-v0``'s task).

The JAX class is built on the same MJCF (``hold_fixture_xml(2)``) and runs
under ``jax.vmap``. Its draws are rebuilt from its key schedule (reset
splits its key in 4: the goal offset from the second, the ellipsoid's
radii from the third; ``autoreset_step`` resets from the second half of a
split of the state's key) and handed to the port through
``draw_goal_offset`` and ``draw_object_size``. frame_skip 2 keeps the JAX
compile short; horizon 3 makes autoreset fire inside the rollout. B = 4.

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
from myosuite_mjx_tpu_torch.assets.fixtures import hold_fixture_xml
from myosuite_mjx_tpu_torch.envs.obj_hold import ObjHoldEnv, ObjHoldRandomEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("hand11ObjHoldRandom-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.obj_hold import ObjHoldRandomEnv as J
    return J(hold_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, ObjHoldRandomEnv):
  HOOKS = ("draw_goal_offset", "draw_object_size")

  def draw_goal_offset(self, batch, device, generator):
    return self.next_draw("draw_goal_offset", device)

  def draw_object_size(self, batch, device, generator):
    return self.next_draw("draw_object_size", device)


def _queue(penv):
  def queue(keys):
    k_aux, k_state = reset_split(keys)
    u = lambda lo, hi: jax.vmap(lambda k: jax.random.uniform(
        k, (3,), jnp.float64, lo, hi))
    penv.draws["draw_goal_offset"].append(u(-0.030, 0.030)(k_aux))
    penv.draws["draw_object_size"].append(u(0.020, 0.030)(k_state))
  return queue


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _Port(OBJECT_NPZ["hold", 2], dtype=torch.float64, **KWARGS)
  assert penv.RESET_CONSTRAINT is True
  assert_close(penv.object_init_pos, jenv.object_init_pos, rtol=0,
               atol=1e-14)
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv), B, STEPS)
  assert ends > 0
  # the radii overlay: the ellipsoid is the last geom, drawn per env
  assert_close(pst.data.overlay["geom_size"], jst.data.overlay["geom_size"],
               rtol=0, atol=0)
  sizes = to_np(pst.data.overlay["geom_size"])
  assert (sizes[:, -1] != sizes[:1, -1]).any()
  assert (sizes[:, :-1] == penv.model.geom_size[:-1]).all()


def test_fixed_goal_is_the_goal_site():
  env = ObjHoldEnv(OBJECT_NPZ["hold", 2], dtype=torch.float64, **KWARGS)
  st = env.reset(2, "cpu", torch.Generator().manual_seed(0))
  goal = st.data.site_xpos[:, env.goal_sid]
  obs = env.get_obs_dict(st.data, st.aux)
  assert_close(obs["obj_err"], goal - obs["obj_pos"], rtol=0, atol=0)
  assert st.aux["goal_pos"].shape == (2, 0)
  assert not st.data.overlay
  # the object starts above the palm, the hand palm up
  assert float(st.data.qpos[0, 0]) == -1.5
  np.testing.assert_allclose(to_np(obs["obj_pos"][0]), env.object_init_pos)
