"""KeyTurnEnv: the port against the JAX package, float64, on the hand11
key scene (``hand11KeyTurnRandom-v0``'s task).

The JAX class is built on the same MJCF (``key_fixture_xml(2)``) and runs
under ``jax.vmap``. Its key-angle draws are rebuilt from its key schedule
(reset splits its key in 4 and draws the angle from the third;
``autoreset_step`` resets from the second half of a split of the state's
key) and handed to the port through ``draw_key_angle``. frame_skip 2 keeps
the JAX compile short; horizon 3 makes autoreset fire inside the rollout.
B = 4.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info and aux, as the reach task's rollout.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import (OBJECT_NPZ, QueuedDraws, bare_envs_package,
                          reset_split, task_kwargs, task_rollout, to_np)
from myosuite_mjx_tpu_torch.assets.fixtures import key_fixture_xml
from myosuite_mjx_tpu_torch.envs.key_turn import KeyTurnEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("hand11KeyTurnRandom-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.key_turn import KeyTurnEnv as J
    return J(key_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, KeyTurnEnv):
  HOOKS = ("draw_key_angle",)

  def draw_key_angle(self, batch, device, generator):
    return self.next_draw("draw_key_angle", device)


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _Port(OBJECT_NPZ["key", 2], dtype=torch.float64, **KWARGS)
  lo, hi = KWARGS["key_init_range"]

  def queue(keys):
    _, k_state = reset_split(keys)
    penv.draws["draw_key_angle"].append(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float64, lo, hi))(k_state))

  jst, pst, ends = task_rollout(jenv, penv, queue, B, STEPS)
  assert ends > 0
  assert penv.goal_th == 2 * np.pi


def test_the_key_is_the_last_dof_of_an_open_hand():
  env = KeyTurnEnv(OBJECT_NPZ["key", 2], dtype=torch.float64,
                   **task_kwargs("hand11KeyTurnFixed-v0"))
  st = env.reset(2, "cpu", torch.Generator().manual_seed(0))
  assert env.model.nv == 12
  assert (to_np(st.data.qpos) == 0).all()
  obs = env.get_obs_dict(st.data, st.aux)
  # both tips start about 5 cm from the key's head: inside the penalty's
  # 5 cm band around 3 cm, and no episode ends at the start
  for k in ("IFtip_approach", "THtip_approach"):
    dist = np.linalg.norm(to_np(obs[k]), axis=-1)
    assert (abs(dist - 0.03) < 0.05).all(), (k, dist)
  assert not to_np(st.done).any()
