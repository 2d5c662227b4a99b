"""PenTwirlRandomEnv: the port against the JAX package, float64, on the
hand11 pen scene (``hand11PenTwirlRandom-v0``'s task), at B = 4: the
reference's rot_align divides by per-env norms under ``vmap``, and a
whole-batch norm in the batched port would agree at B = 1 only.

The JAX class is built on the same MJCF (``pen_fixture_xml(2)``) and runs
under ``jax.vmap``. Its target draws are rebuilt from its key schedule
(reset splits its key in 4 and draws the target's roll and pitch from the
second; ``autoreset_step`` resets from the second half of a split of the
state's key) and handed to the port through ``draw_target_euler``.
frame_skip 2 keeps the JAX compile short; horizon 3 makes autoreset fire
inside the rollout.

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
from myosuite_mjx_tpu_torch.assets.fixtures import pen_fixture_xml
from myosuite_mjx_tpu_torch.envs.pen import PenTwirlFixedEnv, PenTwirlRandomEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("hand11PenTwirlRandom-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.pen import PenTwirlRandomEnv as J
    return J(pen_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, PenTwirlRandomEnv):
  HOOKS = ("draw_target_euler",)

  def draw_target_euler(self, batch, device, generator):
    return self.next_draw("draw_target_euler", device)


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _Port(OBJECT_NPZ["pen", 2], dtype=torch.float64, **KWARGS)

  def queue(keys):
    k_aux, _ = reset_split(keys)
    penv.draws["draw_target_euler"].append(jax.vmap(
        lambda k: jax.random.uniform(k, (2,), jnp.float64, -1.0, 1.0))(k_aux))

  jst, pst, ends = task_rollout(jenv, penv, queue, B, STEPS)
  assert ends > 0
  # every env has its own target
  des = to_np(pst.aux["des_rot"])
  assert (np.abs(des - des[:1]).max(-1)[1:] > 1e-3).all()


def test_rot_align_is_per_env():
  env = PenTwirlFixedEnv(OBJECT_NPZ["pen", 2], dtype=torch.float64,
                         **task_kwargs("hand11PenTwirlFixed-v0"))
  rng = np.random.default_rng(0)
  a = rng.normal(size=(5, 3)) * rng.uniform(0.5, 2.0, (5, 1))
  b = rng.normal(size=(5, 3))
  obs = {"obj_err_pos": torch.zeros(5, 3, dtype=torch.float64),
         "obj_rot": torch.as_tensor(a), "obj_des_rot": torch.as_tensor(b),
         "act": torch.zeros(5, env.model.na, dtype=torch.float64)}
  rwd = env.get_reward_dict(obs, None, {})
  want = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                            * np.linalg.norm(b, axis=-1))
  assert_close(rwd["rot_align"], want, rtol=1e-14, atol=0)
  # the desired position is where the pen starts: nothing is dropped
  st = env.reset(2, "cpu", torch.Generator().manual_seed(0))
  assert not to_np(st.done).any()
  assert env.model.nv == 17 and float(st.data.qpos[0, 0]) == -1.5
