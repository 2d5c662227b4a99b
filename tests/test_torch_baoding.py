"""BaodingEnv: the port against the JAX package, float64, on the hand11
baoding scene (``hand11BaodingP2-v1``'s task: a drawn direction and start
angle, drawn radii and period, and the balls' size, mass and friction
overlays).

The JAX class is built on the same MJCF (``baoding_fixture_xml(2)``) and
runs under ``jax.vmap``. Its draws are rebuilt from its key schedule
(reset splits its key in 4: the goal from the second, split in 5; the
overlay from the third, split in 3; ``autoreset_step`` resets from the
second half of a split of the state's key) and handed to the port through
``draw_goal`` and ``draw_ball_overlay``. frame_skip 2 keeps the JAX compile
short; horizon 3 makes autoreset fire inside the rollout. B = 4.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward, every
reward key, info and aux, as the other tasks' rollouts; the overlays are
the same numbers (exact).
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
from myosuite_mjx_tpu_torch.assets.fixtures import baoding_fixture_xml
from myosuite_mjx_tpu_torch.envs.baoding import BaodingEnv

B = 4
STEPS = 5
KWARGS = task_kwargs("hand11BaodingP2-v1", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.baoding import BaodingEnv as J
    return J(baoding_fixture_xml(2), dtype=jnp.float64, **KWARGS)


class _Port(QueuedDraws, BaodingEnv):
  HOOKS = ("draw_goal", "draw_ball_overlay")

  def draw_goal(self, batch, device, generator):
    return self.next_draw("draw_goal", device)

  def draw_ball_overlay(self, batch, device, generator):
    return dict(zip(("size", "mass", "friction"),
                    self.next_draw("draw_ball_overlay", device)))


def _queue(penv):
  f64 = jnp.float64

  def goal(k):
    k1, k2, k3, k4, k5 = jax.random.split(k, 5)
    return (jax.random.randint(k1, (), 0, 3),
            jax.random.uniform(k2, (), f64, 0, 2 * jnp.pi),
            jax.random.uniform(k3, (), f64, *KWARGS["goal_xrange"]),
            jax.random.uniform(k4, (), f64, *KWARGS["goal_yrange"]),
            jax.random.uniform(k5, (), f64, *KWARGS["goal_time_period"]))

  def overlay(k):
    k1, k2, k3 = jax.random.split(k, 3)
    delta = jnp.asarray(KWARGS["obj_friction_change"], f64)
    return (jax.random.uniform(k1, (2,), f64, *KWARGS["obj_size_range"]),
            jax.random.uniform(k2, (2,), f64, *KWARGS["obj_mass_range"]),
            jax.random.uniform(k3, (2, 3), f64, -delta, delta))

  def queue(keys):
    k_aux, k_state = reset_split(keys)
    penv.draws["draw_goal"].append(jax.vmap(goal)(k_aux))
    penv.draws["draw_ball_overlay"].append(jax.vmap(overlay)(k_state))
  return queue


def test_autoreset_rollout_matches_jax():
  jenv = _jax_env()
  penv = _Port(FIXTURE_NPZ["baoding2"], dtype=torch.float64, **KWARGS)
  assert (penv.palm_bid, penv.target_z) == (jenv.palm_bid, jenv.target_z)
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv), B, STEPS)
  assert ends > 0
  # the balls' overlays: the same numbers as the reference's, on the two
  # balls only
  for k in ("geom_size", "body_mass", "geom_friction"):
    assert_close(pst.data.overlay[k], jst.data.overlay[k], rtol=0, atol=0,
                 what=k)
  m = penv.model
  sizes = to_np(pst.data.overlay["geom_size"])
  others = np.setdiff1d(np.arange(m.ngeom), penv.ball_gids)
  assert (sizes[:, others] == m.geom_size[others]).all()
  assert (sizes[:, penv.ball_gids, 0] != m.geom_size[penv.ball_gids, 0]).all()
  # a drawn direction per env
  assert set(to_np(pst.aux["sign"]).tolist()) <= {-1.0, 0.0, 1.0}


def test_fixed_task_and_the_scene():
  env = BaodingEnv(FIXTURE_NPZ["baoding2"], dtype=torch.float64,
                   **task_kwargs("hand11BaodingP1-v1"))
  st = env.reset(3, "cpu", torch.Generator().manual_seed(0))
  assert not st.data.overlay
  assert_close(st.aux["sign"], np.ones(3), rtol=0, atol=0)
  assert_close(st.aux["angle1"], np.full(3, np.pi / 4), rtol=0, atol=0)
  assert_close(st.aux["x_radius"], np.full(3, 0.025), rtol=0, atol=0)
  obs = env.get_obs_dict(st.data, st.aux)
  # both balls start above the drop threshold, in the palm, the targets
  # on the ellipse around the tray's centre
  assert (to_np(obs["object1_pos"])[:, 2] > env.drop_th).all()
  assert (to_np(obs["object2_pos"])[:, 2] > env.drop_th).all()
  centre = 0.5 * (obs["target1_pos"] + obs["target2_pos"])
  tray = 0.5 * (obs["object1_pos"] + obs["object2_pos"])
  assert float((centre - tray)[:, :2].abs().max()) < 0.01
  assert env.model.nv == 23 and obs["hand_pos"].shape == (3, 11)
  assert not to_np(st.done).any()
