"""The leg tasks (LegReachEnv, WalkEnv in both ``com_vel_type`` modes):
the port against the JAX package, float64, on legs16
(``assets/fixtures.py``, 16 muscles). ``tests/test_torch_terrain_walk.py``
runs TerrainWalkEnv through the same helpers.

Each JAX class is built on the same MJCF (``legs_fixture_xml(8)``) with a
registered id's kwargs and runs under ``jax.vmap``. Its draws are rebuilt
from its key schedule (reset splits its key in 4: the task's aux from the
second part, the state from the third; ``autoreset_step`` resets from the
second half of a split of the state's key) and handed to the port through
the draw hooks:

- ``LegReachEnv``: the joint noise U(-0.2, 0.2) from the state key, the
  target offset from the aux key;
- ``WalkEnv`` with the random reset: the key pick U(0, 1) and the normal
  noise from a split of the state key;
- ``TerrainWalkEnv``: the same, and from the state key itself the rough
  terrain's U(-0.5, 0.5) per cell (the reference draws reset and terrain
  from one key; the port from its generator, one after the other).

frame_skip 2 and short horizons make autoreset fire inside the rollout.
B = 4. Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8) for obs, reward,
every reward key, info and aux, as the other task rollouts. Each case
takes about 100 s here, most of it the JAX env's compile (reset ~20 s,
autoreset_step ~60 s on legs16).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (LEGS_NPZ, QueuedDraws, bare_envs_package,
                          fixture_xml, reset_split, task_kwargs,
                          task_rollout, to_np)
from myosuite_mjx_tpu_torch.envs.walk import (LegReachEnv, TerrainWalkEnv,
                                              WalkEnv)

B = 4
STEPS = 4
F64 = jnp.float64

CASES = {
    "stand": ("legs16StandRandom-v0", LegReachEnv, {}),
    "walk": ("legs16Walk-v0", WalkEnv, {}),
    "walk_reference": ("legs16Walk-v0", WalkEnv,
                       dict(com_vel_type="reference")),
    "rough": ("legs16RoughTerrainWalk-v0", TerrainWalkEnv, {}),
    "hilly": ("legs16HillyTerrainWalk-v0", TerrainWalkEnv, {}),
    "stairs": ("legs16StairTerrainWalk-v0", TerrainWalkEnv, {}),
}
# the cases of this file; the terrain walks run in test_torch_terrain_walk
WALK_CASES = ("stand", "walk", "walk_reference")
TERRAIN_CASES = ("rough", "hilly", "stairs")


def _kwargs(case: str) -> dict:
  env_id, _, extra = CASES[case]
  return task_kwargs(env_id, frame_skip=2, horizon=3, **extra)


@functools.lru_cache(maxsize=None)
def _jax_env(case: str):
  name = CASES[case][1].__name__
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import walk as jwalk
    return getattr(jwalk, name)(fixture_xml("legs16"), dtype=F64,
                                **_kwargs(case))


def _port_class(cls):
  class Port(QueuedDraws, cls):
    HOOKS = ("draw_joint_noise", "draw_target_offset", "draw_reset_pose",
             "draw_terrain")

    def draw_joint_noise(self, batch, device, generator):
      return self.next_draw("draw_joint_noise", device)

    def draw_target_offset(self, batch, device, generator):
      return self.next_draw("draw_target_offset", device)

    def draw_reset_pose(self, batch, device, generator):
      return self.next_draw("draw_reset_pose", device)

    def draw_terrain(self, batch, device, generator):
      return self.next_draw("draw_terrain", device)
  return Port


def _queue(penv, jenv):
  def queue(keys):
    k_aux, k_state = reset_split(keys)
    if isinstance(penv, LegReachEnv):
      lo, hi = jenv.joint_random_range
      penv.draws["draw_joint_noise"].append(jax.vmap(
          lambda k: jax.random.uniform(k, (jenv.model.njnt,), F64, lo, hi))(
              k_state))
      tlo, thi = jnp.asarray(jenv.target_lo), jnp.asarray(jenv.target_hi)
      penv.draws["draw_target_offset"].append(jax.vmap(
          lambda k: jax.random.uniform(k, tlo.shape, F64, tlo, thi))(k_aux))
      return
    def pose(k):
      k1, k2 = jax.random.split(k)
      return (jax.random.uniform(k1, (), F64),
              jax.random.normal(k2, (jenv.model.nq,), F64))
    penv.draws["draw_reset_pose"].append(jax.vmap(pose)(k_state))
    if isinstance(penv, TerrainWalkEnv):
      n = len(jenv.model.hfield_data)
      if penv.terrain == "rough":
        terrain = jax.vmap(lambda k: jax.random.uniform(
            k, (n,), F64, -0.5, 0.5))(k_state)
      else:   # the registered hilly and stair walks are "fixed"
        terrain = np.zeros((len(keys), 0))
      penv.draws["draw_terrain"].append(terrain)
  return queue


def check_rollout(case: str):
  """The autoreset rollout of ``case`` against JAX's (see the module
  note)."""
  jenv = _jax_env(case)
  penv = _port_class(CASES[case][1])(LEGS_NPZ["legs16"], dtype=torch.float64,
                                     **_kwargs(case))
  assert penv.RESET_CONSTRAINT is True
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv, jenv), B, STEPS)
  assert ends > 0
  d = pst.data
  assert (to_np(d.contact.dist) < 0).any(), "no foot on the ground"
  if case in TERRAIN_CASES:
    h = to_np(d.overlay["hfield_data"])
    assert h.shape == (B, len(penv.model.hfield_data)) and np.ptp(h) > 0
    np.testing.assert_allclose(h, np.asarray(jst.data.overlay["hfield_data"]),
                               rtol=1e-12, atol=1e-14)
  return penv, pst


@pytest.mark.parametrize("case", WALK_CASES)
def test_autoreset_rollout_matches_jax(case):
  penv, pst = check_rollout(case)
  if case != "stand":
    # the flat walk moved its terrain under the floor, on the host model
    tid = penv.model.name2id("geom", "terrain")
    assert penv.model.geom_pos[tid][2] == -10
    assert float(penv.device_model("cpu").geom_pos[tid, 2]) == -10


@pytest.mark.parametrize("env_id", ("legs16Walk-v0", "legs80Walk-v0"))
def test_standing_key_settles(env_id):
  """From the standing key (any reset_type but random/init) and with the
  muscles off (action -1: ctrl sigmoid(-7.5)), no env ends in its first
  control steps: the scene stands, so autoreset does not hide it."""
  from myosuite_mjx_tpu_torch import envs
  env = envs.make(env_id, cache=False, dtype=torch.float64,
                  reset_type="stand")
  g = torch.Generator().manual_seed(0)
  st = env.reset(2, "cpu", g)
  for _ in range(5):
    st = env.step(st, torch.full((2, env.action_dim), -1.0,
                                 dtype=torch.float64), g)
    assert not bool(st.done.any())
  com = env._com(st.data)
  assert (to_np(com[:, 2]) > 0.9).all()
