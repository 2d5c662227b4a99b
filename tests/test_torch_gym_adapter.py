"""The gymnasium surface (``envs/gym_adapter.py``): the cases of the JAX
package's ``tests/test_gym_adapter.py`` on the port's fixture ids, then
``GymEnv`` and ``GymVecEnv`` against the JAX package's adapter on the same
actions: hand11 under the myoHandPoseFixed-v0 task in float64 (frame_skip
2, horizon 3, so that the vec env autoresets), obs and reward within the
port's float64 env tolerance (``test_torch_env.py``)."""
from __future__ import annotations

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import HAND_TARGET, NPZ, bare_envs_package
from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.envs import gym_adapter
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv

with bare_envs_package():   # the JAX envs package registers asset ids
  from myosuite_mjx_tpu.envs import gym_adapter as jgym
  from myosuite_mjx_tpu.envs.pose import PoseEnv as JaxPoseEnv

gymnasium = pytest.importorskip("gymnasium")

KWARGS = dict(frame_skip=2, horizon=3, normalize_act=True, pose_thd=0.7,
              reset_type="init", target_type="fixed",
              target_jnt_value=HAND_TARGET[:11])
TOL = dict(rtol=1e-7, atol=1e-8)
STEPS = 5
B = 4


def test_gym_env_contract():
  env = envs.gym_make("hand11PoseFixed-v0", seed=0, device="cpu")
  assert isinstance(env, gymnasium.Env)
  obs, info = env.reset(seed=3)
  assert env.observation_space.contains(obs.astype(np.float32))
  assert env.action_space.shape == (env.unwrapped_myo.action_dim,)
  a = env.action_space.sample()
  obs2, r, term, trunc, info = env.step(a)
  assert obs2.shape == obs.shape and np.isfinite(r)
  assert isinstance(term, bool) and isinstance(trunc, bool)
  assert "solved" in info and "rwd_sparse" in info
  o1, _ = env.reset(seed=7)
  o2, _ = env.reset(seed=7)
  np.testing.assert_allclose(o1, o2)


def test_gym_env_truncates_at_horizon():
  env = envs.gym_make("hand11PoseFixed-v0", seed=0, horizon=3, device="cpu")
  assert env.horizon == 3
  env.reset(seed=0)
  a = np.zeros(env.action_space.shape, np.float32)
  flags = [env.step(a)[2:4] for _ in range(3)]
  assert flags[-1][1] or flags[-1][0]
  assert not any(flags[0]) and not any(flags[1])


def test_gym_vec_env():
  venv = envs.gym_make("hand11ReachRandom-v0", seed=0, num_envs=4,
                       device="cpu")
  obs, _ = venv.reset()
  assert obs.shape == (4,) + venv.single_observation_space.shape
  assert venv.observation_space.shape == obs.shape
  acts = np.zeros((4,) + venv.single_action_space.shape, np.float32)
  obs2, rew, done, trunc, info = venv.step(acts)
  assert obs2.shape == obs.shape and rew.shape == (4,)
  assert done.dtype == trunc.dtype == bool
  # random task: per-env variation
  assert not np.allclose(obs[0], obs[1])


@pytest.mark.parametrize("num_envs", [1, 4])
def test_pickled_adapter_steps_on_like_the_original(num_envs):
  env = envs.gym_make("hand11ReachRandom-v0", seed=1, num_envs=num_envs,
                      device="cpu")
  env.reset()
  twin = pickle.loads(pickle.dumps(env))
  a = np.full(env.action_space.shape, 0.3, np.float32)
  for _ in range(2):
    np.testing.assert_array_equal(twin.step(a)[0], env.step(a)[0])
  np.testing.assert_array_equal(twin.reset()[0], env.reset()[0])


def test_without_gymnasium_the_adapter_steps_but_has_no_spaces(monkeypatch):
  monkeypatch.setattr(gym_adapter, "gym_spaces", None)
  env = gym_adapter.GymEnv(PoseEnv(NPZ[2], **KWARGS), device="cpu")
  assert not hasattr(env, "action_space")
  obs, _ = env.reset()
  assert np.isfinite(env.step(np.zeros(21, np.float32))[0]).all()


def _envs():
  jenv = JaxPoseEnv(hand_fixture_xml(2), dtype=jnp.float64, **KWARGS)
  penv = PoseEnv(NPZ[2], dtype=torch.float64, **KWARGS)
  return jenv, penv


def test_gym_env_matches_jax():
  jenv, penv = _envs()
  jg = jgym.GymEnv(jenv, seed=0)
  pg = gym_adapter.GymEnv(penv, seed=0, device="cpu")
  assert pg.observation_space == jg.observation_space
  assert pg.action_space == jg.action_space
  actions = np.random.default_rng(0).uniform(-0.2, 1.2, (STEPS, 21))
  jo, _ = jg.reset()
  po, _ = pg.reset()
  np.testing.assert_allclose(po, jo, **TOL)
  truncated = []
  for t in range(STEPS):
    if t == 3:                       # past the horizon: a fresh episode
      jo, _ = jg.reset()
      po, _ = pg.reset()
      np.testing.assert_allclose(po, jo, **TOL)
    jout, pout = jg.step(actions[t]), pg.step(actions[t])
    np.testing.assert_allclose(pout[0], jout[0], err_msg=f"obs {t}", **TOL)
    np.testing.assert_allclose(pout[1], jout[1], err_msg=f"reward {t}",
                               **TOL)
    assert pout[2:4] == jout[2:4], t
    for k in jout[4]:
      np.testing.assert_allclose(pout[4][k], jout[4][k], err_msg=k, **TOL)
    truncated.append(pout[3])
  assert truncated == [False, False, True, False, False]   # horizon 3


def test_gym_vec_env_matches_jax():
  jenv, penv = _envs()
  jv = jgym.GymVecEnv(jenv, B, seed=0)
  pv = gym_adapter.GymVecEnv(penv, B, seed=0, device="cpu")
  assert pv.observation_space == jv.observation_space
  actions = np.random.default_rng(1).uniform(-0.2, 1.2, (STEPS, B, 21))
  np.testing.assert_allclose(pv.reset()[0], jv.reset()[0], **TOL)
  ends = 0
  for t in range(STEPS):
    jout, pout = jv.step(actions[t]), pv.step(actions[t])
    for i, what in ((0, "obs"), (1, "reward")):
      np.testing.assert_allclose(pout[i], jout[i], err_msg=f"{what} {t}",
                                 **TOL)
    np.testing.assert_array_equal(pout[2], jout[2])
    np.testing.assert_array_equal(pout[3], jout[3])
    ends += int(pout[3].sum())
  assert ends == B                   # every env autoreset once
